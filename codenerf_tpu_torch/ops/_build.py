"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``ops/csrc/`` with a plain C entry
point.  It is compiled by one ``nvcc`` command into a shared library under
``build/torch_kernels/`` at the root of the checkout and loaded with
``ctypes``; no PyTorch header is compiled.  The library is named by a hash
of its source, the shared headers (``csrc/*.cuh``) and the flags, written
under a temporary name and renamed into place, so concurrent builds and
stale outputs are harmless, and an edited header builds a new library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library path, the seconds spent and nvcc's output (register and spill
    counts from ``-Xptxas -v``)."""
    out = library_path(name)
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": "(cached)"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def load(name: str) -> ctypes.CDLL:
    """The library for kernel ``name``, built first if needed."""
    return ctypes.CDLL(str(build(name)["path"]))
