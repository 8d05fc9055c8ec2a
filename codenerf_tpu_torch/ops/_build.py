"""Build and load the port's CUDA kernels and its host-side native code.

Each kernel is one ``.cu`` file under ``ops/csrc/`` with a plain C entry
point.  It is compiled by one ``nvcc`` command into a shared library under
``build/torch_kernels/`` at the root of the checkout and loaded with
``ctypes``; no PyTorch header is compiled.  Host code (the native SRN
loader, ``data/csrc/srn_loader.cc``) takes the host-compiler route,
``build_host``: one ``g++ -O3 -std=c++17 -shared -fPIC`` into
``build/torch_native/``.  A library is named by a hash of its source (for
a kernel also the shared headers, ``csrc/*.cuh``) and the flags, written
under a temporary name and renamed into place, so stale outputs are
harmless, and an edited header builds a new library.  A file lock beside
it lets one process build a library while the others that need it (the
ranks of a world) wait for it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NATIVE_DIR = BUILD_DIR.parent / "torch_native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def nvcc_path() -> str:
    """The ``nvcc`` on PATH, else the one under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def host_compiler() -> str:
    """The C++ compiler on PATH (``g++``, else ``c++``)."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native "
                       "code cannot be built")


def library_path(name: str) -> Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def _compile(out: Path, command) -> dict:
    """Run ``command(tmp)`` to write the library ``out`` unless it exists,
    under ``out``'s file lock.  Returns the library path, the seconds spent
    and the compiler's output."""
    if out.exists():
        return {"path": out, "seconds": 0.0, "log": "(cached)"}
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(f"{out.name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return {"path": out, "seconds": 0.0,
                    "log": "(built by another process)"}
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = command(str(tmp))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return {"path": out, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists.  Returns the
    library path, the seconds spent and nvcc's output (register and spill
    counts from ``-Xptxas -v``)."""
    source = CSRC / f"{name}.cu"
    return _compile(library_path(name), lambda tmp: [
        nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)])


def build_host(source: Path, libs: tuple = ()) -> dict:
    """Compile the C++ file ``source`` into a shared library linked with
    ``libs`` (e.g. ``("-lz",)``) under ``build/torch_native/``, unless it
    exists; returns as ``build`` does."""
    flags = (*HOST_FLAGS, *libs)
    key = hashlib.sha256(source.read_bytes())
    key.update(" ".join(flags).encode())
    out = NATIVE_DIR / f"lib{source.stem}-{key.hexdigest()[:16]}.so"
    return _compile(out, lambda tmp: [
        host_compiler(), *HOST_FLAGS, "-o", tmp, str(source), *libs])


def load(name: str) -> ctypes.CDLL:
    """The library for kernel ``name``, built first if needed."""
    return ctypes.CDLL(str(build(name)["path"]))
