"""The native SRN view loader (counterpart of
``codenerf_tpu/data/native.py``): ctypes over ``data/csrc/srn_loader.cc``,
a threaded PNG decode (on zlib's inflate) with the mask, the crop and the
/255 normalisation written straight into float32 numpy buffers.

The library is built at first use by ``ops/_build.py::build_host`` (``g++
-O3 -std=c++17 -shared -fPIC ... -lz``) into ``build/torch_native/``.
When it cannot be built, ``SRNDataset.load_views`` takes the Python path
(``data/png.py::read_png``), as the JAX package's loader does, but not
silently: the build error is printed once, and ``status()`` says which
path each batch took.  A file that fails to decode inside ``load_batch``
raises.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "srn_loader.cc"
LIBS = ("-lz",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
# batches each path of SRNDataset.load_views served
_batches = {"native": 0, "python": 0}


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None (after printing why,
    once) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        from codenerf_tpu_torch.ops import _build
        try:
            lib = ctypes.CDLL(str(_build.build_host(SOURCE, LIBS)["path"]))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            print(f"native SRN loader unavailable, SRN views are decoded in "
                  f"Python (data/png.py): {_error}", file=sys.stderr,
                  flush=True)
            return None
        lib.srn_probe.restype = ctypes.c_int
        lib.srn_probe.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.srn_load_batch.restype = ctypes.c_int
        lib.srn_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), *[ctypes.c_int] * 9,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def probe(path: str | Path):
    """(height, width, channels) of a PNG from its header, or None."""
    lib = _load()
    if lib is None:
        return None
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.srn_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w),
                     ctypes.byref(c)) != 0:
        return None
    return h.value, w.value, c.value


def crop_window(height: int, width: int) -> tuple:
    """(row0, rows, col0, cols) of ``SRNDataset.__getitem__``'s crop
    ``rgb[cw:width - cw, ch:height - ch]`` of a height x width image."""
    ch, cw = height // 8, width // 8
    r0, r1, _ = slice(cw, width - cw).indices(height)
    c0, c1, _ = slice(ch, height - ch).indices(width)
    return r0, max(0, r1 - r0), c0, max(0, c1 - c0)


def load_batch(paths: Sequence[str | Path], height: int, width: int,
               channels: int, num_threads: int = 8):
    """Decode, mask, crop and normalise a batch of SRN views natively.

    Every file must be a height x width PNG with ``channels`` channels.
    Returns (colors [n, rows, cols, channels] f32, masks [n, rows, cols, 1]
    f32), the crop of ``crop_window``; raises RuntimeError if the library
    is not available or any view fails to decode.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native SRN loader not available: {_error}")
    n = len(paths)
    row0, rows, col0, cols = crop_window(height, width)
    colors = np.empty((n, rows, cols, channels), dtype=np.float32)
    masks = np.empty((n, rows, cols, 1), dtype=np.float32)
    encoded = [str(p).encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*encoded)
    failures = lib.srn_load_batch(
        arr, n, height, width, channels, row0, rows, col0, cols,
        num_threads, colors.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        masks.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if failures:
        raise RuntimeError(f"native SRN loader: {failures}/{n} views failed "
                           f"to decode as {height}x{width}x{channels} PNGs")
    return colors, masks


def record(path: str) -> None:
    """Count one batch served by ``path`` ("native" or "python")."""
    with _lock:
        _batches[path] += 1


def status() -> dict:
    """Which path the loader takes and took: "path" is "native" once the
    library is loaded, "python" once it failed to build (None before the
    first use), "error" the build error if any, "batches" the batches each
    path served."""
    with _lock:
        path = ("native" if _lib is not None
                else "python" if _error is not None else None)
        return {"path": path,
                "library": None if _lib is None else _lib._name,
                "error": _error, "batches": dict(_batches)}
