"""Baseline JPEG decoding for the LLFF loader: ctypes over
``data/csrc/jpeg_decoder.cc``, which gives the pixels of the JAX
package's ``imageio.v2.imread`` (Pillow over libjpeg-turbo, at its
defaults) bit for bit, with no library beyond the C++ standard library.

The library is built at first use by ``ops/_build.py::build_host`` (``g++
-O3 -std=c++17 -shared -fPIC``) into ``build/torch_native/``.  There is no
Python path: when it cannot be built, reading a JPEG raises with the
compiler's output.  A file the decoder refuses (progressive, lossless,
hierarchical or arithmetic-coded, not 8-bit, 2 or 4 components, several
scans, truncated or corrupt) raises ``ValueError`` naming the file and
the feature.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "jpeg_decoder.cc"
_ERRLEN = 512

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _load() -> ctypes.CDLL:
    """The library, built on the first call; raises RuntimeError (with the
    compiler's output) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            from codenerf_tpu_torch.ops import _build
            try:
                lib = ctypes.CDLL(str(_build.build_host(SOURCE)["path"]))
            except (RuntimeError, OSError) as e:
                _error = str(e)
            else:
                int_p = ctypes.POINTER(ctypes.c_int)
                lib.jpeg_probe.restype = ctypes.c_int
                lib.jpeg_probe.argtypes = [ctypes.c_char_p, int_p, int_p,
                                           int_p, ctypes.c_char_p,
                                           ctypes.c_int]
                lib.jpeg_decode_batch.restype = ctypes.c_int
                lib.jpeg_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                    ctypes.POINTER(ctypes.c_void_p), int_p, ctypes.c_int,
                    ctypes.c_char_p, ctypes.c_int]
                _lib = lib
                return lib
        raise RuntimeError(f"the JPEG decoder ({SOURCE.name}) cannot be "
                           f"built, and JPEG files have no other reader: "
                           f"{_error}")


def probe(path: str | Path) -> tuple:
    """(height, width, channels) of a JPEG from its headers: channels 1
    for greyscale, 3 for colour (decoded to RGB)."""
    lib = _load()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.jpeg_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w),
                      ctypes.byref(c), err, _ERRLEN):
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return h.value, w.value, c.value


def read_jpegs(paths: Sequence[str | Path],
               num_threads: int = 8) -> List[np.ndarray]:
    """Decode ``paths``, each file whole on one of ``num_threads``
    threads, into uint8 arrays as ``imageio.v2.imread`` returns them:
    [H, W, 3], or [H, W] for greyscale.  Raises ValueError naming the
    first file that fails."""
    lib = _load()
    shapes = [probe(p) for p in paths]
    outs = [np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
            for h, w, c in shapes]
    n = len(paths)
    if not n:
        return outs
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    dims = (ctypes.c_int * (3 * n))(*[d for s in shapes for d in s])
    errs = ctypes.create_string_buffer(_ERRLEN * n)
    if lib.jpeg_decode_batch(names, n, ptrs, dims, num_threads, errs,
                             _ERRLEN):
        for i, p in enumerate(paths):
            msg = errs.raw[i * _ERRLEN:(i + 1) * _ERRLEN].split(b"\0")[0]
            if msg:
                raise ValueError(f"{p}: {msg.decode(errors='replace')}")
        raise ValueError(f"JPEG decode failed for one of {n} files")
    return outs


def read_jpeg(path: str | Path) -> np.ndarray:
    """One JPEG as ``imageio.v2.imread`` reads it: uint8 [H, W, 3], or
    [H, W] for greyscale."""
    return read_jpegs([path], num_threads=1)[0]
