"""A PNG decoder on the standard library's ``zlib`` and numpy.

It stands in for imageio, which the JAX package's loader uses
(``codenerf_tpu/data/srn.py``) and the card's machine lacks.  It reads
the PNGs datasets are made of: non-interlaced, 8 bits per sample,
greyscale, RGB or RGBA, with any of the five row filters.  Every other
format, a bad chunk CRC and a short or corrupt stream raise
``ValueError``.
"""

from __future__ import annotations

import functools
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: no IEND chunk")


@functools.cache
def _predictor_offsets() -> np.ndarray:
    """int32 [5 * 511 * 511]: each row filter's prediction less ``c``, at
    ``kind * 511**2 + (a - c + 255) * 511 + (b - c + 255)``.

    Every filter but None predicts ``c`` plus a function of ``a - c`` and
    ``b - c``: Sub ``a``, Up ``b``, Average ``(a + b) >> 1`` and Paeth the
    one of ``a``, ``b``, ``c`` nearest ``a + b - c``.  None's entries are 0
    and its rows take no ``c``.
    """
    d = np.arange(-255, 256)
    da, db = d[:, None], d[None, :]
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
    zero = np.zeros_like(paeth)
    return np.stack([zero, da + zero, db + zero, (da + db) >> 1,
                     paeth]).astype(np.int32).reshape(-1)


def _unfilter(raw: bytes, height: int, width: int, bpp: int, path):
    """The image bytes [height, width * bpp] from the filtered scanlines
    (PNG spec section 9).

    Pixel (y, x) needs its decoded left (a), upper (b) and upper-left (c)
    neighbours, so the rows decode together along anti-diagonals: step
    ``t = x + y + 2`` decodes every pixel with that ``x + y``, all channels
    at once, with each row's filter.  The arrays are skewed, pixel (y, x)
    at ``[t, y + 1]``; steps 0-1 and slot 0 stay zero and are the pixels
    left of and above the image.
    """
    stride = width * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {rows.size} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    kinds = rows[:, 0].astype(np.int32)
    bad = np.flatnonzero(kinds > 4)
    if bad.size:
        raise ValueError(f"{path}: unknown row filter {kinds[bad[0]]} in "
                         f"row {bad[0]}")
    offsets, n = _predictor_offsets(), 511
    ys, xs = np.mgrid[0:height, 0:width]
    at = (xs + ys + 2, ys + 1)
    filtered = np.zeros((height + width + 1, height + 1, bpp), np.int32)
    filtered[at] = rows[:, 1:].reshape(height, width, bpp)
    out = np.zeros_like(filtered)
    base = np.zeros((height + 1, bpp), np.int32)
    base[1:] = (kinds * n * n + 255 * n + 255)[:, None]
    takes_c = np.zeros((height + 1, bpp), np.int32)
    takes_c[1:] = (kinds != 0)[:, None]
    for t in range(2, height + width + 1):
        lo, hi = max(1, t - width), min(height, t - 1) + 1
        a = out[t - 1, lo:hi]
        b = out[t - 1, lo - 1:hi - 1]
        c = out[t - 2, lo - 1:hi - 1]
        idx = a - c
        idx *= n
        idx += b
        idx -= c
        idx += base[lo:hi]
        cur = offsets.take(idx)
        cur += filtered[t, lo:hi]
        cur += c * takes_c[lo:hi]
        np.bitwise_and(cur, 0xFF, out=out[t, lo:hi])
    return out[at].astype(np.uint8).reshape(height, stride)


def read_png(path) -> np.ndarray:
    """uint8 [H, W, C] of the PNG at ``path``: C = 1 (greyscale), 3 (RGB)
    or 4 (RGBA)."""
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}: "
                         "only 8-bit greyscale, RGB and RGBA are read")
    if compression != 0 or filtering != 0 or interlace != 0:
        raise ValueError(f"{path}: compression {compression}, filter method "
                         f"{filtering}, interlace {interlace}: only the "
                         "standard non-interlaced PNG is read")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    channels = _CHANNELS[colour]
    img = _unfilter(raw, height, width, channels, path)
    return img.reshape(height, width, channels)
