"""A PNG decoder and encoder on the standard library's ``zlib`` and numpy.

They stand in for imageio, which the JAX package's loader and tools use
(``codenerf_tpu/data/srn.py``, ``tools/make_synth_data.py``) and the
card's machine lacks.  ``read_png`` reads the PNGs datasets are made of:
non-interlaced, 8 bits per sample, greyscale, RGB or RGBA, with any of
the five row filters.  Every other format, a bad chunk CRC and a short
or corrupt stream raise ``ValueError``.  ``write_png`` writes that
format, each row filtered as adaptive encoders filter it.
"""

from __future__ import annotations

import functools
import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, and back
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR = {c: t for t, c in _CHANNELS.items()}


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


def encode_png(img: np.ndarray) -> tuple:
    """uint8 [H, W] or [H, W, 1] (greyscale), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA) as PNG bytes, and the filter of each row.  Rows are
    filtered as an adaptive encoder (libpng's, PIL's) filters them: each
    takes the one of the five filters whose bytes, read as signed, have
    the least sum of absolute values."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOUR:
        raise ValueError(f"write_png takes [H, W] or [H, W, 1 | 3 | 4] "
                         f"pixels, got {img.shape}")
    h, w, c = img.shape
    x = img.astype(np.int16).reshape(h, w * c)
    a = np.pad(x, ((0, 0), (c, 0)))[:, :-c]               # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]                  # up
    ul = np.pad(b, ((0, 0), (c, 0)))[:, :-c]              # up-left
    p = a + b - ul
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a,
                     np.where(pb <= pc, b, ul))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    filtered = ((x - pred) % 256).astype(np.uint8)        # [5, h, w * c]
    cost = np.abs(filtered.view(np.int8).astype(np.int32)).sum(-1)
    kinds = cost.argmin(0)
    rows = np.concatenate([kinds[:, None].astype(np.uint8),
                           filtered[kinds, np.arange(h)]], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOUR[c],
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b"")), kinds


def write_png(path, img: np.ndarray) -> np.ndarray:
    """Write ``img`` (``encode_png``'s pixels) to ``path`` as a PNG;
    returns the filter of each row."""
    data, kinds = encode_png(img)
    Path(path).write_bytes(data)
    return kinds
