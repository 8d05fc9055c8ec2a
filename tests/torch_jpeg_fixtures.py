"""Seeded JPEG images for the port's JPEG decoder (``codenerf_tpu_torch/
data/jpeg.py``): the writer of the committed fixtures under
``codenerf_tpu_torch/fixtures/jpeg/`` and the images the tests encode.

The fixtures were written by Pillow 12.1.0 over libjpeg-turbo 3.1.3, and
their pixels are ``imageio.v2.imread``'s (imageio 2.37.4) on that
install.  Another Pillow or libjpeg-turbo may write other bytes; the
committed files and pixels are the reference, and
``tests/test_torch_jpeg.py`` holds them against imageio.  Rewrite them
with

    python3 -m tests.torch_jpeg_fixtures [--out DIR]

Pillow lives here, in the tests, because the port must not need it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import numpy as np

FIXTURES = (Path(__file__).resolve().parents[1] / "codenerf_tpu_torch"
            / "fixtures" / "jpeg")
FULL_NAME = "fern_4032x3024_q80_420.jpg"
FULL_HW = (3024, 4032)

# name: (height, width, grey, Pillow save arguments)
CASES = {
    "q75_420_37x53": (37, 53, False, {"quality": 75, "subsampling": 2}),
    "q95_422_67x129": (67, 129, False, {"quality": 95, "subsampling": 1}),
    "q30_444_5x7": (5, 7, False, {"quality": 30, "subsampling": 0}),
    "q100_420_1x1": (1, 1, False, {"quality": 100, "subsampling": 2}),
    "grey_q90_53x37": (53, 37, True, {"quality": 90}),
    "optimize_q75_420_61x45": (61, 45, False, {"quality": 75,
                                               "subsampling": 2,
                                               "optimize": True}),
    "restart_blocks_q90_420_40x72": (40, 72, False, {
        "quality": 90, "subsampling": 2, "restart_marker_blocks": 3}),
    "restart_rows_q85_422_33x50": (33, 50, False, {
        "quality": 85, "subsampling": 1, "restart_marker_rows": 1}),
    "exif_orientation6_20x30": (20, 30, False, {"quality": 90,
                                                "subsampling": 2}),
}


def seeded_image(height: int, width: int, seed: int,
                 grey: bool = False) -> np.ndarray:
    """uint8 [H, W, 3] (or [H, W]): smooth seeded colour waves with
    per-pixel noise, so that every DCT coefficient and both chroma planes
    carry detail."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    chans = []
    for _ in range(1 if grey else 3):
        fx, fy, phase = rng.uniform(0.05, 0.6, 3)
        chans.append(128 + 70 * np.sin(fx * x + phase) * np.cos(fy * y)
                     + 30 * np.sin(0.1 * (x + y) + phase))
    img = np.stack(chans, -1) + rng.normal(0, 20, (height, width, len(chans)))
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def full_size_image(seed: int = 16) -> np.ndarray:
    """uint8 [3024, 4032, 3], fern's full size: smooth seeded colour
    waves with a light luma texture."""
    rng = np.random.default_rng(seed)
    h, w = FULL_HW
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    chans = []
    for c in range(3):
        a, b, phase = rng.uniform(2, 9, 3)
        chans.append(110 + 60 * np.sin(2 * np.pi * (a * x + phase))
                     * np.cos(2 * np.pi * b * y) + 40 * (x - y) * (c - 1))
    img = np.stack(chans, -1)
    img += rng.normal(0, 3, (h, w, 1)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def save_jpeg(path: Path, img: np.ndarray, **kwargs) -> None:
    """``img`` written by Pillow with ``kwargs``; ``exif_orientation`` sets
    the EXIF orientation tag (0x0112)."""
    from PIL import Image
    orientation = kwargs.pop("exif_orientation", None)
    if orientation is not None:
        exif = Image.Exif()
        exif[0x0112] = orientation
        kwargs["exif"] = exif
    Image.fromarray(img).save(path, format="JPEG", **kwargs)


def pixels_sha256(pixels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()


def write(out: Path = FIXTURES) -> dict:
    """Write the fixtures into ``out``: one JPEG per ``CASES`` entry and
    ``pixels.npz`` (imageio's arrays by name), the full-size JPEG and
    ``<its stem>.json`` (shape and sha256 of imageio's pixels)."""
    import imageio.v2 as imageio
    out.mkdir(parents=True, exist_ok=True)
    pixels = {}
    for i, (name, (h, w, grey, kwargs)) in enumerate(CASES.items()):
        path = out / f"{name}.jpg"
        kwargs = dict(kwargs)
        if name.startswith("exif_orientation6"):
            kwargs["exif_orientation"] = 6
        save_jpeg(path, seeded_image(h, w, 100 + i, grey), **kwargs)
        pixels[name] = np.asarray(imageio.imread(path))
    np.savez_compressed(out / "pixels.npz", **pixels)
    full = out / FULL_NAME
    save_jpeg(full, full_size_image(), quality=80, subsampling=2)
    decoded = np.asarray(imageio.imread(full))
    meta = {"file": FULL_NAME, "shape": list(decoded.shape),
            "sha256": pixels_sha256(decoded)}
    (out / f"{full.stem}.json").write_text(json.dumps(meta, indent=1) + "\n")
    return meta


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=FIXTURES)
    print(write(parser.parse_args().out))
