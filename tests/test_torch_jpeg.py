"""The port's baseline-JPEG decoder (``codenerf_tpu_torch/data/jpeg.py``
over ``data/csrc/jpeg_decoder.cc``) on the CPU against the JAX package's
reader, ``imageio.v2.imread`` (imageio 2.37.4 over Pillow 12.1.0 and
libjpeg-turbo 3.1.3 here): JPEGs that Pillow writes from seeded images at
sizes that are not multiples of 8 or 16, subsampling 4:4:4, 4:2:2 and
4:2:0, greyscale, qualities 30 to 100, optimised Huffman tables and
restart intervals, and SOF1 files with 8- and 16-bit quantisation tables,
every one decoded bit-equal to imageio's pixels; ``read_jpegs`` on
threads; an EXIF orientation tag ignored, as imageio ignores it; the
refusals (progressive, arithmetic, 12-bit, CMYK, truncated); and the
committed fixtures under ``codenerf_tpu_torch/fixtures/jpeg/`` equal to
their committed pixels and to imageio's decode.
"""

import json

import imageio.v2 as imageio
import numpy as np
import pytest

from codenerf_tpu_torch.data.jpeg import probe, read_jpeg, read_jpegs
from tests.torch_jpeg_fixtures import (CASES, FIXTURES, pixels_sha256,
                                       save_jpeg, seeded_image)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

# (width, height), as Pillow gives sizes
SIZES = [(1, 1), (7, 5), (37, 53), (129, 67), (250, 190)]


def _write(tmp_path, name, w, h, grey=False, seed=0, **kwargs):
    path = tmp_path / f"{name}.jpg"
    save_jpeg(path, seeded_image(h, w, seed, grey), **kwargs)
    return path


def _same_as_imageio(path):
    want = np.asarray(imageio.imread(path))
    got = read_jpeg(path)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("quality", [30, 75, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES)
def test_colour_matches_imageio(tmp_path, size, subsampling, quality):
    path = _write(tmp_path, "c", *size, seed=quality + subsampling,
                  quality=quality, subsampling=subsampling)
    got = _same_as_imageio(path)
    assert got.shape == (size[1], size[0], 3)
    assert probe(path) == (size[1], size[0], 3)


@pytest.mark.parametrize("quality", [30, 90])
@pytest.mark.parametrize("size", SIZES)
def test_greyscale_matches_imageio(tmp_path, size, quality):
    path = _write(tmp_path, "g", *size, grey=True, seed=quality,
                  quality=quality)
    assert _same_as_imageio(path).shape == (size[1], size[0])
    assert probe(path) == (size[1], size[0], 1)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("size", SIZES[1:])
def test_optimised_huffman_tables_match_imageio(tmp_path, size, subsampling):
    path = _write(tmp_path, "o", *size, seed=7, quality=75,
                  subsampling=subsampling, optimize=True)
    _same_as_imageio(path)


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 1},
                                     {"restart_marker_rows": 2}])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_restart_intervals_match_imageio(tmp_path, subsampling, restart):
    path = _write(tmp_path, "r", 129, 67, seed=3, quality=90,
                  subsampling=subsampling, **restart)
    assert b"\xff\xdd" in path.read_bytes()      # a DRI segment
    _same_as_imageio(path)


def _segments(data: bytes) -> list:
    """(marker, offset of its 0xFF, segment length) of every marker
    segment before the scan's data."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, pos, length))
        if marker == 0xDA:
            return out
        pos += 2 + length


def _patched(data: bytes, marker: int, at: int, value: int) -> bytes:
    """``data`` with byte ``at`` of the first ``marker`` segment's body set
    to ``value`` (``at`` = -1: the marker code itself)."""
    _, pos, _ = next(s for s in _segments(data) if s[0] == marker)
    out = bytearray(data)
    out[pos + 1 if at < 0 else pos + 4 + at] = value
    return bytes(out)


def _with_16bit_quant(data: bytes) -> bytes:
    """``data`` with every DQT table rewritten with 16-bit entries (same
    values) and its SOF0 made SOF1, where 16-bit tables belong."""
    out, last = bytearray(), 0
    for marker, pos, length in _segments(data):
        if marker != 0xDB:
            continue
        body, tables = data[pos + 4:pos + 2 + length], bytearray()
        while body:
            tables += bytes([0x10 | body[0] & 15]) + b"".join(
                int(v).to_bytes(2, "big") for v in body[1:65])
            body = body[65:]
        out += data[last:pos] + b"\xff\xdb" + (2 + len(tables)).to_bytes(
            2, "big") + tables
        last = pos + 2 + length
    return _patched(bytes(out + data[last:]), 0xC0, -1, 0xC1)


@pytest.mark.parametrize("subsampling", [0, 2])
def test_sof1_with_8_and_16_bit_tables_matches_imageio(tmp_path,
                                                       subsampling):
    base = _write(tmp_path, "b", 37, 53, seed=5, quality=75,
                  subsampling=subsampling)
    want = _same_as_imageio(base)
    sof1 = tmp_path / "sof1.jpg"
    sof1.write_bytes(_patched(base.read_bytes(), 0xC0, -1, 0xC1))
    np.testing.assert_array_equal(_same_as_imageio(sof1), want)
    wide = tmp_path / "sof1_16bit.jpg"
    wide.write_bytes(_with_16bit_quant(base.read_bytes()))
    assert {s[0] for s in _segments(wide.read_bytes())} >= {0xC1, 0xDB}
    np.testing.assert_array_equal(_same_as_imageio(wide), want)


def test_read_jpegs_on_threads_equals_one_by_one(tmp_path):
    paths = [_write(tmp_path, f"t{i}", w + i, h + 2 * i, grey=i == 3, seed=i,
                    quality=60 + 5 * i, subsampling=i % 3)
             for i, (w, h) in enumerate([(33, 17), (64, 48), (9, 70),
                                         (100, 31), (45, 45), (16, 8)])]
    one = [read_jpeg(p) for p in paths]
    many = read_jpegs(paths, num_threads=4)
    assert len(many) == len(one)
    for a, b in zip(many, one):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert read_jpegs([], num_threads=4) == []


def test_exif_orientation_is_ignored(tmp_path):
    """imageio returns the stored pixels of a file tagged orientation 6
    (rotate 90); so does the decoder."""
    path = _write(tmp_path, "exif", 30, 20, seed=2, quality=90,
                  exif_orientation=6)
    from PIL import Image
    assert Image.open(path).getexif()[0x0112] == 6
    assert _same_as_imageio(path).shape == (20, 30, 3)


def test_refusals_name_the_file_and_the_feature(tmp_path):
    img = seeded_image(24, 40, 9)
    prog = tmp_path / "prog.jpg"
    save_jpeg(prog, img, quality=80, progressive=True)
    base = tmp_path / "base.jpg"
    save_jpeg(base, img, quality=80)
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(_patched(base.read_bytes(), 0xC0, -1, 0xC9))
    deep = tmp_path / "deep.jpg"
    deep.write_bytes(_patched(base.read_bytes(), 0xC0, 0, 12))
    cmyk = tmp_path / "cmyk.jpg"
    from PIL import Image
    Image.fromarray(np.concatenate([img, img[..., :1]], -1),
                    "CMYK").save(cmyk, quality=80)
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(base.read_bytes()[:len(base.read_bytes()) // 2])
    cases = {prog: "progressive", arith: "arithmetic coding", deep:
             "12-bit precision", cmyk: "4 components", cut: "truncated"}
    for path, feature in cases.items():
        for read in (read_jpeg, probe, lambda p: read_jpegs([base, p], 2)):
            if read is probe and path is cut:
                continue                    # the headers are whole
            with pytest.raises(ValueError) as e:
                read(path)
            assert str(path) in str(e.value) and feature in str(e.value), (
                str(e.value))


def test_committed_fixtures_equal_their_pixels_and_imageio():
    pixels = np.load(FIXTURES / "pixels.npz")
    assert sorted(pixels.files) == sorted(CASES)
    for name, (h, w, grey, _) in CASES.items():
        path = FIXTURES / f"{name}.jpg"
        got = read_jpeg(path)
        assert got.shape == ((h, w) if grey else (h, w, 3)), name
        np.testing.assert_array_equal(got, pixels[name], err_msg=name)
        np.testing.assert_array_equal(got, np.asarray(imageio.imread(path)),
                                      err_msg=name)
    meta = json.loads((FIXTURES / "fern_4032x3024_q80_420.json").read_text())
    full = FIXTURES / meta["file"]
    assert full.stat().st_size <= 1_500_000
    got = read_jpeg(full)
    assert list(got.shape) == meta["shape"] == [3024, 4032, 3]
    assert pixels_sha256(got) == meta["sha256"]
    assert pixels_sha256(np.asarray(imageio.imread(full))) == meta["sha256"]
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 2_000_000
