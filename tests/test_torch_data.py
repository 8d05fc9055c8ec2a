"""Port parity for the data pipeline: ``read_png`` against imageio (the
JAX package's decoder) on generated, committed and hand-filtered PNGs;
``SRNDataset`` items and batches against JAX's (``use_native=False``);
``BatchIterator``'s index stream; ``PrefetchIterator`` on the CPU.  Every
comparison is exact."""

import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from codenerf_tpu.config import config_from_dict as j_config_from_dict
from codenerf_tpu.data.loader import BatchIterator as JBatchIterator
from codenerf_tpu.data.srn import SRNDataset as JSRNDataset
from codenerf_tpu_torch.config import config_from_dict
from codenerf_tpu_torch.data import (BatchIterator, PrefetchIterator,
                                     SRNDataset, build_dataset, read_png)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _synth(root: Path, *extra):
    subprocess.run([sys.executable, "tools/make_synth_data.py", "--out",
                    str(root), "--objects", "3", "--views", "3",
                    "--val-views", "2", "--size", "16", *extra],
                   check=True, cwd=ROOT, capture_output=True)
    return root


@pytest.fixture(scope="module")
def cars(tmp_path_factory):
    return _synth(tmp_path_factory.mktemp("synth") / "srn_cars")


# ---- PNG ----

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def write_png(path, img, filters, depth=8, colour=None, crc_ok=True):
    """A PNG of ``img`` (uint8 [H, W, C]) with row ``y`` filtered by
    ``filters[y % len(filters)]`` (PNG spec section 9)."""
    h, w, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}[c] if colour is None else colour
    stride = w * c
    flat = img.reshape(h, stride).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        prior = flat[y - 1] if y else np.zeros(stride, np.int64)
        row = flat[y]
        out = []
        for x in range(stride):
            a = row[x - c] if x >= c else 0
            b = prior[x]
            cc = prior[x - c] if x >= c else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, cc)][kind]
            out.append((row[x] - pred) % 256)
        raw += bytes([kind] + out)

    def chunk(kind, body):
        crc = zlib.crc32(kind + body) ^ (0 if crc_ok else 1)
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", crc)

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))
    Path(path).write_bytes(data)


def _imageio(path):
    img = np.asarray(imageio.imread(path))
    return img[..., None] if img.ndim == 2 else img


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "all"])
def test_read_png_each_row_filter(tmp_path, channels, filters):
    rng = np.random.default_rng(channels * 10 + len(filters) + filters[0])
    img = rng.integers(0, 256, (7, 9, channels), dtype=np.uint8)
    img[2:4] = 255                       # flat rows: long runs
    path = tmp_path / "f.png"
    write_png(path, img, filters)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, _imageio(path))


@pytest.mark.parametrize("shape", [(1, 1, 3), (13, 2, 3), (2, 13, 4),
                                   (16, 16, 1)], ids=str)
def test_read_png_mixed_row_filters_any_shape(tmp_path, shape):
    # rows decode together along anti-diagonals: every mix of filters
    # between neighbouring rows, and images taller than wide and wider
    # than tall, must decode exactly
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[shape[0] // 2:, :shape[1] // 2] //= 8            # a smooth patch
    filters = rng.integers(0, 5, shape[0]).tolist()
    path = tmp_path / "m.png"
    write_png(path, img, filters)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(read_png(path), _imageio(path))


def test_read_png_refuses_an_unknown_row_filter(tmp_path):
    img = np.arange(4 * 3 * 3, dtype=np.uint8).reshape(4, 3, 3)
    path = tmp_path / "f5.png"
    write_png(path, img, [0])
    data = path.read_bytes()
    at = data.index(b"IDAT")
    length = struct.unpack(">I", data[at - 4:at])[0]
    raw = bytearray(zlib.decompress(data[at + 4:at + 4 + length]))
    raw[2 * (3 * 3 + 1)] = 5                             # row 2's filter
    body = zlib.compress(bytes(raw))
    path.write_bytes(data[:at - 4] + struct.pack(">I", len(body)) + b"IDAT"
                     + body + struct.pack(">I", zlib.crc32(b"IDAT" + body))
                     + data[at + 8 + length:])
    with pytest.raises(ValueError, match="unknown row filter 5 in row 2"):
        read_png(path)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_matches_imageio_on_pil_output(tmp_path, mode):
    rng = np.random.default_rng(5)
    c = len(mode)
    img = rng.integers(0, 256, (33, 20, c), dtype=np.uint8)
    img[:, :10] //= 16                   # smooth half: PIL picks filters
    path = tmp_path / "p.png"
    Image.fromarray(img[..., 0] if c == 1 else img, mode).save(path)
    np.testing.assert_array_equal(read_png(path), _imageio(path))


COMMITTED = sorted((ROOT / "assets" / "synthv2_samples").glob("*.png")) + \
    sorted((ROOT / "assets" / "turntable").glob("*.png"))


@pytest.mark.parametrize("path", COMMITTED, ids=lambda p: p.name)
def test_read_png_matches_imageio_on_committed_pngs(path):
    np.testing.assert_array_equal(read_png(path), _imageio(path))


def test_read_png_matches_imageio_on_generated_data(cars):
    files = sorted(cars.glob("*/*/rgb/*.png"))
    assert len(files) == 3 * 3 + 3 * 2
    for path in files:
        np.testing.assert_array_equal(read_png(path), _imageio(path))


def test_read_png_refuses_other_formats(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    write_png(tmp_path / "d16.png", img, [0], depth=16)
    write_png(tmp_path / "crc.png", img, [0], crc_ok=False)
    Image.fromarray(np.zeros((4, 4), np.uint8), "L").convert("P").save(
        tmp_path / "pal.png")
    Image.fromarray(np.zeros((4, 4, 2), np.uint8), "LA").save(
        tmp_path / "la.png")
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    for name, match in (("d16", "bit depth 16"), ("crc", "CRC"),
                        ("pal", "colour type 3"), ("la", "colour type 4"),
                        ("not", "not a PNG")):
        with pytest.raises(ValueError, match=match):
            read_png(tmp_path / f"{name}.png")


# ---- SRNDataset ----

def _same_sample(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("stage", ["train", "val"])
def test_srn_items_and_views_match_jax(cars, stage):
    ds, jds = SRNDataset(str(cars), stage), JSRNDataset(str(cars), stage,
                                                        use_native=False)
    assert (len(ds), ds.num_objects, ds.num_views) == (
        len(jds), jds.num_objects, jds.num_views)
    assert ds.intrinsics_homogeneous() == jds.intrinsics_homogeneous()
    for i in range(len(ds)):
        _same_sample(ds[i], jds[i])
    idx = np.array([len(ds) - 1, 0, 2, 2])
    _same_sample(ds.load_views(idx), jds.load_views(idx))
    # the crop leaves 12 x 12 of 16 x 16; the flip is applied on read
    assert ds[0]["color"].shape == (12, 12, 3)


def test_srn_chairs_subdir_and_heterogeneous_intrinsics(tmp_path):
    root = _synth(tmp_path / "srn_chairs", "--name", "chairs",
                  "--focal-jitter", "0.1")
    train = root / "chairs_train"
    alt = train / "chairs_2.0_train"
    alt.mkdir()
    for obj in sorted(train.glob("obj*")):
        shutil.move(str(obj), alt / obj.name)
    ds = SRNDataset(str(root), "train")
    jds = JSRNDataset(str(root), "train", use_native=False)
    assert ds.base_path == jds.base_path == alt
    assert ds.intrinsics_homogeneous() is jds.intrinsics_homogeneous() is \
        False
    _same_sample(ds[4], jds[4])
    with pytest.raises(FileNotFoundError):
        SRNDataset(str(root), "test")


def test_batch_iterator_draws_jax_indices(cars):
    ds = SRNDataset(str(cars), "train")
    jds = JSRNDataset(str(cars), "train", use_native=False)
    it, jit = BatchIterator(ds, 2, seed=56), JBatchIterator(jds, 2, seed=56)
    for _ in range(6):
        _same_sample(next(it), next(jit))
    _same_sample(it.fixed_batch(start=5), jit.fixed_batch(start=5))


@pytest.mark.parametrize("kind", ["BlenderNeRFDataset", "llff",
                                  "LLFFDataset"])
def test_build_dataset_refuses_blender_and_llff(kind, tmp_path):
    """The Blender and LLFF types are ported: build_dataset reaches their
    loaders, which refuse only a tree that is not there (the loaders
    themselves are held against JAX's in test_torch_data_nerf.py)."""
    cfg = config_from_dict({"dataset": {"type": kind,
                                        "basedir": str(tmp_path / "x")}})
    with pytest.raises(FileNotFoundError, match="x"):
        build_dataset(cfg.dataset, "train")
    with pytest.raises(ValueError, match="unknown dataset type"):
        build_dataset(config_from_dict(
            {"dataset": {"type": "Nope"}}).dataset, "train")


def test_build_dataset_srn(cars):
    d = {"dataset": {"type": "SRNDataset", "basedir": str(cars)}}
    ds = build_dataset(config_from_dict(d).dataset, "val")
    from codenerf_tpu.data.loader import build_dataset as j_build
    jds = j_build(j_config_from_dict(d).dataset, "val")
    jds.use_native = False
    _same_sample(ds[1], jds[1])


# ---- PrefetchIterator ----

def test_prefetch_ships_the_same_batches_to_the_cpu(cars):
    ds = SRNDataset(str(cars), "train")
    want = BatchIterator(ds, 2, seed=3)
    stream = PrefetchIterator(BatchIterator(ds, 2, seed=3), depth=2,
                              device="cpu")
    try:
        for _ in range(5):
            got, ref = next(stream), next(want)
            for k in ("pose", "color", "object_id"):
                assert torch.is_tensor(got[k])
                np.testing.assert_array_equal(got[k].numpy(), ref[k])
            np.testing.assert_array_equal(got["intrinsic"], ref["intrinsic"])
    finally:
        stream.close()
    assert not stream._thread.is_alive()


def test_prefetch_raises_the_loader_error_and_keeps_numpy():
    def broken():
        yield {"pose": np.zeros(1)}
        raise OSError("disk gone")

    stream = PrefetchIterator(broken(), depth=1)
    assert isinstance(next(stream)["pose"], np.ndarray)
    with pytest.raises(OSError, match="disk gone"):
        next(stream)
    stream.close()
