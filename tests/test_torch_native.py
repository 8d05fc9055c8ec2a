"""The port's native SRN loader (``data/native.py`` over
``data/csrc/srn_loader.cc``), built here by g++ against zlib, against the
Python path (``data/png.py::read_png``) and the JAX package's loader
(``SRNDataset(use_native=False)``), bit for bit.

Trees: the generator's RGB views; RGBA views written with every row
filter and with 255-valued channels, so the mask and the filters are
exercised; views whose intrinsics are not square, whose crop the Python
slicing clips.  A corrupt file raises, and a loader that cannot be built
falls back to the Python path saying so, once.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from codenerf_tpu.data.srn import SRNDataset as JSRNDataset
from codenerf_tpu_torch.data import SRNDataset, native
from codenerf_tpu_torch.data.png import read_png, write_png
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rgb_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("rgb") / "srn_cars"
    subprocess.run(
        [sys.executable, "-m", "codenerf_tpu_torch.tools.make_synth_data",
         "--out", str(root), "--objects", "2", "--views", "3",
         "--val-views", "2", "--size", "24"],
        check=True, cwd=ROOT, capture_output=True, timeout=300)
    return root


def _write_tree(root: Path, height: int, width: int, channels: int,
                objects=2, views=3, seed=0):
    """An SRN tree of random views: half smooth (the adaptive filter picks
    Sub / Up / Average / Paeth), a quarter of the pixels 255 (masked)."""
    rng = np.random.default_rng(seed)
    for o in range(objects):
        d = root / "cars_train" / f"obj{o:03d}"
        (d / "rgb").mkdir(parents=True)
        (d / "pose").mkdir()
        (d / "intrinsics.txt").write_text(
            f"20.0 {width / 2} {height / 2} 0.\n0. 0. 0.\n1.\n{height} "
            f"{width}\n")
        for v in range(views):
            img = rng.integers(0, 256, (height, width, channels), np.uint8)
            img[: height // 2] = np.cumsum(img[: height // 2] % 4, axis=1,
                                           dtype=np.uint8)
            img[rng.random((height, width)) < 0.25] = 255
            write_png(d / "rgb" / f"{v:06d}.png", img)
            np.savetxt(d / "pose" / f"{v:06d}.txt", np.eye(4).reshape(1, 16))
    return root


def _same(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _all_three(root: Path, stage="train"):
    ds = SRNDataset(str(root), stage)
    idx = list(range(len(ds))) + [1, 0]
    before = native.status()["batches"]["native"]
    got = ds.load_views(idx)
    assert native.status()["batches"]["native"] == before + 1
    python = SRNDataset(str(root), stage, use_native=False).load_views(idx)
    jax_side = JSRNDataset(str(root), stage, use_native=False).load_views(idx)
    return got, python, jax_side


def test_the_library_builds_here():
    assert native.available()
    st = native.status()
    assert st["path"] == "native" and st["error"] is None
    assert Path(st["library"]).parent.name == "torch_native"


@pytest.mark.parametrize("stage", ["train", "val"])
def test_generated_rgb_views_match_python_and_jax(rgb_tree, stage):
    got, python, jax_side = _all_three(rgb_tree, stage)
    _same(got, python)
    _same(got, jax_side)


@pytest.mark.parametrize("hwc", [(16, 16, 4), (16, 16, 3), (16, 24, 3),
                                 (24, 16, 4)],
                         ids=["rgba", "rgb", "wide", "tall-rgba"])
def test_written_views_match_python_and_jax(tmp_path, hwc):
    root = _write_tree(tmp_path / "srn_cars", *hwc)
    got, python, jax_side = _all_three(root)
    _same(got, python)
    _same(got, jax_side)
    assert 0 < got["mask"].mean() < 1


def test_load_batch_and_probe(tmp_path):
    root = _write_tree(tmp_path / "srn_cars", 16, 16, 4, objects=1)
    paths = sorted((root / "cars_train" / "obj000" / "rgb").glob("*.png"))
    assert native.probe(paths[0]) == (16, 16, 4)
    assert native.probe(tmp_path / "missing.png") is None
    colors, masks = native.load_batch(paths, 16, 16, 4, num_threads=3)
    assert colors.shape == (3, 12, 12, 4) and masks.shape == (3, 12, 12, 1)
    for i, p in enumerate(paths):
        img = read_png(p)[2:14, 2:14]
        np.testing.assert_array_equal(colors[i],
                                      img.astype(np.float32) / 255.0)
        np.testing.assert_array_equal(
            masks[i, ..., 0], (img != 255).all(-1).astype(np.float32))
    with pytest.raises(RuntimeError, match="failed to decode"):
        native.load_batch(paths, 16, 16, 3)          # wrong channel count


@pytest.mark.parametrize("damage", ["crc", "truncated", "not_png"])
def test_a_corrupt_view_raises(tmp_path, damage):
    root = _write_tree(tmp_path / "srn_cars", 16, 16, 3, objects=1)
    path = root / "cars_train" / "obj000" / "rgb" / "000001.png"
    data = bytearray(path.read_bytes())
    if damage == "crc":
        data[-20] ^= 0xFF                       # inside the IDAT body
    elif damage == "truncated":
        data = data[:-30]
    else:
        data[:4] = b"GIF8"
    path.write_bytes(bytes(data))
    ds = SRNDataset(str(root), "train")
    with pytest.raises(RuntimeError, match="1/3 views failed"):
        native.load_batch([p for _, p in ds.rgb_files], 16, 16, 3)
    # the first view's header still matches: the native path is taken
    with pytest.raises(RuntimeError, match="native SRN loader"):
        ds.load_views([0, 1, 2])


def test_a_failed_build_falls_back_and_says_so(tmp_path, monkeypatch,
                                               capsys):
    from codenerf_tpu_torch.ops import _build

    def broken(*args, **kwargs):
        raise RuntimeError("g++ failed (1): no zlib.h")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(_build, "build_host", broken)
    root = _write_tree(tmp_path / "srn_cars", 16, 16, 3, objects=1)
    ds = SRNDataset(str(root), "train")
    before = native.status()["batches"]["python"]
    got = ds.load_views([0, 1])
    ds.load_views([2])
    err = capsys.readouterr().err
    assert err.count("native SRN loader unavailable") == 1
    assert "no zlib.h" in err
    st = native.status()
    assert st["path"] == "python" and "no zlib.h" in st["error"]
    assert st["batches"]["python"] == before + 2
    _same(got, SRNDataset(str(root), "train", use_native=False).load_views(
        [0, 1]))
    with pytest.raises(RuntimeError, match="not available"):
        native.load_batch([ds.rgb_files[0][1]], 16, 16, 3)
