"""The port's dataset generator (``codenerf_tpu_torch/tools/make_synth_data.
py``) against the JAX-era ``tools/make_synth_data.py`` (run here, where
imageio exists), and the port's PNG writer (``data/png.py::write_png``).

The same flags and seed must give the same dataset: every PNG decodes to
the same pixels (the files' compression differs) and every other file is
byte-identical, for the SRN, Blender and LLFF layouts, and for a sharded
train stage (``--only-stage train --obj-start 1 --obj-end 2``).
"""

import subprocess
import sys
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

from codenerf_tpu_torch.data.png import encode_png, read_png, write_png
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _generate(out: Path, args, port: bool):
    cmd = ([sys.executable, "-m", "codenerf_tpu_torch.tools.make_synth_data"]
           if port else [sys.executable, "tools/make_synth_data.py"])
    subprocess.run([*cmd, "--out", str(out), *args], check=True, cwd=ROOT,
                   capture_output=True, timeout=300)


def _files(root: Path) -> list:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _assert_same_dataset(want: Path, got: Path):
    files = _files(want)
    assert files and files == _files(got)
    for rel in files:
        if rel.suffix == ".png":
            np.testing.assert_array_equal(read_png(got / rel),
                                          np.asarray(imageio.imread(
                                              want / rel)).reshape(
                                              read_png(got / rel).shape),
                                          err_msg=str(rel))
        else:
            assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


@pytest.mark.parametrize("args", [
    ("--format", "srn", "--objects", "2", "--views", "2", "--val-views",
     "2", "--size", "16", "--seed", "3"),
    ("--format", "srn", "--objects", "2", "--val-objects", "1", "--views",
     "2", "--val-views", "1", "--size", "24", "--name", "chairs",
     "--focal-jitter", "0.1", "--val-pose-jitter", "0.2"),
    ("--format", "blender", "--views", "2", "--val-views", "1", "--size",
     "16", "--seed", "5"),
    ("--format", "llff", "--views", "3", "--size", "32", "--seed", "2"),
    ("--objects", "2", "--views", "2", "--val-views", "1", "--size", "16",
     "--only-stage", "train", "--obj-start", "1", "--obj-end", "2"),
], ids=["srn", "srn-chairs-jitter", "blender", "llff", "train-shard"])
def test_generator_writes_the_jax_tools_dataset(tmp_path, args):
    _generate(tmp_path / "jax", args, port=False)
    _generate(tmp_path / "port", args, port=True)
    _assert_same_dataset(tmp_path / "jax", tmp_path / "port")


def test_shards_rebuild_the_sequential_split(tmp_path):
    """Train shards and a val-only run together write the files of one
    sequential run (run_campaign's --jobs)."""
    base = ["--objects", "3", "--views", "2", "--val-views", "1",
            "--val-objects", "2", "--size", "16", "--seed", "9"]
    _generate(tmp_path / "one", base, port=True)
    for extra in (["--only-stage", "train", "--obj-start", "0", "--obj-end",
                   "2"],
                  ["--only-stage", "train", "--obj-start", "2"],
                  ["--only-stage", "val"]):
        _generate(tmp_path / "shards", base + extra, port=True)
    assert _files(tmp_path / "one") == _files(tmp_path / "shards")
    for rel in _files(tmp_path / "one"):
        assert ((tmp_path / "one" / rel).read_bytes()
                == (tmp_path / "shards" / rel).read_bytes()), rel


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 1), (5, 6, 3), (4, 11, 4),
                                   (33, 17, 3)])
def test_write_png_round_trips_and_imageio_agrees(tmp_path, shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    # smooth rows too, so the adaptive filter picks Sub, Up, Average, Paeth
    img[: shape[0] // 2] = np.cumsum(img[: shape[0] // 2] % 3, axis=1,
                                     dtype=np.uint8)
    path = tmp_path / "x.png"
    kinds = write_png(path, img)
    assert kinds.shape == (shape[0],) and set(kinds) <= set(range(5))
    np.testing.assert_array_equal(read_png(path).reshape(shape), img)
    np.testing.assert_array_equal(
        np.asarray(imageio.imread(path)).reshape(shape), img)
    assert path.read_bytes() == encode_png(img)[0]


def test_write_png_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "f.png", np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="pixels"):
        write_png(tmp_path / "c.png", np.zeros((2, 2, 2), np.uint8))
