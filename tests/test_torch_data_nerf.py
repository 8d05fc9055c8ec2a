"""The Blender and LLFF datasets on the CPU against the JAX package's, on
trees written by ``tools/make_synth_data.py --format blender|llff``:
every sample (colour with its alpha, mask, pose, intrinsic, object id)
equal, at ``resolution_level`` 1 and 2 (Blender), with the in-memory
``downsample_factor`` and with a pre-downsampled ``images_N`` directory
(LLFF), and the ``llffhold`` split; a malformed JPEG is refused by name;
and ``Harness.from_config`` sets NDC for an LLFF scene as JAX's does.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import imageio.v2 as imageio

from codenerf_tpu.data.blender import BlenderNeRFDataset as JBlender
from codenerf_tpu.data.llff import LLFFDataset as JLLFF
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.data import (BatchIterator, BlenderNeRFDataset,
                                     LLFFDataset, build_dataset)
from codenerf_tpu_torch.harness import Harness
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def _synth(out: Path, fmt: str, *args) -> Path:
    subprocess.run([sys.executable, "tools/make_synth_data.py", "--out",
                    str(out), "--format", fmt, "--size", "16", *args],
                   check=True, cwd=ROOT, capture_output=True)
    return out


@pytest.fixture(scope="module")
def lego(tmp_path_factory):
    return _synth(tmp_path_factory.mktemp("nerf") / "lego", "blender",
                  "--views", "3", "--val-views", "2")


@pytest.fixture(scope="module")
def fern(tmp_path_factory):
    return _synth(tmp_path_factory.mktemp("nerf") / "fern", "llff",
                  "--views", "10")


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("stage", ["train", "val"])
def test_blender_matches_jax(lego, stage, level):
    ds = BlenderNeRFDataset(str(lego), stage, resolution_level=level)
    jds = JBlender(str(lego), stage, resolution_level=level)
    assert len(ds) == len(jds) and ds.num_objects == 1
    for i in range(len(ds)):
        _same(ds[i], jds[i])
    s = ds[0]
    assert s["color"].shape == (16 // level, 16 // level, 4)
    np.testing.assert_array_equal(s["mask"][..., 0], s["color"][..., 3])


@pytest.mark.parametrize("factor,hold", [(1, 8), (2, 3), (4, 4)])
@pytest.mark.parametrize("stage", ["train", "val"])
def test_llff_matches_jax(fern, stage, factor, hold):
    ds = LLFFDataset(str(fern), stage, downsample_factor=factor,
                     llffhold=hold)
    jds = JLLFF(str(fern), stage, downsample_factor=factor, llffhold=hold)
    want = [i for i in range(10) if (i % hold == 0) == (stage == "val")]
    assert [p.name for p in ds.files] == [f"img_{i:03d}.png" for i in want]
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        _same(ds[i], jds[i])
    assert ds[0]["color"].shape == (16 // factor, 16 // factor, 3)


def test_llff_reads_images_n(tmp_path):
    """A pre-downsampled ``images_2`` directory is read as it is."""
    root = _synth(tmp_path / "fern", "llff", "--views", "4")
    (root / "images_2").mkdir()
    for p in sorted((root / "images").iterdir()):
        img = imageio.imread(p)
        imageio.imwrite(root / "images_2" / p.name, img[::2, ::2])
    ds = LLFFDataset(str(root), "train", downsample_factor=2, llffhold=2)
    jds = JLLFF(str(root), "train", downsample_factor=2, llffhold=2)
    assert ds._mem_downsample == 1 and ds.files[0].parent.name == "images_2"
    for i in range(len(ds)):
        _same(ds[i], jds[i])


def test_llff_refuses_jpeg(tmp_path):
    """A malformed JPEG (SOI and nothing more) raises ValueError naming
    the file, read as it is (``images_4``) and decoded at construction
    (``images/`` downsampled in memory)."""
    root = _synth(tmp_path / "fern", "llff", "--views", "2")
    (root / "images_4").mkdir()
    for i in range(2):
        (root / "images_4" / f"img_{i:03d}.jpg").write_bytes(b"\xff\xd8")
    ds = LLFFDataset(str(root), "val", downsample_factor=4)
    with pytest.raises(ValueError, match="img_000.jpg: truncated"):
        ds[0]
    shutil.rmtree(root / "images")
    (root / "images_4").rename(root / "images")
    with pytest.raises(ValueError, match="img_000.jpg: truncated"):
        LLFFDataset(str(root), "val", downsample_factor=4)


def test_batches_and_the_harness_take_nerf_scenes(lego, fern, tmp_path):
    """The seeded batch stream stacks Blender samples as JAX's does, and
    the harness gives an LLFF scene NDC settings (near 0, far 1,
    ``lindisp``, the probe's height, width and focal) but not with
    ``dataset.no_ndc``, nor a Blender scene."""
    from codenerf_tpu.data.loader import BatchIterator as JBatchIterator
    it = BatchIterator(BlenderNeRFDataset(str(lego), "train"), 2, seed=7)
    jit = JBatchIterator(JBlender(str(lego), "train"), 2, seed=7)
    for _ in range(3):
        _same(next(it), next(jit))
    common = [f"experiment.logdir={tmp_path}", "experiment.id=h"]
    fern_cfg = load_config(ROOT / "configs" / "fern.yml", common + [
        f"dataset.basedir={fern}", "dataset.downsample_factor=2"])
    h = Harness.from_config(fern_cfg, device="cpu")
    probe = build_dataset(fern_cfg.dataset, "val")[0]
    s = h.settings
    assert s.ndc == (8.0, 8.0, float(probe["intrinsic"][0, 0]))
    assert (s.near, s.far, s.spacing_mode) == (0.0, 1.0, "lindisp")
    assert not h.has_codes
    no_ndc = load_config(ROOT / "configs" / "fern.yml", common + [
        f"dataset.basedir={fern}", "dataset.no_ndc=True"])
    assert Harness.from_config(no_ndc, device="cpu").settings.ndc is None
    lego_cfg = load_config(ROOT / "configs" / "lego.yml", common + [
        f"dataset.basedir={lego}"])
    h = Harness.from_config(lego_cfg, device="cpu")
    assert h.settings.ndc is None and (h.height, h.width) == (8, 8)
