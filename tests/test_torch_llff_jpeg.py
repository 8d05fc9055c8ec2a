"""LLFF scenes with JPEG ``images/`` (LLFF's full-size layout) on the CPU:
a tree from ``tools/make_synth_data.py --format llff --size 44`` whose
PNGs are re-encoded by Pillow as 4:2:0 JPEGs at quality 90, read by the
port's ``LLFFDataset`` (through ``data/jpeg.py``) against the JAX
package's (through ``imageio.imread``): every sample equal at
``downsample_factor`` 1, 2 and 4 (2 and 4 box-downsample ``images/`` in
memory, decoded once at construction), both stages, two ``llffhold``s,
greyscale too; ``load_views`` equal to the stacked samples; and against
a PNG tree of the same decoded pixels, ``Harness.from_config``'s NDC
settings and ``train_cli -c configs/fern.yml``'s logged losses (at its
``downsample_factor`` 8, tiny widths) equal.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

from codenerf_tpu.data.llff import LLFFDataset as JLLFF
from codenerf_tpu_torch import train_cli
from codenerf_tpu_torch.config import load_config
from codenerf_tpu_torch.data import LLFFDataset
from codenerf_tpu_torch.harness import Harness
from tests.torch_jpeg_fixtures import save_jpeg
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
FERN = ROOT / "configs" / "fern.yml"
VIEWS = 10
TINY = ["nerf.ray_sampler.num_random_rays=16",
        "nerf.point_sampler.num_coarse=4", "nerf.point_sampler.num_fine=4",
        "models.nerf_coarse.hidden_size=8", "models.nerf_fine.hidden_size=8",
        "nerf.embedder.num_encoding_fn_xyz=2",
        "nerf.embedder.num_encoding_fn_dir=2", "runtime.compute_dtype=float32"]


def _retyped(src: Path, dst: Path, write, ext: str) -> Path:
    """``src``'s LLFF tree at ``dst`` with each image of ``images/`` read
    by imageio and written back by ``write(path, pixels)`` as ``ext``."""
    (dst / "images").mkdir(parents=True)
    shutil.copy(src / "poses_bounds.npy", dst / "poses_bounds.npy")
    for p in sorted((src / "images").iterdir()):
        write(dst / "images" / f"{p.stem}{ext}", np.asarray(imageio.imread(p)))
    return dst


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"jpeg": the JPEG tree, "decoded": a PNG tree of its decoded
    pixels, "grey": a greyscale JPEG tree}."""
    base = tmp_path_factory.mktemp("llff_jpeg")
    subprocess.run([sys.executable, "tools/make_synth_data.py", "--out",
                    str(base / "png"), "--format", "llff", "--size", "44",
                    "--views", str(VIEWS)], check=True, cwd=ROOT,
                   capture_output=True)

    def jpeg(path, img):
        save_jpeg(path, img[..., :3], quality=90, subsampling=2)

    def grey(path, img):
        save_jpeg(path, img[..., :3].mean(-1).astype(np.uint8), quality=90)

    out = {"jpeg": _retyped(base / "png", base / "jpeg", jpeg, ".jpg"),
           "grey": _retyped(base / "png", base / "grey", grey, ".jpg")}
    out["decoded"] = _retyped(out["jpeg"], base / "decoded", imageio.imwrite,
                              ".png")
    return out


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("hold", [8, 3])
@pytest.mark.parametrize("stage", ["train", "val"])
@pytest.mark.parametrize("factor", [1, 2, 4])
def test_llff_jpeg_matches_jax(trees, factor, stage, hold):
    ds = LLFFDataset(str(trees["jpeg"]), stage, downsample_factor=factor,
                     llffhold=hold)
    jds = JLLFF(str(trees["jpeg"]), stage, downsample_factor=factor,
                llffhold=hold)
    want = [i for i in range(VIEWS) if (i % hold == 0) == (stage == "val")]
    assert [p.name for p in ds.files] == [f"img_{i:03d}.jpg" for i in want]
    assert len(ds) == len(jds)
    assert (ds._views is not None) == (factor > 1)
    for i in range(len(ds)):
        _same(ds[i], jds[i])
    assert ds[0]["color"].shape == (44 // factor, 44 // factor, 3)


@pytest.mark.parametrize("factor", [1, 2])
def test_llff_greyscale_jpeg_keeps_jax_shapes(trees, factor):
    """[H, W] pixels: 2-D at factor 1, [h, w, 1] once box-downsampled."""
    ds = LLFFDataset(str(trees["grey"]), "val", downsample_factor=factor)
    jds = JLLFF(str(trees["grey"]), "val", downsample_factor=factor)
    for i in range(len(ds)):
        _same(ds[i], jds[i])
    assert ds[0]["color"].shape == ((44, 44) if factor == 1 else (22, 22, 1))


@pytest.mark.parametrize("factor", [1, 4])
def test_load_views_stacks_the_samples(trees, factor):
    ds = LLFFDataset(str(trees["jpeg"]), "train", downsample_factor=factor)
    idx = [3, 0, 3, 5]
    got = ds.load_views(idx)
    samples = [ds[i] for i in idx]
    _same(got, {k: np.stack([s[k] for s in samples]) for k in samples[0]})
    # a served view is a copy: writing into it leaves the cache as it was
    got["color"][:] = -1.0
    _same(ds[3], samples[0])


def test_harness_ndc_same_on_jpeg_and_png_trees(trees, tmp_path):
    settings = {}
    for name in ("jpeg", "decoded"):
        cfg = load_config(FERN, [f"dataset.basedir={trees[name]}",
                                 f"experiment.logdir={tmp_path}",
                                 f"experiment.id={name}",
                                 "dataset.downsample_factor=4"])
        h = Harness.from_config(cfg, device="cpu")
        settings[name] = (h.settings, h.height, h.width,
                          h.directions.numpy())
    a, b = settings["jpeg"], settings["decoded"]
    assert a[0].ndc == b[0].ndc and a[0].ndc[:2] == (11.0, 11.0)
    assert (a[0].near, a[0].far, a[0].spacing_mode) == (0.0, 1.0, "lindisp")
    assert a[1:3] == b[1:3]
    np.testing.assert_array_equal(a[3], b[3])


def test_train_cli_fern_same_losses_on_jpeg_and_png(trees, tmp_path,
                                                    monkeypatch):
    """``fern.yml`` at its ``downsample_factor`` 8: ``images/`` (44 px)
    box-downsampled to 5x5 in memory."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    losses = {}
    for name in ("jpeg", "decoded"):
        out = train_cli.main([
            "-c", str(FERN), "--device", "cpu", "--max-steps", "2",
            f"dataset.basedir={trees[name]}", f"experiment.logdir={tmp_path}",
            f"experiment.id={name}", "experiment.print_every=1",
            "experiment.save_every=1000", "experiment.validate_every=1000",
            *TINY])
        recs = [json.loads(r) for r in (tmp_path / name / "metrics.jsonl")
                .read_text().splitlines()]
        losses[name] = [(r["nerf_loss_coarse"], r["nerf_loss_fine"])
                        for r in recs if r["mode"] == "train"]
        assert len(losses[name]) == 2 and np.isfinite(out["loss_fine"])
    assert losses["jpeg"] == losses["decoded"]
