"""The port and chip_smoke.py import nothing the card's machine lacks.

That machine has torch, numpy and the standard library but no JAX, no
PyYAML and no imageio, and the port must not reach into the JAX package
(whose ``__init__`` imports jax) or the root ``tools/``, nor need PIL.  A
subprocess refuses those imports, loads every module of the port (its
tools included) and chip_smoke.py, reads the flagship YAML through
``yaml_lite`` and runs the train and eval CLIs' and every tool's
``--help``; the flagship settings come from ``SRN_CARS_CODE``, which must
say what the YAML says.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

from codenerf_tpu.config import load_config as jax_load_config
from codenerf_tpu_torch.config import (SRN_CARS_CODE, config_from_dict,
                                       load_config)
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]

ISOLATED = r'''
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "yaml", "imageio", "PIL", "triton",
           "codenerf_tpu", "tools")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"refused: {name}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Refuse())

import codenerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(codenerf_tpu_torch.__path__,
                                               "codenerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from codenerf_tpu_torch.config import SRN_CARS_CODE, config_from_dict
from codenerf_tpu_torch.pipeline import RenderSettings
cfg = config_from_dict(SRN_CARS_CODE)
s = RenderSettings.from_config(cfg)
assert s.fine_cfg.hidden_size == 256 and s.num_fine == 128
assert "codenerf_tpu_torch.train.step" in names
assert {"codenerf_tpu_torch.eval.tto", "codenerf_tpu_torch.core.lie"} <= set(
    names)
assert cfg.optimizer.resolved_val_type == "AdamW"
assert cfg.optimizer.val_lr == 0.005 and cfg.nerf.point_sampler.perturb
assert cfg.nerf.ray_sampler.num_random_rays == 4096
assert cfg.dataset.train_batch_size == 4 and cfg.optimizer.type == "AdamW"
assert {"codenerf_tpu_torch.config.schema",
        "codenerf_tpu_torch.config.yaml_lite", "codenerf_tpu_torch.data.png",
        "codenerf_tpu_torch.data.srn", "codenerf_tpu_torch.data.loader",
        "codenerf_tpu_torch.utils.logging", "codenerf_tpu_torch.harness",
        "codenerf_tpu_torch.train.checkpoint", "codenerf_tpu_torch.train.loop",
        "codenerf_tpu_torch.train_cli", "codenerf_tpu_torch.eval_cli",
        "codenerf_tpu_torch.eval.capacity"} <= set(names)
assert {"codenerf_tpu_torch.data.blender",
        "codenerf_tpu_torch.data.llff"} <= set(names)
# data parallelism: the world, its collectives and the ranks' launcher
assert {"codenerf_tpu_torch.parallel", "codenerf_tpu_torch.parallel.mesh",
        "codenerf_tpu_torch.parallel.launch"} <= set(names)
# int8 serving: the module imports, and its primitive runs, without jax
assert "codenerf_tpu_torch.models.quantized" in names
import torch
from codenerf_tpu_torch.models.quantized import quantize_tensor
assert quantize_tensor(torch.tensor([0.5, 1.5, 300.0]), 1.0).tolist() == [
    0, 2, 127]
from codenerf_tpu_torch.config import load_config
assert load_config("configs/srn-cars-code.yml") == cfg
# the vanilla configs' settings: FlexibleNeRF, and NDC rays importable
from codenerf_tpu_torch.core import ndc_rays
from codenerf_tpu_torch.models import FlexibleNeRFConfig
for yml in ("lego", "fern", "srn-cars", "srn-chairs"):
    vs = RenderSettings.from_config(load_config(f"configs/{yml}.yml"))
    assert isinstance(vs.fine_cfg, FlexibleNeRFConfig), yml
import contextlib, io, runpy
for cli in ("train_cli", "eval_cli"):
    sys.argv = [cli, "--help"]
    help_text = io.StringIO()
    try:
        with contextlib.redirect_stdout(help_text):
            runpy.run_module("codenerf_tpu_torch." + cli, run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    assert "--load-checkpoint" in help_text.getvalue()
    assert "--device" in help_text.getvalue()
# the tools around the CLIs and the native loader: each tool's --help
TOOLS = ("make_synth_data", "render_views", "phi_sweep", "diag_fine",
         "gpu_selftest", "run_campaign", "supervise_train")
assert {"codenerf_tpu_torch.tools." + t for t in TOOLS} | {
    "codenerf_tpu_torch.data.native"} <= set(names)
for tool in TOOLS:
    sys.argv = [tool, "--help"]
    help_text = io.StringIO()
    try:
        with contextlib.redirect_stdout(help_text):
            runpy.run_module("codenerf_tpu_torch.tools." + tool,
                             run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, (tool, e.code)
    assert "usage:" in help_text.getvalue(), tool
# the JPEG decoder: imported, built and run without PIL or imageio
assert "codenerf_tpu_torch.data.jpeg" in names
import numpy as np
from codenerf_tpu_torch.data.jpeg import read_jpeg
fixture = "codenerf_tpu_torch/fixtures/jpeg/q75_420_37x53"
assert np.array_equal(read_jpeg(fixture + ".jpg"),
                      np.load("codenerf_tpu_torch/fixtures/jpeg/pixels.npz")[
                          "q75_420_37x53"])
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("isolated ok", len(names))
'''


# what a rank spawned by ``parallel.launch.spawn`` imports: its entry
# module, the train CLI's rank function and the world it joins
RANK_ENTRY = ISOLATED.split("import codenerf_tpu_torch\n")[0] + r'''
import codenerf_tpu_torch.parallel.launch as launch
from codenerf_tpu_torch import train_cli
assert callable(launch._rank_main) and callable(train_cli._train_rank)
assert launch.mesh.init_world(0) is None
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("rank entry ok")
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_and_smoke_import_without_jax_yaml_triton():
    """Also without imageio and PIL; the train and eval CLIs' and the
    tools' --help run there, and the JPEG decoder reads a fixture."""
    out = subprocess.run([sys.executable, "-c", ISOLATED], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout


def test_spawned_rank_entry_imports_without_jax_yaml_triton():
    env = _env()
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(name, None)
    out = subprocess.run([sys.executable, "-c", RANK_ENTRY], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "rank entry ok" in out.stdout


def _leaves(d, prefix=()):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(obj, path):
    for k in path:
        obj = getattr(obj, k)
    return obj


def test_srn_cars_code_literal_matches_the_yaml():
    yml = ROOT / "configs" / "srn-cars-code.yml"
    jcfg = jax_load_config(yml)
    pcfg = config_from_dict(SRN_CARS_CODE)
    paths = set()
    for path, value in _leaves(SRN_CARS_CODE):
        assert _get(jcfg, path) == value, ".".join(path)
        assert _get(pcfg, path) == value, ".".join(path)
        paths.add(".".join(path))
    assert load_config(yml) == pcfg
    # the TTO fields and the jitter switch are part of the literal
    assert {"optimizer.val_type", "optimizer.val_lr", "optimizer.angle_lr",
            "optimizer.radius_lr", "nerf.point_sampler.perturb"} <= paths
    for name in ("resolved_val_type", "resolved_angle_lr",
                 "resolved_radius_lr"):
        assert getattr(pcfg.optimizer, name) == getattr(jcfg.optimizer,
                                                        name), name


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """Without CUDA the smoke exits nonzero and prints no result; copied
    into a directory of its own it cannot import the port and fails."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    here = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert here.returncode != 0
    assert '"ok"' not in here.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env.pop("PYTHONPATH")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=300)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
