"""The port and chip_smoke.py import nothing the card's machine lacks.

That machine has torch, numpy and the standard library but no JAX and no
PyYAML, and the port must not reach into the JAX package (whose
``__init__`` imports jax).  A subprocess refuses those imports and loads
every module of the port and chip_smoke.py; the flagship settings come
from ``SRN_CARS_CODE``, which must say what the YAML says.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

from codenerf_tpu.config import load_config as jax_load_config
from codenerf_tpu_torch.config import (SRN_CARS_CODE, config_from_dict,
                                       load_config)

ROOT = Path(__file__).resolve().parents[1]

ISOLATED = r'''
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "yaml", "triton", "codenerf_tpu")

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
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not leaked, leaked
print("isolated ok", len(names))
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_and_smoke_import_without_jax_yaml_triton():
    out = subprocess.run([sys.executable, "-c", ISOLATED], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout


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
