"""What a run loads: nothing whose top-level module name is ``jax`` or
``codenerf_tpu`` (the JAX package; ``codenerf_tpu_torch`` is the port,
and the check compares whole top-level names), and for the plain
reference alone nothing of the port either.  Each side runs in a fresh
interpreter."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time
sys.path[0] = {root!r}
import benchmark.run
from benchmark import drive
from benchmark.tests.conftest import tiny_cell
drive.run_cell(tiny_cell("cars-train"), 3, 0.2, False, time.monotonic())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[0] = {root!r}
import torch
from benchmark.reference import nerf, steps
g = torch.Generator().manual_seed(0)
p = nerf.init_params(nerf.codenerf_shapes(8, 4, 4, 63, 27), g, "cpu")
xyz = nerf.encode(torch.randn(2, 3, 3), 10)
nerf.codenerf(p, xyz, nerf.encode(torch.randn(2, 3), 4), torch.randn(2, 4),
              torch.randn(2, 4), "fp8").sum()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("script, refused", [
    (RUN, {"jax", "jaxlib", "flax", "codenerf_tpu"}),
    (REFERENCE, {"jax", "jaxlib", "flax", "codenerf_tpu",
                 "codenerf_tpu_torch"}),
], ids=["run", "reference"])
def test_loaded_top_level_names(script, refused):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = script.format(root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & refused, sorted(loaded & refused)
    if script is RUN:
        assert "codenerf_tpu_torch" in loaded
