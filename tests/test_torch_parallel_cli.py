"""The port's entry points in a world of two gloo ranks on the CPU:
``train_cli -g 2`` (which spawns its ranks), ``eval_cli --multihost``
under the environment torchrun sets for two processes, the seeds every
rank draws from, and an out-of-memory error on one rank of the category
protocol.  The port's counterpart of ``tests/test_cli.py``'s multi-host
run and ``tools/multihost_smoke.py``.

On ``tests/test_torch_eval.py``'s tree (16 px, 12 x 12 after the crop)
with its small f32 model: 2 images x 144 rays a train step, jitter on;
validation draws all 144 pixels with the jitter off.  The two-rank
checkpoint is held against a one-rank run's at f32 atol 1e-5; the
two-rank eval table against the one-rank table to within one unit of
its last printed digit; the ranks' seeds, draws and parameters, recorded
in the ranks of the ``-g 2`` run, bit-identical.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from codenerf_tpu_torch import train_cli
from codenerf_tpu_torch.parallel import launch
from codenerf_tpu_torch.train import checkpoint
from tests import torch_parallel_ranks as ranks
from tests.test_torch_eval import (BASE, NUM_OBJECTS, ROOT, _overrides,
                                   _saved_checkpoint, synth_root)  # noqa: F401
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

STEPS = 3
TIMEOUT = 300
# TensorBoard's import takes ~14 s here; the loggers fall back to
# metrics.jsonl without it
NO_TENSORBOARD = "torch.utils.tensorboard"
EVAL_RUNNER = ("import runpy, sys; "
               f"sys.modules[{NO_TENSORBOARD!r}] = None; "
               "runpy.run_module('codenerf_tpu_torch.eval_cli', "
               "run_name='__main__', alter_sys=True)")


def _train_overrides(synth_root, logdir, run):
    return _overrides(synth_root, logdir) + [
        f"experiment.id={run}", "experiment.print_every=1",
        f"experiment.save_every={STEPS}", "nerf.point_sampler.perturb=True"]


def _params(logdir, run):
    sd = torch.load(checkpoint.checkpoint_path(
        logdir / run / "checkpoints", STEPS), weights_only=False)
    return {f"{k}.{n}": v.numpy() for k in (
        "model_nerf_coarse_state_dict", "model_nerf_fine_state_dict",
        "model_embedding_state_dict") for n, v in sd[k].items()}


@pytest.fixture(scope="module")
def train_runs(synth_root, tmp_path_factory):
    """``train_cli`` for ``STEPS`` steps on one rank and with ``-g 2``,
    whose spawned ranks record their draws (``torch_parallel_ranks
    .recorded``): the log directory, each run's returned metrics, and
    the two ranks' records."""
    logdir = tmp_path_factory.mktemp("runs")
    records = []
    spawn = launch.spawn

    def recording_spawn(fn, nprocs, args=(), **kwargs):
        out = spawn(ranks.recorded, nprocs, (fn, *args),
                    **dict(kwargs, timeout=TIMEOUT))
        records.extend(r["record"] for r in out)
        return [r["result"] for r in out]

    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, NO_TENSORBOARD, None)
        mp.setattr(launch, "spawn", recording_spawn)
        for run, gpus in (("one", []), ("two", ["-g", "2"])):
            outs[run] = train_cli.main(
                ["-c", str(BASE), "--device", "cpu", "--max-steps",
                 str(STEPS), *gpus] + _train_overrides(synth_root, logdir,
                                                       run))
    return logdir, outs, records


def test_train_cli_two_ranks_match_one(train_runs):
    """``-g 2 --device cpu``: two spawned ranks; rank 0 alone logs and
    saves, and its checkpoint holds the one-rank run's parameters."""
    logdir, outs, records = train_runs
    assert len(records) == 2
    for run in ("one", "two"):
        assert np.isfinite(outs[run]["loss_fine"])
        logged = (logdir / run / "metrics.jsonl").read_text().splitlines()
        # one record per step: rank 1 wrote none
        assert len(logged) == STEPS, logged
        assert sorted(os.listdir(logdir / run / "checkpoints")) == [
            f"{STEPS}.ckpt"]
    one, two = _params(logdir, "one"), _params(logdir, "two")
    assert one.keys() == two.keys()
    for k in one:
        np.testing.assert_allclose(two[k], one[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def _table(stdout: str) -> list:
    """The category table's rows, each as its numbers."""
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "category evaluation over" in ln)
    rows = []
    for ln in lines[start + 2:]:
        cells = ln.split("|")
        rows.append([float(c) for c in cells[1:]])
        if ln.lstrip().startswith("mean"):
            return rows
    raise AssertionError(stdout)


def test_eval_cli_multihost_prints_the_one_rank_table(synth_root, tmp_path):
    """Two processes with torchrun's environment join one world; rank 0
    prints the category table, which is the one-rank table."""
    ckpt = _saved_checkpoint(synth_root, tmp_path)
    argv = [sys.executable, "-c", EVAL_RUNNER, "-c",
            str(BASE), "--load-checkpoint", str(ckpt), "--device", "cpu",
            "--all-objects", "--batch-objects", "3", "--num-objects",
            str(NUM_OBJECTS)] + _overrides(synth_root, tmp_path)
    port = str(launch.free_port())
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            argv + ["--multihost"], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    one = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=TIMEOUT)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert one.returncode == 0, one.stderr[-3000:]
    assert "category evaluation" not in outs[1][0]
    want, got = _table(one.stdout), _table(outs[0][0])
    assert len(got) == len(want) == 4          # 3 objects and the mean
    # PSNR and dPSNR print 2 decimals, SSIM and the pose error 3
    np.testing.assert_allclose(np.array(got)[:, [0, 3]],
                               np.array(want)[:, [0, 3]], atol=0.0101,
                               rtol=0)
    np.testing.assert_allclose(np.array(got)[:, [1, 2]],
                               np.array(want)[:, [1, 2]], atol=0.00101,
                               rtol=0)


def test_ranks_draw_the_same_seeds(train_runs):
    """Every rank of the ``-g 2`` run drew the same initial weights, image
    batches and ray indices, and ended with the same parameters."""
    a, b = train_runs[2]
    assert len(a["batches"]) == len(a["inds"]) == STEPS
    for name in ("init", "final"):
        assert a[name].keys() == b[name].keys()
        for k in a[name]:
            assert np.array_equal(a[name][k], b[name][k]), (name, k)
    for (pa, ia), (pb, ib) in zip(a["batches"], b["batches"]):
        assert np.array_equal(pa, pb) and np.array_equal(ia, ib)
    for ia, ib in zip(a["inds"], b["inds"]):
        assert np.array_equal(ia, ib)


def test_out_of_memory_on_one_rank_brings_the_world_down(synth_root,
                                                         tmp_path):
    """Rank 1's batched TTO runs out of memory in the category protocol:
    it raises at once, without retrying at half the K (rank 0 waits in
    that group's collectives, which a retry would no longer match), and
    the launcher ends the world well inside its deadline."""
    ckpt = _saved_checkpoint(synth_root, tmp_path)
    marker = tmp_path / "groups"
    argv = ["-c", str(BASE), "--load-checkpoint", str(ckpt), "--device",
            "cpu", "--multihost", "--all-objects", "--batch-objects", "3",
            "--num-objects", str(NUM_OBJECTS)] + _overrides(synth_root,
                                                            tmp_path)
    with pytest.raises(Exception) as err:
        launch.spawn(ranks.category_out_of_memory, 2, (argv, str(marker)),
                     devices=["cpu"] * 2, timeout=TIMEOUT)
    assert not isinstance(err.value, TimeoutError)
    assert marker.read_text().splitlines() == ["group"]
