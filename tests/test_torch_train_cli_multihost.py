"""``train_cli --multihost`` (``train.py``'s flag) on the CPU: without
torchrun's environment it raises the ``RuntimeError`` that ``eval_cli
--multihost`` raises, also beside ``-g 2`` (which then starts no ranks);
in a process with a one-rank gloo environment it joins that world and
trains ``configs/synth-smoke.yml`` to the same metrics as the run
without the flag."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from codenerf_tpu_torch import eval_cli, train_cli
from codenerf_tpu_torch.parallel import launch
from tests.torch_worker_threads import worker_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "synth-smoke.yml"
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
# train_cli in a process of its own; its last line holds the metrics it
# returned and the process groups it joined (TensorBoard's import is slow
# here, and the loggers fall back to metrics.jsonl without it)
RUNNER = ("import json, sys; "
          "sys.modules['torch.utils.tensorboard'] = None; "
          "import torch.distributed as dist; "
          "joined = []; init = dist.init_process_group; "
          "dist.init_process_group = lambda backend, **k: (joined.append("
          "[backend, k['rank'], k['world_size']]), init(backend, **k))[1]; "
          "from codenerf_tpu_torch import train_cli; "
          "out = train_cli.main(sys.argv[1:]); "
          "print('result ' + json.dumps({'metrics': out, 'joined': joined, "
          "'still_joined': dist.is_initialized()}, default=float))")


@pytest.fixture(scope="module")
def srn_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("mh") / "synth_cars"
    subprocess.run([sys.executable, "tools/make_synth_data.py", "--out",
                    str(out), "--objects", "2", "--views", "3",
                    "--val-views", "2", "--size", "16"], check=True, cwd=ROOT,
                   capture_output=True)
    return out


def _argv(tree, logdir, run):
    return ["-c", str(SMOKE), "--device", "cpu", "--max-steps", "2",
            f"dataset.basedir={tree}", f"experiment.logdir={logdir}",
            f"experiment.id={run}", "experiment.print_every=1",
            "nerf.ray_sampler.num_random_rays=32",
            "nerf.point_sampler.num_coarse=4", "nerf.point_sampler.num_fine=4",
            "models.nerf_coarse.hidden_size=16",
            "models.nerf_fine.hidden_size=16",
            "models.embedding.shape_code_size=8",
            "models.embedding.texture_code_size=8"]


@pytest.mark.parametrize("gpus", [[], ["-g", "2"]])
def test_multihost_without_torchrun_raises(srn_tree, tmp_path, monkeypatch,
                                           gpus):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    spawned = []
    monkeypatch.setattr(launch, "spawn", lambda *a, **k: spawned.append(a))
    argv = _argv(srn_tree, tmp_path, "mh") + gpus + ["--multihost"]
    with pytest.raises(RuntimeError) as e:
        train_cli.main(argv)
    with pytest.raises(RuntimeError) as want:
        eval_cli.main(["-c", str(SMOKE), "--load-checkpoint", "x",
                       "--multihost", "--device", "cpu"])
    assert str(e.value) == str(want.value)
    assert "torchrun" in str(e.value) and not spawned
    assert not (tmp_path / "mh").exists()


def test_multihost_joins_a_one_rank_world_with_the_same_metrics(srn_tree,
                                                                 tmp_path):
    results = {}
    for run, flag in (("plain", []), ("multihost", ["--multihost"])):
        env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
        if flag:
            env.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(launch.free_port()))
        proc = subprocess.run(
            [sys.executable, "-c", RUNNER, *_argv(srn_tree, tmp_path, run),
             *flag], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        results[run] = json.loads(proc.stdout.splitlines()[-1][
            len("result "):])
    assert results["multihost"]["joined"] == [["gloo", 0, 1]]
    assert results["plain"]["joined"] == []
    assert not results["multihost"]["still_joined"]
    assert results["multihost"]["metrics"] == results["plain"]["metrics"]
    assert "loss_fine" in results["plain"]["metrics"]
