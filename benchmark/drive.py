"""Drives the port (``codenerf_tpu_torch``) through one cell.

One run: set-up builds the program's objects from the configuration,
loads the benchmark's weights into them and drives them from the seed
through the first ``check_steps`` steps, which go through the window's
own call and feed (``Program.step``); the same objects then run the
measured window (or, with ``--trace 1``, a traced slice).  After the
window the program's readings are taken, its state is freed and the
plain reference (``reference/steps.py``) follows the first steps from
the same weights, data and draws; ``compare.py`` judges the gaps.

Train cells drive ``train/step.py::make_train_step`` fed by
``data/loader.py::PrefetchIterator``; TTO cells drive
``eval/tto.py::make_batched_tto_step``.  One process drives one card.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import subprocess
import sys
import time

import torch

from benchmark import cells, compare, faults, profiling, workload
from benchmark.reference import steps as reference

FORBIDDEN = ("jax", "jaxlib", "flax", "codenerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``codenerf_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port's objects for one seed, fed and stepped as the window
    steps them.  ``step()`` makes one step and returns its loss tensor
    ([] for training, [K] for TTO) without waiting for the device."""

    def __init__(self, cell: dict, sp: dict, seed: int, device):
        from codenerf_tpu_torch.config import config_from_dict
        from codenerf_tpu_torch.core.geometry import pixel_directions
        from codenerf_tpu_torch.pipeline import RenderSettings
        from codenerf_tpu_torch.train.state import init_train_state

        self.sp, self.device = sp, device
        self.kind = sp["kind"]
        cfg = config_from_dict(workload.config_dict(cell))
        settings = RenderSettings.from_config(cfg)
        wts = workload.weights(sp, seed, device)
        state = init_train_state(cfg, settings, sp["num_objects"], 0,
                                 device=device)
        with torch.no_grad():
            for net in ("coarse", "fine"):
                for name, p in state.models[net].named_parameters():
                    p.copy_(wts[net][name])
            if state.tables is not None:
                for name, p in state.tables.named_parameters():
                    p.copy_(wts["tables"][name])
        self.state = state
        self.pool = workload.pool(sp, seed + 1, device)
        self.draws = workload.Draws(sp, seed + 2, device)
        intrinsic = torch.eye(4, device=device)
        intrinsic[0, 0] = intrinsic[1, 1] = sp["focal"]
        intrinsic[0, 2], intrinsic[1, 2] = sp["width"] / 2, sp["height"] / 2
        self.dirs = pixel_directions(sp["height"], sp["width"], intrinsic)
        self.loader_wait_s = 0.0
        self.batches = []           # the views of each recorded step
        self.record = True
        if self.kind == "train":
            self._init_train(cfg, settings, seed)
        else:
            self._init_tto(cfg, settings)

    def _init_train(self, cfg, settings, seed):
        from codenerf_tpu_torch.data.loader import PrefetchIterator
        from codenerf_tpu_torch.train.step import make_train_step
        sp = self.sp
        self.fn = make_train_step(
            settings, self.state, sp["rays"],
            cfg.experiment.regularizer_lambda,
            cfg.nerf.point_sampler.perturb, cfg.runtime.ray_chunks)
        self.start = {k: v.detach().clone() for k, v in self.leaves().items()}
        feed = workload.Feed(workload.host_pool(self.pool), sp["batch"],
                             seed + 3)
        self.loader = PrefetchIterator(feed, sp["prefetch_depth"],
                                       device=self.device)

    def _init_tto(self, cfg, settings):
        from codenerf_tpu_torch.eval.tto import (init_batched_tto_state,
                                                 make_batched_tto_step)
        sp = self.sp
        K = sp["objects"]
        self.tto, opt = init_batched_tto_state(
            self.state.tables, cfg.optimizer, K, device=self.device)
        self.fn = make_batched_tto_step(
            settings, opt, sp["rays"], cfg.experiment.regularizer_lambda,
            cfg.nerf.point_sampler.perturb, device=self.device)
        self.targets = self.pool["color"][:K]
        self.poses_gt = self.pool["pose"][:K]
        self.start = {k: v.detach().clone() for k, v in self.leaves().items()}
        self.loader = None

    def leaves(self) -> dict:
        """{name: tensor} of what the optimizer updates."""
        if self.kind == "tto":
            return dict(self.tto.variables)
        return {f"{prefix}.{n}": p
                for prefix, m in self.state.modules().items()
                for n, p in m.named_parameters()}

    def optimizer(self):
        return self.tto.optimizer if self.kind == "tto" else \
            self.state.optimizer

    def step(self):
        if self.kind == "tto":
            d = self.draws.rays(self.sp["objects"], self.sp["rays"])
            self.tto, m = self.fn(self.tto, self.state.models, self.dirs,
                                  self.targets, self.poses_gt, None,
                                  inds=d["inds"], draws=d["draws"])
            return m.loss
        t0 = time.monotonic()
        batch = next(self.loader)
        self.loader_wait_s += time.monotonic() - t0
        if self.record:
            self.batches.append(batch["idx"])
        d = self.draws.rays(self.sp["batch"], self.sp["rays"])
        m = self.fn(self.dirs, batch["pose"], batch["color"],
                    batch["object_id"], None, inds=d["inds"],
                    draws=workload.chunked(d["draws"], self.sp["chunks"]))
        return m.loss

    def first_steps(self, n: int) -> dict:
        """The first ``n`` steps, with what the check compares: each
        step's loss, the first step's gradient as Adam holds it after one
        step (its first moment over 1 - beta1; its norms and, flattened,
        the gradient itself) and every leaf's change after the n steps
        (norms), on the device."""
        losses, grad_vec = [], None
        for k in range(n):
            losses.append(self.step().detach().reshape(-1))
            if k == 0:
                opt = self.optimizer()
                b1 = opt.param_groups[0]["betas"][0]
                grad_vec = {name: (opt.state[p]["exp_avg"] / (1 - b1)
                                   if p in opt.state
                                   else torch.zeros_like(p)).flatten()
                            for name, p in self.leaves().items()}
        grad = {k: torch.linalg.norm(v) for k, v in grad_vec.items()}
        change = {k: torch.linalg.norm(v.detach() - self.start[k])
                  for k, v in self.leaves().items()}
        self.record = False
        return {"loss": losses, "grad": grad, "grad_vec": grad_vec,
                "change": change}

    def close(self) -> None:
        if self.loader is not None:
            self.loader.close()


def to_host(readings: dict) -> dict:
    return {"loss": [float(x) for t in readings["loss"] for x in t.cpu()],
            "grad": {k: float(v) for k, v in readings["grad"].items()},
            "grad_vec": {k: v.detach().float().cpu()
                         for k, v in readings["grad_vec"].items()},
            "change": {k: float(v) for k, v in readings["change"].items()}}


def reference_inputs(sp: dict, seed: int, idx: list, device) -> tuple:
    """(weights, inputs) the reference follows, made again from the seed:
    the weights, and per step the batch's views (train) or the targets
    (TTO) with the same ray indices and draws."""
    wts = workload.weights(sp, seed, device)
    pool = workload.pool(sp, seed + 1, device)
    draws = workload.Draws(sp, seed + 2, device)
    if sp["kind"] == "tto":
        steps = [draws.rays(sp["objects"], sp["rays"]) for _ in range(
            sp["check_steps"])]
        return wts, {"targets": pool["color"][:sp["objects"]],
                     "steps": steps}
    batches = []
    for views in idx:
        v = torch.as_tensor(views, device=device)
        b = {k: pool[k][v] for k in ("pose", "color", "object_id")}
        b.update(draws.rays(sp["batch"], sp["rays"]))
        batches.append(b)
    return wts, {"batches": batches}


def reference_readings(sp: dict, wts: dict, inputs: dict, device,
                       prec: str = "f32") -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rs = dict(sp, device=device)
    if sp["kind"] == "tto":
        codes = (wts["tables"]["shape_embedding.weight"].mean(0),
                 wts["tables"]["texture_embedding.weight"].mean(0))
        nets = {k: wts[k] for k in ("coarse", "fine")}
        return reference.tto_steps(rs, nets, codes, inputs["targets"],
                                   inputs["steps"], prec)
    return reference.train_steps(rs, wts, inputs["batches"], prec)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def window(prog: Program, seconds: float, device) -> dict:
    """The measured window: steps until ``seconds`` have passed on the
    host, then one synchronisation.  Returns the steps, the wall time,
    the gaps between consecutive step completions (CUDA events recorded
    on the step's stream after each step) and the losses' finiteness."""
    cuda = device.type == "cuda"
    _sync(device)
    t0 = time.monotonic()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    events, host_done, losses = [], [], []
    while True:
        losses.append(prog.step().detach().reshape(-1))
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        else:
            host_done.append(time.monotonic())
        if time.monotonic() - t0 >= seconds:
            break
    _sync(device)
    wall = time.monotonic() - t0
    if cuda:
        marks = [start] + events
        gaps = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks = [t0] + host_done
        gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    finite = torch.isfinite(torch.cat(losses)).reshape(len(losses), -1)
    return {"steps": len(losses), "wall_s": wall, "gaps_ms": gaps,
            "failed": int((~finite.all(dim=1)).sum())}


def p95(values: list) -> float:
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def end_to_end(sp: dict, win: dict, setup_s: float) -> dict:
    """Every end-to-end value this cell's window gives, by metric name."""
    out = {"setup_s": setup_s, "step_ms_p95": p95(win["gaps_ms"])}
    if sp["kind"] == "train":
        out["train_rays_per_s"] = (win["steps"] * sp["batch"] * sp["rays"]
                                   / win["wall_s"])
    else:
        out["tto_object_steps_per_s"] = (win["steps"] * sp["objects"]
                                         / win["wall_s"])
    return out


@dataclasses.dataclass
class Readings:
    """What a per-layer metric's reader reads: the traced slice's steps,
    wall and busy seconds, kernel seconds by name, the loader's wait and
    the step's shapes (``workload.shapes``)."""
    kind: str
    shapes: dict
    steps: int
    window_s: float
    busy_s: float
    kernel_s: dict
    loader_wait_s: float

    def kernel_time(self, names) -> float:
        """Device seconds per step of the kernels whose names hold one of
        ``names``."""
        return sum(v for k, v in self.kernel_s.items()
                   if any(n in k for n in names)) / self.steps


def run_seeds(cell: dict, seeds: list, seconds, trace: bool,
              launched: float, fault=None) -> list:
    """A run of ``cell`` for each seed, in this process: set-up and the
    checked first steps, then the window (``seconds`` None: none) or the
    traced slice, then the reference.  ``fault`` plants one of
    ``faults.FAULTS`` in the port for the whole run."""
    return [_run(cell, s, seconds, trace, launched, fault) for s in seeds]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             launched: float) -> dict:
    return _run(cell, seed, seconds, trace, launched, None)


def _device(cell):
    device = torch.device(cell.get("device", "cuda:0"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _run(cell, seed, seconds, trace, launched, fault) -> dict:
    device = _device(cell)
    sp = workload.spec(cell)
    with faults.planted(fault):
        phases = {"imports": time.monotonic() - launched}
        prog = Program(cell, sp, seed, device)
        phases["program"] = time.monotonic() - launched
        first = prog.first_steps(sp["check_steps"])
        idx = list(prog.batches)
        _sync(device)
        setup_s = phases["first_steps"] = time.monotonic() - launched
        tr = win = None
        if trace and device.type == "cuda":
            prog.loader_wait_s = 0.0
            tr = profiling.traced(prog.step, 2,
                                  cell["traffic_file"]["trace_seconds"],
                                  device)
            loader_wait = prog.loader_wait_s
        elif not trace and seconds is not None:
            win = window(prog, seconds, device)
        _sync(device)
        prog_readings = to_host(first)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        prog.close()
        del prog, first
    free(device)
    out = {"peak": peak, "setup_phases": phases,
           "attempted": win["steps"] if win else tr["steps"] if tr else 0,
           "failed": win["failed"] if win else 0}
    if win is not None:
        out["end_to_end"] = end_to_end(sp, win, setup_s)
    if tr is not None:
        out["traced"] = Readings(sp["kind"], workload.shapes(sp), tr["steps"],
                                 tr["window_s"], tr["busy_s"],
                                 tr["kernel_s"], loader_wait)
        out.update(busy_s=tr["busy_s"], window_s=tr["window_s"],
                   breakdown=tr["breakdown"])
    wts, inputs = reference_inputs(sp, seed, idx, device)
    ref = reference_readings(sp, wts, inputs, device)
    out["numbers"] = compare.numbers(prog_readings, ref)
    out["readings"] = {"program": prog_readings, "reference": ref}
    out["device_name"] = (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")
    return out


def control_numbers(cell: dict, seed: int, prec: str = "fp8") -> tuple:
    """The control's numbers: the reference in ``prec`` put in the
    program's place, against the reference, and both readings."""
    device = _device(cell)
    sp = workload.spec(cell)
    idx = []
    if sp["kind"] == "train":
        pool = workload.host_pool(workload.pool(sp, seed + 1, device))
        feed = workload.Feed(pool, sp["batch"], seed + 3)
        idx = [next(feed)["idx"] for _ in range(sp["check_steps"])]
    wts, inputs = reference_inputs(sp, seed, idx, device)
    ref = reference_readings(sp, wts, inputs, device)
    low = reference_readings(sp, wts, inputs, device, prec)
    free(device)
    return compare.numbers(low, ref), {"control": low, "reference": ref}


def result(cell: dict, run: dict, trace: bool) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, the
    cell's metrics, ``device``, with ``--trace 1`` the breakdown, and last
    the check: each number compared beside its limit."""
    correct, check = compare.judge(run["numbers"], cell["limits"])
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = cells.reader(cell, m["name"])(run["traced"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": run["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run["device_name"],
              "count": cell["chips"], "memory_peak_bytes": run["peak"]}
    out = {"correct": correct, "attempted": run["attempted"],
           "failed": run["failed"], "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=run["busy_s"], window_s=run["window_s"])
        out["breakdown"] = run["breakdown"]
    out["check"] = check
    return out
