"""The benchmark's definition, read by name: ``BENCHMARK.json`` at the
root of the checkout, each configuration's file, each traffic mix under
``traffic/<name>.json``, each cell's correctness limits under
``limits/<cell>.json`` and each per-layer metric's reader under
``metrics/<metric>.py``.  Adding a cell, a configuration, a traffic mix
or a metric means adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load(root: Path = ROOT) -> dict:
    """BENCHMARK.json as a dict, with ``root`` (where its paths start) and
    ``dir``, the benchmark's folder (its first path)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["root"] = str(root)
    bench["dir"] = str(root / bench["paths"][0])
    return bench


def cell(bench: dict, name: str) -> dict:
    """The workload ``name``, joined with its configuration file, its
    traffic file and its limits, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = dict(cells[name])
    root, here = Path(bench["root"]), Path(bench["dir"])
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    w["config_file"] = json.loads((root / cfg["file"]).read_text())
    w["traffic_file"] = json.loads(
        (here / "traffic" / f"{w['traffic']}.json").read_text())
    limits = here / "limits" / f"{name}.json"
    w["limits"] = json.loads(limits.read_text()) if limits.exists() else {}
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])]
    reported = {m["name"] for m in w["end_to_end"]}
    w["per_layer"] = [m for m in bench["per_layer"]
                      if name in m.get("workloads", [name])
                      and m["moves"] in reported]
    w["dir"] = str(here)
    return w


def reader(cell: dict, metric: str):
    """The ``read(readings)`` function of ``metrics/<metric>.py`` in the
    cell's benchmark folder."""
    path = Path(cell["dir"]) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
