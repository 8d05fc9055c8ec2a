"""The harness against its contract: names and units, every file found
by name, every per-layer metric's end-to-end metric reported where it
is read, the share of four-card cells, a cell added from new files
alone, and a run without a card that fails without a result."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import cells, compare, drive
from benchmark.tests.conftest import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load(ROOT)


def test_names_and_units(bench):
    named = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
             + bench["per_layer"])
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = cells.cell(bench, w["name"])
        assert cell["config_file"]["config"]
        assert cell["traffic_file"]["kind"] in ("train", "tto")
        assert cell["limits"] and set(cell["limits"]) <= set(compare.NAMES)
        for m in cell["per_layer"]:
            assert callable(cells.reader(cell, m["name"]))


def test_moves_is_reported_where_read(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", names):
            assert w in target.get("workloads", names), (m["name"], w)
    for w in names:
        reported = [m for m in bench["end_to_end"]
                    if w in m.get("workloads", names)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(w in m.get("workloads", names) for m in bench["per_layer"])


def test_four_card_cells_are_few(bench):
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert all(w["chips"] in (1, 4) for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def test_a_cell_from_new_files_alone(tmp_path, bench):
    """A configuration, a traffic mix, a cell, its limits and a per-layer
    metric added as new files and entries: the harness finds and runs
    them, and edits nothing."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    new = json.loads((ROOT / "BENCHMARK.json").read_text())
    tiny = tiny_cell("cars-train")
    (root / "benchmark/configs/tiny-cars.json").write_text(
        json.dumps(tiny["config_file"]))
    (root / "benchmark/traffic/train_two.json").write_text(json.dumps(
        dict(tiny["traffic_file"], overrides={
            "dataset.train_batch_size": 2})))
    (root / "benchmark/limits/tiny-cars.two.json").write_text(
        json.dumps(tiny["limits"]))
    (root / "benchmark/metrics/traced_steps.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    new["configs"].append({"name": "tiny-cars", "source": "a test",
                           "file": "benchmark/configs/tiny-cars.json",
                           "reduced": [], "why": "a test"})
    new["workloads"].append({"name": "tiny-cars.two", "config": "tiny-cars",
                             "traffic": "train_two", "chips": 1,
                             "why": "a test"})
    for m in new["end_to_end"]:
        if "workloads" in m and "cars-train" in m["workloads"]:
            m["workloads"].append("tiny-cars.two")
    new["per_layer"].append({"name": "traced_steps", "unit": "steps",
                             "better": "higher", "source": "program_counter",
                             "layer": "train step",
                             "moves": "train_rays_per_s",
                             "workloads": ["tiny-cars.two"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = cells.cell(cells.load(root), "tiny-cars.two")
    cell["device"] = "cpu"
    assert [m["name"] for m in cell["per_layer"]] == ["traced_steps"]
    assert cells.reader(cell, "traced_steps")(
        type("R", (), {"steps": 3})()) == 3.0
    run = drive.run_cell(cell, 5, 0.2, False, time.monotonic())
    out = drive.result(cell, run, False)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"setup_s", "train_rays_per_s",
                                   "step_ms_p95"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in out["metrics"].values())
    assert list(out)[-1] == "check"
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cars-tto",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "CUDA card" in proc.stderr


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cars-tto",
         "--seed", str(2**31 + 6), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert out["device"]["count"] == 1 and out["attempted"] > 0
