"""``correct`` comes out false for the control and for every fault a
cell can have, planted underneath the timed path, with the harness's
look for a card skipped (CPU, small widths, the committed limits)."""

import time

import pytest

from benchmark import compare, drive
from benchmark.tests.conftest import tiny_cell

CASES = [(c, f) for c in ("cars-train", "lego-train", "cars-tto")
         for f in ("unchanged", "half", "altered")]


@pytest.mark.parametrize("name, fault", CASES)
def test_a_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    run = drive.run_seeds(cell, [2**31 + 21], 0.0, False, time.monotonic(),
                          fault)[0]
    correct, check = compare.judge(run["numbers"], cell["limits"])
    assert not correct, check


@pytest.mark.parametrize("name", ["cars-train", "lego-train", "cars-tto"])
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    nums, _ = drive.control_numbers(cell, 2**31 + 31)
    correct, check = compare.judge(nums, cell["limits"])
    assert not correct, check
