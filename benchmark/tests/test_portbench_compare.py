"""The numbers that decide ``correct`` (``compare.py``) on made-up
readings."""

import torch

from benchmark import compare


def readings(grads: dict, changes: dict) -> dict:
    return {"loss": [1.0, 1.0],
            "grad": {k: float(torch.linalg.norm(v)) for k, v in grads.items()},
            "grad_vec": grads, "change": changes}


def test_an_error_across_the_gradient_shows_element_by_element():
    g = torch.Generator().manual_seed(7)
    ref = {"a": torch.randn(4096, generator=g),
           "b": torch.randn(64, generator=g)}
    noise = {k: 0.05 * v * torch.randn(v.shape, generator=g)
             for k, v in ref.items()}
    prog = {k: ref[k] + noise[k] for k in ref}
    change = {"a": 1.0, "b": 0.1}
    nums = compare.numbers(readings(prog, change), readings(ref, change))
    # a norm moves only to second order; the elements to first
    assert nums["grad_gap"] < 0.01
    assert 0.02 < nums["grad_leaf_gap"] < 0.06


def test_the_least_disturbed_leaf_is_read():
    g = torch.Generator().manual_seed(8)
    ref = {"a": torch.randn(512, generator=g),
           "b": torch.randn(512, generator=g)}
    prog = {"a": ref["a"] * (1 + 0.002 * torch.randn(512, generator=g)),
            "b": ref["b"] * (1 + 0.2 * torch.randn(512, generator=g))}
    change = {"a": 1.0, "b": 1.0}
    nums = compare.numbers(readings(prog, change), readings(ref, change))
    assert nums["grad_leaf_gap"] < 0.003


def test_the_whole_change_is_carried_by_the_large_leaves():
    grads = {"code": torch.ones(1024), "pose": torch.ones(4)}
    ref = readings(grads, {"code": 0.4, "pose": 0.02})
    prog = readings(grads, {"code": 0.4, "pose": 0.01})
    nums = compare.numbers(prog, ref)
    # the pose leaf's gap against the median leaf's change, 0.21
    assert abs(nums["change_gap"] - 0.01 / 0.21) < 1e-9
    assert nums["change_all_gap"] < 2e-3
    still = readings(grads, {"code": 0.0, "pose": 0.0})
    assert compare.numbers(still, ref)["change_all_gap"] == 1.0


def test_a_gradient_of_another_size_fails():
    ref = {"a": torch.ones(8)}
    prog = {"a": torch.ones(4)}
    nums = compare.numbers(readings(prog, {"a": 1.0}),
                           readings(ref, {"a": 1.0}))
    ok, _ = compare.judge(nums, {"grad_leaf_gap": 1.0})
    assert not ok
