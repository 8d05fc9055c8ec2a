"""The benchmark's own tests (``python -m pytest benchmark/tests`` from
the checkout's root).  ``card`` marks a test that needs a CUDA card; it
decides inside the test whether there is one and skips without."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def tiny_cell(name: str, dtype: str = "float32") -> dict:
    """Cell ``name`` at a size a CPU test holds (hidden 16, codes 8,
    8 + 8 samples, 8x8 views, 32 rays an image), on the CPU, with the
    cell's committed limits; the program in ``dtype``."""
    from benchmark import cells
    c = copy.deepcopy(cells.cell(cells.load(), name))
    cfg = c["config_file"]["config"]
    for net in ("nerf_coarse", "nerf_fine"):
        cfg["models"][net]["hidden_size"] = 16
    cfg["models"]["embedding"].update(shape_code_size=8, texture_code_size=8)
    cfg["nerf"]["point_sampler"].update(num_coarse=8, num_fine=8)
    cfg["nerf"]["ray_sampler"]["num_random_rays"] = 32
    cfg["dataset"]["image_size"] = 8
    cfg["runtime"]["compute_dtype"] = dtype
    if cfg["runtime"].get("ray_chunks", 1) > 1:
        cfg["dataset"]["train_batch_size"] = 4
        cfg["runtime"]["ray_chunks"] = 4
    a = c["config_file"]["assumed"]
    a.update(num_objects=6, pool_views=16)
    a["camera"]["focal"] *= 8 / 128
    c["device"] = "cpu"
    return c
