"""The general generator: one cell's configuration and traffic mix turned
into inputs made from the seed.

A configuration file holds the port's config as it is run (``config``)
and the sizes it assumes (``assumed``: code-table rows, camera, view
pool); a traffic file holds the mix: its ``kind`` ("train" or "tto"),
dotted config ``overrides`` (batch sizes), the loader's depth, the objects of a TTO group, the length of
the traced slice and the steps the correctness check follows.  From the
seed come the weights, the view pool, the loader's order and every ray
index and random draw; the same seed gives the same inputs.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from benchmark.reference import nerf

# the reference's TTO start (eval.py:129-131): elevation, azimuth, radius
POSE_INIT = (1.57, 0.0, 1.30)
# decoupled weight decay of the optimizers the reference implements
WEIGHT_DECAY = {"AdamW": 1e-2, "Adam": 0.0}


def config_dict(cell: dict) -> dict:
    """The port's config dict with the traffic's dotted overrides."""
    cfg = copy.deepcopy(cell["config_file"]["config"])
    for dotted, value in cell["traffic_file"].get("overrides", {}).items():
        *path, key = dotted.split(".")
        node = cfg
        for p in path:
            node = node[p]
        node[key] = value
    return cfg


def spec(cell: dict) -> dict:
    """Everything the program's driver, the reference and the cost
    functions need, read from the config dict (with the traffic's
    overrides), the configuration's assumptions and the traffic mix."""
    cfg = config_dict(cell)
    models, emb = cfg["models"], cfg["nerf"]["embedder"]
    ps, opt = cfg["nerf"]["point_sampler"], cfg["optimizer"]
    coarse, fine = models["nerf_coarse"], models["nerf_fine"]
    for key in ("type", "hidden_size", "num_layers", "skip_connect_ids"):
        if coarse[key] != fine[key]:
            raise ValueError(f"coarse and fine differ in {key}")
    if not (emb["include_input_xyz"] and emb["include_input_dir"]
            and emb["log_sampling_xyz"] and emb["log_sampling_dir"]
            and emb["use_viewdirs"] and ps["spacing_mode"] == "lindepth"
            and ps["perturb"] and not cfg["nerf"]["white_background"]):
        raise ValueError("the reference covers log-sampled encodings with "
                         "their inputs, view directions, lindepth spacing, "
                         "perturbed samples and a black background")
    if opt["type"] not in WEIGHT_DECAY:
        raise ValueError(f"the reference has no {opt['type']}")
    assumed = cell["config_file"]["assumed"]
    cam = assumed["camera"]
    codenerf = coarse["type"] == "CodeNeRFModel"
    traffic = cell["traffic_file"]
    val_lr = opt.get("val_lr", 5e-3)
    return {
        "model": "codenerf" if codenerf else "flexible",
        "h": coarse["hidden_size"], "num_layers": coarse["num_layers"],
        "skips": tuple(coarse["skip_connect_ids"]),
        "s": models["embedding"]["shape_code_size"],
        "t": models["embedding"]["texture_code_size"],
        "bands": emb["num_encoding_fn_xyz"],
        "dir_bands": emb["num_encoding_fn_dir"],
        "dim_xyz": 3 + 6 * emb["num_encoding_fn_xyz"],
        "dim_dir": 3 + 6 * emb["num_encoding_fn_dir"],
        "near": float(ps["near_limit"]), "far": float(ps["far_limit"]),
        "num_coarse": ps["num_coarse"], "num_fine": ps["num_fine"],
        "noise_std": float(cfg["nerf"]["train"]["radiance_field_noise_std"]),
        "height": cfg["dataset"]["image_size"],
        "width": cfg["dataset"]["image_size"],
        "focal": float(cam["focal"]), "radius": float(cam["radius"]),
        "elevation": tuple(cam["elevation"]),
        "num_objects": assumed.get("num_objects", 1) if codenerf else 1,
        "pool_views": assumed["pool_views"],
        "lr": float(opt["lr"]),
        "embedding_lr": float(opt["embedding_lr"] if opt.get("embedding_lr")
                              is not None else opt["lr"]),
        "weight_decay": WEIGHT_DECAY[opt["type"]],
        "gamma": float(opt["scheduler_gamma"]),
        "step_size": float(opt["scheduler_step_size"]),
        "val_lr": float(val_lr),
        "angle_lr": float(opt["angle_lr"] if opt.get("angle_lr") is not None
                          else val_lr),
        "radius_lr": float(opt["radius_lr"] if opt.get("radius_lr")
                           is not None else val_lr),
        "regularizer": float(cfg["experiment"]["regularizer_lambda"]),
        "batch": cfg["dataset"]["train_batch_size"],
        "rays": cfg["nerf"]["ray_sampler"]["num_random_rays"],
        "chunks": cfg["runtime"].get("ray_chunks", 1),
        "kind": traffic["kind"],
        "objects": traffic.get("objects", 0),
        "check_steps": traffic["check_steps"],
        "prefetch_depth": traffic.get("prefetch_depth", 2),
        "pose_init": POSE_INIT,
    }


def shapes(sp: dict) -> dict:
    """A step's shapes for the cost functions: rays per step, samples per
    pass, widths."""
    if sp["kind"] == "tto":
        rays = sp["objects"] * sp["rays"]
    else:
        rays = sp["batch"] * sp["rays"]
    return {"model": sp["model"], "rays": rays, "h": sp["h"], "s": sp["s"],
            "t": sp["t"], "F": sp["bands"], "dim_xyz": sp["dim_xyz"],
            "dim_dir": sp["dim_dir"], "num_layers": sp["num_layers"],
            "skips": sp["skips"], "chunks": sp["chunks"],
            "samples": [sp["num_coarse"], sp["num_coarse"] + sp["num_fine"]]}


def weights(sp: dict, seed: int, device) -> dict:
    """{"coarse", "fine"} parameter dicts under the reference's names, and
    for CodeNeRF "tables", made on ``device`` from ``seed``: the MLPs at
    ``nn.Linear``'s default init, the code tables N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if sp["model"] == "codenerf":
        layer_shapes = nerf.codenerf_shapes(sp["h"], sp["s"], sp["t"],
                                            sp["dim_xyz"], sp["dim_dir"])
    else:
        layer_shapes = nerf.flexible_shapes(sp["h"], sp["num_layers"],
                                            sp["skips"], sp["dim_xyz"],
                                            sp["dim_dir"])
    out = {net: nerf.init_params(layer_shapes, g, device)
           for net in ("coarse", "fine")}
    if sp["model"] == "codenerf":
        n, s = sp["num_objects"], sp["s"]
        z = torch.randn(n * (s + sp["t"]), generator=g, device=device)
        out["tables"] = {"shape_embedding.weight": z[:n * s].view(n, s),
                         "texture_embedding.weight": z[n * s:].view(n, -1)}
    return out


def pool(sp: dict, seed: int, device) -> dict:
    """The view pool on ``device``: color [V, H, W, 3] (an 8 x 8 random
    colour grid per view, bilinear to H x W), camera-to-world pose
    [V, 4, 4] on the upper sphere, object_id [V] uniform over the code
    tables' rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    V, H, W = sp["pool_views"], sp["height"], sp["width"]
    low = torch.rand(V, 3, 8, 8, generator=g, device=device)
    color = torch.nn.functional.interpolate(
        low, size=(H, W), mode="bilinear", align_corners=False)
    lo, hi = sp["elevation"]
    angles = torch.rand(2, V, generator=g, device=device)
    theta = lo + (hi - lo) * angles[0]
    phi = 2 * math.pi * angles[1]
    pose = nerf.pose_spherical(theta, phi, torch.full_like(theta,
                                                           sp["radius"]))
    ids = torch.randint(0, sp["num_objects"], (V,), generator=g,
                        device=device)
    return {"color": color.permute(0, 2, 3, 1).contiguous(), "pose": pose,
            "object_id": ids}


class Feed:
    """Host-side batches of ``batch`` views from the pool (numpy copies),
    in epochs of a seeded permutation, so the views of consecutive steps
    differ.  Each batch also carries ``idx``, the views it holds."""

    def __init__(self, pool_host: dict, batch: int, seed: int):
        self.pool = pool_host
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.order = np.empty(0, dtype=np.int64)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while self.order.size < self.batch:
            self.order = np.concatenate(
                [self.order, self.rng.permutation(len(self.pool["pose"]))])
        idx, self.order = self.order[:self.batch], self.order[self.batch:]
        out = {k: v[idx] for k, v in self.pool.items()}
        out["idx"] = idx
        return out


def host_pool(pool_dev: dict) -> dict:
    return {"pose": pool_dev["pose"].cpu().numpy(),
            "color": pool_dev["color"].cpu().numpy(),
            "object_id": pool_dev["object_id"].cpu().numpy()}


class Draws:
    """Every ray index and random draw of the steps, on the device, from
    one generator: a second ``Draws`` of the same seed replays them."""

    def __init__(self, sp: dict, seed: int, device):
        self.sp = sp
        self.g = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def _rand(self, *shape, normal=False):
        f = torch.randn if normal else torch.rand
        return f(*shape, generator=self.g, device=self.device)

    def rays(self, images: int, n: int) -> dict:
        """inds [images, n] (distinct pixels per image) and the render's
        draws for the images x n rays in image-major order: t_rand
        [R, Sc], u [R, Sf] and, with sigma noise, noise_c [R, Sc] and
        noise_f [R, Sc + Sf]."""
        sp = self.sp
        hw = sp["height"] * sp["width"]
        inds = self._rand(images, hw).argsort(dim=1)[:, :n]
        R, sc, sf = images * n, sp["num_coarse"], sp["num_fine"]
        noisy = sp["kind"] == "train" and sp["noise_std"] > 0
        draws = {"t_rand": self._rand(R, sc)}
        if noisy:
            draws["noise_c"] = self._rand(R, sc, normal=True)
        draws["u"] = self._rand(R, sf)
        if noisy:
            draws["noise_f"] = self._rand(R, sc + sf, normal=True)
        return {"inds": inds, "draws": draws}


def chunked(draws: dict, chunks: int) -> list:
    """The train step's per-chunk draws: a list of views of ``draws``."""
    R = next(iter(draws.values())).shape[0]
    rc = R // chunks
    return [{k: v[i * rc:(i + 1) * rc] for k, v in draws.items()}
            for i in range(chunks)]
