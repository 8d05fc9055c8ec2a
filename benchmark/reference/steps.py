"""Plain float32 reference of the timed steps: a training step (ray
gather, render, losses, the code regularizer, Adam or AdamW) and a
batched test-time-optimisation (TTO) step of codes and spherical pose.

Each function takes what the benchmark made and handed to the program
too (initial weights, data, ray indices, random draws), never anything
the program made, and recomputes the steps in blocks of rays so that the
full batch fits.  It returns the readings the harness compares:

  * ``loss``: each step's loss (for TTO, each object's, step by step);
  * ``grad``: {leaf: norm of the first step's gradient};
  * ``grad_vec``: {leaf: the first step's gradient, flattened, on the
    host};
  * ``change``: {leaf: norm of the change of the leaf after all steps}.

Leaves carry the program's names: ``coarse.<layer>.weight``,
``tables.shape_embedding.weight``; in TTO ``z_s``, ``z_t``, ``theta``,
``phi``, ``rho``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import nerf


class Adam:
    """torch's Adam / AdamW update, written out: decoupled weight decay
    ``p *= 1 - lr wd``, moments with betas (0.9, 0.999), eps 1e-8 added
    to the bias-corrected root."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, leaves: dict, weight_decay: float):
        self.leaves = leaves
        self.wd = weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, lrs: dict) -> None:
        self.t += 1
        bc1 = 1 - self.B1 ** self.t
        bc2 = 1 - self.B2 ** self.t
        for k, p in self.leaves.items():
            g, lr = p.grad, lrs[k]
            if self.wd:
                p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.B1).add_(g, alpha=1 - self.B1)
            self.v[k].mul_(self.B2).addcmul_(g, g, value=1 - self.B2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + self.EPS
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)


def _model(spec: dict, params: dict, prec: str):
    """``model(net, xyz_enc, dir_enc)`` over the per-ray codes bound by
    ``codes`` (CodeNeRF) or none (vanilla)."""
    state = {}

    def model(net, xyz_enc, dir_enc):
        p = params[net]
        if spec["model"] == "codenerf":
            return nerf.codenerf(p, xyz_enc, dir_enc, state["z_s"],
                                 state["z_t"], prec)
        return nerf.flexible(p, xyz_enc, dir_enc, spec["skips"],
                             spec["num_layers"], prec)

    def bind(z_s=None, z_t=None):
        state.update(z_s=z_s, z_t=z_t)
    return model, bind


def _render(spec, model, ro, rd, draws):
    return nerf.render(model, ro, rd, draws, spec["near"], spec["far"],
                       spec["num_coarse"], spec["noise_std"], spec["bands"],
                       spec["dir_bands"])


def _leaves(params: dict) -> dict:
    return {f"{net}.{k}": v for net, p in params.items() for k, v in
            p.items()}


def _flat_grads(leaves: dict) -> dict:
    return {n: p.grad.detach().flatten().float().cpu()
            for n, p in leaves.items()}


def train_steps(spec: dict, params: dict, batches: list, prec: str = "f32",
                block: int = 2048) -> dict:
    """Readings of ``len(batches)`` training steps from ``params``
    ({"coarse", "fine"} and, for CodeNeRF, "tables": {"shape_embedding.
    weight", "texture_embedding.weight"}).  Each batch holds pose [B, 4, 4],
    color [B, H, W, 3], object_id [B], inds [B, n] and draws {key: [B*n,
    .]} for the global rays in image-major order."""
    params = {net: {k: v.detach().clone().requires_grad_()
                    for k, v in p.items()} for net, p in params.items()}
    leaves = _leaves(params)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = Adam(leaves, spec["weight_decay"])
    model, bind = _model(spec, params, prec)
    dirs = nerf.pixel_directions(spec["height"], spec["width"],
                                 spec["focal"], spec["device"])
    out = {"loss": [], "grad": None}
    for k, b in enumerate(batches):
        for p in leaves.values():
            p.grad = None
        ro, rd, target, ids = [], [], [], []
        for i in range(b["pose"].shape[0]):
            o, d = nerf.rays(dirs, b["pose"][i], b["inds"][i])
            ro.append(o)
            rd.append(d)
            target.append(b["color"][i].reshape(-1, 3)[b["inds"][i]])
            ids.append(b["object_id"][i].expand(len(b["inds"][i])))
        ro, rd, target, ids = (torch.cat(a) for a in (ro, rd, target, ids))
        R = ro.shape[0]
        sums = torch.zeros(2, device=ro.device)
        for lo in range(0, R, block):
            sl = slice(lo, lo + block)
            if "tables" in params:
                t = params["tables"]
                bind(t["shape_embedding.weight"][ids[sl]],
                     t["texture_embedding.weight"][ids[sl]])
            rgb_c, rgb_f = _render(spec, model, ro[sl], rd[sl],
                                   {n: v[sl] for n, v in b["draws"].items()})
            c = ((rgb_c - target[sl]) ** 2).sum()
            f = ((rgb_f - target[sl]) ** 2).sum()
            ((c + f) / (R * 3)).backward()
            sums += torch.stack([c.detach(), f.detach()])
        loss = sums.sum() / (R * 3)
        if "tables" in params and spec["regularizer"] > 0:
            t = params["tables"]
            reg = spec["regularizer"] * (
                torch.linalg.norm(t["shape_embedding.weight"])
                + torch.linalg.norm(t["texture_embedding.weight"]))
            reg.backward()
            loss = loss + reg.detach()
        out["loss"].append(float(loss))
        if k == 0:
            out["grad"] = {n: float(torch.linalg.norm(p.grad))
                           for n, p in leaves.items()}
            out["grad_vec"] = _flat_grads(leaves)
        decay = spec["gamma"] ** (k / spec["step_size"])
        opt.step({n: decay * (spec["embedding_lr"] if n.startswith("tables")
                              else spec["lr"]) for n in leaves})
    out["change"] = {n: float(torch.linalg.norm(p.detach() - start[n]))
                     for n, p in leaves.items()}
    return out


def tto_steps(spec: dict, params: dict, codes: tuple, targets, steps: list,
              prec: str = "f32", block: int = 2048) -> dict:
    """Readings of ``len(steps)`` batched TTO steps of K objects with the
    models ``params`` frozen: codes start at ``codes`` ([C] each, the
    tables' means), the pose at ``spec["pose_init"]``; ``targets``
    [K, H, W, 3]; each step holds inds [K, n] and draws {key: [K*n, .]}.
    ``loss`` lists every object's loss, step after step."""
    params = {net: {k: v.detach() for k, v in p.items()}
              for net, p in params.items()}
    K = targets.shape[0]
    dev = targets.device
    z_s, z_t = (c.detach().reshape(1, -1).repeat(K, 1) for c in codes)
    leaves = {"z_s": z_s, "z_t": z_t}
    for name, v in zip(("theta", "phi", "rho"), spec["pose_init"]):
        leaves[name] = torch.full((K,), float(v), device=dev)
    for v in leaves.values():
        v.requires_grad_()
    start = {k: v.detach().clone() for k, v in leaves.items()}
    opt = Adam(leaves, spec["weight_decay"])
    lrs = {"z_s": spec["val_lr"], "z_t": spec["val_lr"],
           "theta": spec["angle_lr"],
           "phi": spec["angle_lr"], "rho": spec["radius_lr"]}
    model, bind = _model(spec, params, prec)
    dirs = nerf.pixel_directions(spec["height"], spec["width"],
                                 spec["focal"], dev)
    out = {"loss": [], "grad": None}
    lam = spec["regularizer"]
    for k, st in enumerate(steps):
        for p in leaves.values():
            p.grad = None
        n = st["inds"].shape[1]
        losses = []
        for obj in range(K):
            target = targets[obj].reshape(-1, 3)[st["inds"][obj]]
            total = torch.zeros((), device=dev)
            for lo in range(0, n, block):
                sl = slice(lo, lo + block)
                gl = slice(obj * n + lo, obj * n + min(lo + block, n))
                # rebuilt for each block: every backward frees its graph
                pose = nerf.pose_spherical(leaves["theta"][obj],
                                           leaves["phi"][obj],
                                           leaves["rho"][obj])
                ro, rd = nerf.rays(dirs, pose, st["inds"][obj][sl])
                bind(leaves["z_s"][obj].expand(ro.shape[0], -1),
                     leaves["z_t"][obj].expand(ro.shape[0], -1))
                rgb_c, rgb_f = _render(spec, model, ro, rd,
                                       {m: v[gl] for m, v in
                                        st["draws"].items()})
                part = (((rgb_c - target[sl]) ** 2).sum()
                        + ((rgb_f - target[sl]) ** 2).sum()) / (n * 3)
                part.backward()
                total = total + part.detach()
            reg = lam * math.sqrt(n) * (torch.linalg.norm(leaves["z_s"][obj])
                                        + torch.linalg.norm(
                                            leaves["z_t"][obj]))
            reg.backward()
            losses.append(float(total + reg.detach()))
        out["loss"] += losses
        if k == 0:
            out["grad"] = {m: float(torch.linalg.norm(p.grad))
                           for m, p in leaves.items()}
            out["grad_vec"] = _flat_grads(leaves)
        opt.step(lrs)
    out["change"] = {m: float(torch.linalg.norm(p.detach() - start[m]))
                     for m, p in leaves.items()}
    return out
