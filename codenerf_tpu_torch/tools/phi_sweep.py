"""Azimuth sweep of the TTO photometric loss: tells a pose residual that
is an object symmetry from a mislocalization (the port's counterpart of
``tools/phi_sweep.py``).

  1. the category protocol's single-view TTO (``harness.validate_batched``
     with the multi-start probe and the flip rescue of the config) on the
     chosen val objects, keeping the recovered codes and cameras;
  2. the camera azimuth phi swept over the full circle at the RECOVERED
     elevation and radius, each grid point a full image through
     ``eval/render.py::make_image_renderer`` (K1 under
     ``runtime.use_pallas``) against the target view;
  3. the profile's circular local minima, the loss at the recovered and at
     the ground-truth azimuth, and their ratio: below 1.15 the recovered
     basin ties or beats the GT basin (a symmetry, not a mislocalization),
     above 1.5 the GT basin is deeper and TTO missed it.

Reference anchor: eval.py:161-162 (the SE(3)-log pose metric).

    python3 -m codenerf_tpu_torch.tools.phi_sweep -c configs/srn-cars-code.yml \\
        --load-checkpoint CKPT --objects 2 5 --sweep 144 [--device cpu] \\
        dataset.basedir=... optimizer.pose_restarts=8 \\
        optimizer.pose_flip_steps=300 runtime.use_pallas=true \\
        runtime.pallas_backward=true
"""

import argparse
import json
import math

import numpy as np

from codenerf_tpu_torch.tools._common import checkpoint_args, restore

TIE = 1.15              # rec / GT loss below: not a mislocalization
MISLOCALIZED = 1.5      # rec / GT loss above: TTO missed a deeper basin


def azimuth_losses(render, models, directions, target, z_s, z_t, theta,
                   rho, phis) -> np.ndarray:
    """The image MSE against ``target`` [H, W, C] at each azimuth of
    ``phis``, at elevation ``theta`` and radius ``rho``, of
    ``render(models, directions, pose, z_s, z_t)`` (codes [1, C])."""
    from codenerf_tpu_torch.core.geometry import pose_spherical
    dev = directions.device
    tflat = target.reshape(-1, target.shape[-1])[..., :3].to(dev)
    losses = []
    for phi in phis:
        pose = pose_spherical(float(theta), float(phi), float(rho),
                              device=dev)
        rgb = render(models, directions, pose, z_s, z_t)
        losses.append(float(((rgb - tflat) ** 2).mean()))
    return np.asarray(losses)


def basin_report(phis, losses, loss_rec: float, loss_gt: float) -> dict:
    """The profile's circular local minima and their spacing, and the
    recovered-to-GT loss ratio with its verdict."""
    lo, hi = np.roll(losses, 1), np.roll(losses, -1)
    minima = np.where((losses < lo) & (losses <= hi))[0]
    spacing = (np.sort(np.diff(np.sort(phis[minima])))
               if len(minima) > 1 else np.array([]))
    ratio = loss_rec / max(loss_gt, 1e-12)
    if ratio < TIE:
        verdict = "NOT MISLOCALIZATION"
    elif ratio > MISLOCALIZED:
        verdict = "MISLOCALIZATION"
    else:
        verdict = "ambiguous"
    return {"minima": phis[minima], "spacing": spacing, "ratio": ratio,
            "verdict": verdict}


VERDICT_NOTES = {
    "NOT MISLOCALIZATION": "recovered basin ties or dominates the GT basin "
                           "— no deeper basin at the GT azimuth was missed",
    "MISLOCALIZATION": "GT basin is substantially deeper — TTO missed it",
    "ambiguous": "",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    checkpoint_args(ap)
    ap.add_argument("--objects", type=int, nargs="+", required=True,
                    help="val-object indices (the category-eval table's "
                         "object column)")
    ap.add_argument("--sweep", type=int, default=144,
                    help="number of azimuth grid points over [-pi, pi)")
    args = ap.parse_args(argv)

    import torch

    from codenerf_tpu_torch.core.metrics import mse2psnr
    from codenerf_tpu_torch.eval.render import make_image_renderer
    from codenerf_tpu_torch.harness import (_distinct_val_objects,
                                            validate_batched)
    from codenerf_tpu_torch.utils.logging import MetricLogger

    cfg, harness, state = restore(args)
    print(f"Restored checkpoint at step {state.step}")
    logger = MetricLogger(harness.logdir, enable_tensorboard=False)
    # the category-eval table indexes objects in _distinct_val_objects order
    distinct = _distinct_val_objects(harness)
    samples = [distinct[i] for i in args.objects]
    params = {**state.models, "codes": state.tables}
    out = validate_batched(harness, params, logger, len(samples),
                           samples=samples, return_recovered=True)
    rec = out["recovered"]
    dev = harness.device
    render = make_image_renderer(harness.settings, harness.height,
                                 harness.width,
                                 chunksize=cfg.nerf.validation.chunksize,
                                 device=dev, world=harness.world)
    models = dict(state.models)
    phis = np.linspace(-math.pi, math.pi, args.sweep, endpoint=False)

    def psnr(loss):
        return float(mse2psnr(torch.tensor(loss)))

    results = []
    for oi, obj in enumerate(args.objects):
        theta_r, phi_r, rho_r = (float(rec[k][oi])
                                 for k in ("theta", "phi", "rho"))
        t = rec["poses_gt"][oi][:3, 3].astype(np.float64)
        rho_gt = float(np.linalg.norm(t))
        theta_gt = float(math.asin(np.clip(t[2] / rho_gt, -1.0, 1.0)))
        phi_gt = float(math.atan2(t[1], t[0]))
        target = torch.from_numpy(rec["targets"][oi])
        z_s = torch.from_numpy(rec["z_s"][oi:oi + 1]).to(dev)
        z_t = torch.from_numpy(rec["z_t"][oi:oi + 1]).to(dev)

        def losses_at(azimuths):
            return azimuth_losses(render, models, harness.directions,
                                  target, z_s, z_t, theta_r, rho_r,
                                  azimuths)

        losses = losses_at(phis)
        loss_rec, loss_gt = losses_at([phi_r, phi_gt])
        rep = basin_report(phis, losses, loss_rec, loss_gt)
        sep = abs((phi_r - phi_gt + math.pi) % (2 * math.pi) - math.pi)
        print(f"\n[PHI-SWEEP] object {obj}: recovered (theta={theta_r:.3f}, "
              f"phi={phi_r:.3f}, rho={rho_r:.3f}); GT (theta={theta_gt:.3f}, "
              f"phi={phi_gt:.3f}, rho={rho_gt:.3f})")
        print(f"  azimuth separation |phi_rec - phi_gt| = {sep:.3f} rad; "
              f"pose error {out['per_object'][oi]['pose_error']:.3f} rad")
        print(f"  grid: {args.sweep} points; local minima at phi = "
              f"{np.array2string(rep['minima'], precision=3)}")
        if len(rep["spacing"]):
            print(f"  minima spacing: "
                  f"{np.array2string(rep['spacing'], precision=3)} rad")
        print(f"  loss at recovered phi: {loss_rec:.6f} "
              f"(psnr {psnr(loss_rec):.2f})")
        print(f"  loss at GT phi:        {loss_gt:.6f} "
              f"(psnr {psnr(loss_gt):.2f})")
        note = VERDICT_NOTES[rep["verdict"]]
        print(f"  basin ratio rec/GT: {rep['ratio']:.3f} ({rep['verdict']}"
              f"{' (' + note + ')' if note else ''})")
        print("  profile: " + json.dumps(
            {"phi": [round(float(p), 4) for p in phis],
             "loss": [round(float(v), 6) for v in losses]}))
        results.append({"object": obj, "pose_error":
                        out["per_object"][oi]["pose_error"],
                        "separation": sep, "loss_rec": float(loss_rec),
                        "loss_gt": float(loss_gt), "losses": losses,
                        **rep})
    logger.close()
    return results


if __name__ == "__main__":
    main()
