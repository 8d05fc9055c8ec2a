"""Coarse-versus-fine quality of a checkpoint on one TRAIN view (the port's
counterpart of ``tools/diag_fine.py``).

Renders a known training view from its ground-truth pose with that
object's learned codes (no TTO) and prints the coarse and fine PSNR, the
coarse and fine mean accumulated opacity, and the fine depth and rgb
statistics; ``--out PREFIX`` also writes ``PREFIX_{coarse,fine,target}.png``
through ``data/png.py::write_png``.  The rays go through
``pipeline.render_rays`` in 4096-ray chunks with the config's runtime
flags (K1 under ``runtime.use_pallas``).

    python3 -m codenerf_tpu_torch.tools.diag_fine -c configs/srn-cars-code.yml \\
        --load-checkpoint DIR_OR_CKPT [--view 0] [--out diag] \\
        [--device cpu] dataset.basedir=...
"""

import argparse

from codenerf_tpu_torch.tools._common import checkpoint_args, restore

CHUNK = 4096


def render_view(models, settings, directions, pose, z_s, z_t):
    """(coarse rgb, fine rgb, coarse acc, fine acc, fine depth) of every
    pixel, numpy f32, from ``pose`` with codes [1, C] (None for a vanilla
    model), in ``CHUNK``-ray chunks."""
    import numpy as np
    import torch

    from codenerf_tpu_torch.core.geometry import ray_bundle
    from codenerf_tpu_torch.pipeline import render_rays

    ro, rd = ray_bundle(directions, pose[None])
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    parts = []
    for i in range(0, ro.shape[0], CHUNK):
        n = min(CHUNK, ro.shape[0] - i)
        zs = None if z_s is None else z_s.expand(n, -1)
        zt = None if z_t is None else z_t.expand(n, -1)
        out_c, out_f = render_rays(models, settings, ro[i:i + n],
                                   rd[i:i + n], zs, zt)
        parts.append([x.float().cpu().numpy() for x in (
            out_c.rgb, out_f.rgb, out_c.acc, out_f.acc, out_f.depth)])
    return tuple(np.concatenate(p) for p in zip(*parts))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    checkpoint_args(ap)
    ap.add_argument("--view", type=int, default=0,
                    help="train dataset index to render")
    ap.add_argument("--out", default="", help="optional PNG prefix")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from codenerf_tpu_torch.data.png import write_png
    from codenerf_tpu_torch.models.codes import lookup_codes

    cfg, harness, state = restore(args)
    print(f"Restored step {state.step}")
    dev = harness.device
    sample = harness.train_dataset[args.view]
    target = sample["color"][..., :3]                    # [H, W, 3]
    H, W = target.shape[:2]
    obj = int(sample.get("object_id", 0))
    z_s = z_t = None
    if harness.has_codes:
        z_s, z_t = (z.detach() for z in lookup_codes(
            state.tables, torch.tensor([obj], device=dev)))
    pose = torch.from_numpy(sample["pose"]).to(dev)
    rgb_c, rgb_f, acc_c, acc_f, dep_f = render_view(
        state.models, harness.settings, harness.directions, pose, z_s, z_t)
    rgb_c, rgb_f = rgb_c.reshape(H, W, 3), rgb_f.reshape(H, W, 3)

    def psnr(a, b):
        return float(-10.0 * np.log10(np.mean((a - b) ** 2)))

    out = {"step": state.step, "view": args.view, "object": obj,
           "psnr_coarse": psnr(rgb_c, target),
           "psnr_fine": psnr(rgb_f, target),
           "acc_coarse_mean": float(acc_c.mean()),
           "acc_fine_mean": float(acc_f.mean()),
           "depth_fine": [float(dep_f.min()), float(dep_f.mean()),
                          float(dep_f.max())],
           "rgb_fine": [float(rgb_f.min()), float(rgb_f.mean()),
                        float(rgb_f.max())],
           "target_mean": float(target.mean())}
    print(f"view {args.view} object {obj}  H={H} W={W}")
    print(f"coarse PSNR {out['psnr_coarse']:7.3f}   "
          f"fine PSNR {out['psnr_fine']:7.3f}")
    print(f"acc  coarse mean {out['acc_coarse_mean']:.4f}  "
          f"fine mean {out['acc_fine_mean']:.4f}")
    print("fine depth min/mean/max {:.3f} {:.3f} {:.3f}".format(
        *out["depth_fine"]))
    print("fine rgb min/mean/max {:.3f} {:.3f} {:.3f}  target mean "
          "{:.3f}".format(*out["rgb_fine"], out["target_mean"]))
    if args.out:
        for tag, im in (("coarse", rgb_c), ("fine", rgb_f),
                        ("target", target)):
            write_png(f"{args.out}_{tag}.png",
                      (np.clip(im, 0, 1) * 255).astype(np.uint8))
        print(f"wrote {args.out}_{{coarse,fine,target}}.png")
    return out


if __name__ == "__main__":
    main()
