"""Render novel views of one object from a trained checkpoint (the port's
counterpart of ``tools/render_views.py``): turntable PNG sequences like
the reference's teaser (reference assets/teaser.png).

    python3 -m codenerf_tpu_torch.tools.render_views -c CONFIG.yml \\
        --load-checkpoint DIR_OR_CKPT --object-id 0 --num-views 8 \\
        --out views/ [--turntable] [--int8] [--device cpu] [overrides]

By default the camera sweeps the elevation theta over ``--theta-range``
at azimuth ``--phi``; ``--turntable`` sweeps the azimuth over 2 pi at the
mean of the range.  Each view is a full image through
``eval/render.py::make_image_renderer`` with the config's runtime flags
(``runtime.use_pallas=true`` serves through K1), or with ``--int8``
through the int8 serving path calibrated at the first view
(``harness.int8_render_params``), written by ``data/png.py::write_png``.
"""

import argparse

from codenerf_tpu_torch.tools._common import checkpoint_args, restore


def view_angles(theta_range, phi, num_views, turntable):
    """(theta, phi) of each view: an elevation arc at ``phi``, or with
    ``turntable`` the azimuth over [0, 2 pi) at the range's mean."""
    import numpy as np
    if turntable:
        theta_fix = 0.5 * (theta_range[0] + theta_range[1])
        return [(theta_fix, p) for p in np.linspace(
            0.0, 2.0 * np.pi, num_views, endpoint=False)]
    return [(t, phi) for t in np.linspace(theta_range[0], theta_range[1],
                                          num_views)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    checkpoint_args(ap)
    ap.add_argument("--object-id", type=int, default=0)
    ap.add_argument("--num-views", type=int, default=8)
    ap.add_argument("--theta-range", type=float, nargs=2, default=[1.0, 2.1])
    ap.add_argument("--phi", type=float, default=0.0)
    ap.add_argument("--turntable", action="store_true",
                    help="sweep the azimuth phi over 2 pi at elevation "
                         "theta = the mean of --theta-range (theta is the "
                         "elevation in the reference pose_spherical, "
                         "eval.py:22-38; the default theta sweep arcs over "
                         "the pole)")
    ap.add_argument("--rho", type=float, default=1.30)
    ap.add_argument("--out", required=True)
    ap.add_argument("--int8", action="store_true",
                    help="serve through the int8 quantized path "
                         "(models/quantized.py), calibrated on rays from "
                         "the first view")
    args = ap.parse_args(argv)

    from pathlib import Path

    import numpy as np
    import torch

    from codenerf_tpu_torch.core.geometry import pose_spherical
    from codenerf_tpu_torch.data.png import write_png
    from codenerf_tpu_torch.eval.render import make_image_renderer
    from codenerf_tpu_torch.harness import int8_render_params
    from codenerf_tpu_torch.models.codes import lookup_codes

    cfg, harness, state = restore(args)
    print(f"Restored step {state.step}")
    dev = harness.device
    render = make_image_renderer(harness.settings, harness.height,
                                 harness.width,
                                 chunksize=cfg.nerf.validation.chunksize,
                                 device=dev, world=harness.world)
    models = dict(state.models)
    z_s = z_t = None
    if harness.has_codes:
        z_s, z_t = (z.detach() for z in lookup_codes(
            state.tables, torch.tensor([args.object_id], device=dev)))

    angles = view_angles(args.theta_range, args.phi, args.num_views,
                         args.turntable)
    if args.int8:
        pose0 = pose_spherical(float(angles[0][0]), float(angles[0][1]),
                               args.rho, device=dev)
        models = int8_render_params(harness, models, pose0, z_s, z_t)
        print("serving through the int8 quantized path")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    images, rgbs = [], []
    for i, (theta, phi) in enumerate(angles):
        pose = pose_spherical(float(theta), float(phi), args.rho, device=dev)
        rgb = render(models, harness.directions, pose, z_s, z_t)
        img = np.clip(rgb.float().cpu().numpy().reshape(
            harness.height, harness.width, 3), 0, 1)
        u8 = (img * 255).astype(np.uint8)
        path = out_dir / f"view_{i:03d}.png"
        write_png(path, u8)
        images.append(u8)
        rgbs.append(img)
        print(f"wrote {path}")
    return {"step": state.step, "images": images, "rgb": rgbs}


if __name__ == "__main__":
    main()
