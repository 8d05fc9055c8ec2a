"""Generate a synthetic SRN, Blender or LLFF dataset (the port's copy of
``tools/make_synth_data.py``, with the port's PNG writer in place of
imageio, which the card's machine lacks).

Objects are procedural multi-primitive SDF compositions ("cars": a
rounded-box body and cabin, four torus wheels, an optional spoiler;
"chairs": seat, tilted backrest, four legs, optional armrests) with
per-object procedural albedo and lighting, sphere-traced on the host in
numpy.  The same flags and seed give the same dataset as the JAX-era
tool: the same pixels (the PNG bytes differ only in their compression),
and byte-identical ``intrinsics.txt``, ``pose/*.txt``,
``transforms_*.json`` and ``poses_bounds.npy``.  Layouts (reference
view_synthesis/datasets/dataset.py:10-94 for SRN):

    <out>/<name>_<stage>/<obj>/{intrinsics.txt, rgb/*.png, pose/*.txt}

    python3 -m codenerf_tpu_torch.tools.make_synth_data \\
        --out data/synth_cars --objects 20 --views 50 --size 128
"""

import argparse
from pathlib import Path

import numpy as np

from codenerf_tpu_torch.data.png import write_png


def rotation_from_axis_angle(w):
    """Rodrigues formula; w is an axis-angle 3-vector."""
    th = np.linalg.norm(w)
    if th < 1e-9:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def jitter_pose(pose, rng, magnitude):
    """Apply a random rigid 6-DOF perturbation: rotation up to `magnitude`
    radians (including roll) and translation up to 0.4*magnitude world
    units — produces off-sphere, rolled cameras the spherical (theta, phi,
    rho) TTO parametrization cannot express (SE3-refinement test data)."""
    w = rng.normal(size=3)
    w = w / (np.linalg.norm(w) + 1e-12) * rng.uniform(0.3, 1.0) * magnitude
    t = rng.uniform(-0.4 * magnitude, 0.4 * magnitude, size=3)
    delta = np.eye(4)
    delta[:3, :3] = rotation_from_axis_angle(w)
    delta[:3, 3] = t
    return delta @ pose


def spherical_pose(theta, phi, rho):
    """Same parametrization as ``core/geometry.py::pose_spherical``."""
    st, ct, sp, cp = np.sin(theta), np.cos(theta), np.sin(phi), np.cos(phi)
    c2w = np.eye(4)
    c2w[0, 0], c2w[1, 0] = -sp, cp
    c2w[0, 1], c2w[1, 1], c2w[2, 1] = -st * cp, -st * sp, ct
    c2w[0, 2], c2w[1, 2], c2w[2, 2] = ct * cp, ct * sp, st
    c2w[0, 3], c2w[1, 3], c2w[2, 3] = rho * ct * cp, rho * ct * sp, rho * st
    return c2w


# ---------------------------------------------------------------------------
# SDF primitives, vectorized over points p: [N, 3]
# ---------------------------------------------------------------------------

def _norm(v):
    return np.sqrt(np.sum(v * v, axis=-1) + 1e-12)


def sd_sphere(p, center, r):
    return _norm(p - center) - r


def sd_round_box(p, center, half, round_r):
    q = np.abs(p - center) - half
    outside = _norm(np.maximum(q, 0.0))
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside - round_r


def sd_torus_y(p, center, R, r):
    """Torus whose axis is the object-frame y axis (a car wheel)."""
    q = p - center
    ring = np.sqrt(q[..., 0] ** 2 + q[..., 2] ** 2 + 1e-12) - R
    return np.sqrt(ring ** 2 + q[..., 1] ** 2 + 1e-12) - r


def sd_vcapsule(p, base, h, r):
    """Vertical (z-axis) capsule from base to base+h, radius r (a leg)."""
    q = p - base
    z = np.clip(q[..., 2], 0.0, h)
    d = np.stack([q[..., 0], q[..., 1], q[..., 2] - z], axis=-1)
    return _norm(d) - r


def smin(a, b, k=0.03):
    """Polynomial smooth min — blends body parts into one organic surface."""
    h = np.clip(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return b + (a - b) * h - k * h * (1.0 - h)


# ---------------------------------------------------------------------------
# Procedural textures: albedo(p [M,3]) -> [M,3]
# ---------------------------------------------------------------------------

def make_pattern(rng, c0, c1):
    """Random procedural pattern over object-space position."""
    kind = rng.choice(["solid", "stripes", "checker", "twotone", "rings"])
    freq = rng.uniform(18.0, 45.0)
    phase = rng.uniform(0.0, np.pi)
    axis = int(rng.integers(0, 3))
    split = rng.uniform(-0.03, 0.03)

    def albedo(p):
        if kind == "solid":
            return np.broadcast_to(c0, p.shape).copy()
        if kind == "stripes":
            s = 0.5 + 0.5 * np.sign(np.sin(freq * p[..., axis] + phase))
        elif kind == "checker":
            a, b = (axis, (axis + 1) % 3)
            s = 0.5 + 0.5 * np.sign(np.sin(freq * p[..., a] + phase)
                                    * np.sin(freq * p[..., b]))
        elif kind == "rings":
            s = 0.5 + 0.5 * np.sign(
                np.sin(freq * np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2
                                      + 1e-12) + phase))
        else:  # twotone
            s = (p[..., axis] > split).astype(np.float64)
        return c0 * (1.0 - s[..., None]) + c1 * s[..., None]

    return albedo


class ProcObject:
    """A procedural object: part SDFs + per-part albedo + lighting."""

    def __init__(self, parts, lighting):
        # parts: list of (sdf_fn, albedo_fn, smooth_group)
        self.parts = parts
        self.light_dir, self.ambient, self.ks, self.shininess, self.fill = \
            lighting

    def sdf(self, p):
        d = np.stack([part[0](p) for part in self.parts], axis=0)
        return np.min(d, axis=0)

    def sdf_parts(self, p):
        d = np.stack([part[0](p) for part in self.parts], axis=0)
        return np.min(d, axis=0), np.argmin(d, axis=0)

    def albedo(self, p, part_id):
        out = np.zeros_like(p)
        for i, (_, alb, _) in enumerate(self.parts):
            m = part_id == i
            if np.any(m):
                out[m] = alb(p[m])
        return out


def random_lighting(rng):
    az = rng.uniform(0.0, 2 * np.pi)
    el = rng.uniform(0.6, 1.2)
    ld = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                   np.sin(el)])
    ambient = rng.uniform(0.25, 0.45)
    ks = rng.uniform(0.05, 0.30)
    shininess = rng.uniform(8.0, 48.0)
    fill = rng.uniform(0.10, 0.25)
    return ld, ambient, ks, shininess, fill


def build_car(rng):
    """Body + cabin (smooth-blended) + 4 torus wheels + optional spoiler."""
    L = rng.uniform(0.26, 0.38)
    Wb = rng.uniform(0.11, 0.17)
    Hb = rng.uniform(0.055, 0.095)
    rb = rng.uniform(0.02, 0.045)
    cab_l = L * rng.uniform(0.35, 0.55)
    cab_h = rng.uniform(0.07, 0.12)
    cab_x = rng.uniform(-0.09, 0.03)
    cab_w = Wb * rng.uniform(0.70, 0.88)
    blend = rng.uniform(0.02, 0.06)
    # wheels sized to read as wheels at 128px (a 0.02-radius tube is ~2px)
    wheel_R = rng.uniform(0.075, 0.105)
    wheel_r = rng.uniform(0.030, 0.045)
    wx = L * rng.uniform(0.55, 0.72)
    body_z = 0.0
    wheel_z = body_z - Hb - 0.35 * wheel_R

    c_body = rng.uniform(0.15, 0.95, size=3)
    c_alt = rng.uniform(0.15, 0.95, size=3)
    body_pattern = make_pattern(rng, c_body, c_alt)
    c_window = np.array([0.10, 0.12, 0.18]) * rng.uniform(0.6, 1.4)
    cab_top = body_z + Hb + 2 * cab_h

    def body_sdf(p):
        d_body = sd_round_box(p, np.array([0.0, 0.0, body_z]),
                              np.array([L, Wb, Hb]), rb)
        d_cab = sd_round_box(p, np.array([cab_x, 0.0, body_z + Hb + cab_h]),
                             np.array([cab_l, cab_w, cab_h]), rb * 0.7)
        return smin(d_body, d_cab, blend)

    def body_albedo(p):
        a = body_pattern(p)
        window = (p[..., 2] > body_z + Hb + 0.3 * cab_h) & \
                 (p[..., 2] < cab_top)
        a[window] = c_window
        return a

    parts = [(body_sdf, body_albedo, True)]

    c_tire = np.full(3, rng.uniform(0.06, 0.16))
    c_hub = rng.uniform(0.4, 0.95, size=3)
    for sx in (-1, 1):
        for sy in (-1, 1):
            center = np.array([sx * wx, sy * Wb, wheel_z])

            def wheel_sdf(p, c=center):
                return sd_torus_y(p, c, wheel_R, wheel_r)

            def wheel_albedo(p, c=center):
                hub = _norm(p - c) < wheel_R * 0.75
                a = np.broadcast_to(c_tire, p.shape).copy()
                a[hub] = c_hub
                return a

            parts.append((wheel_sdf, wheel_albedo, False))

    if rng.random() < 0.4:
        sp_c = np.array([-L * 0.9, 0.0, body_z + Hb + 0.04])

        def spoiler_sdf(p):
            return sd_round_box(p, sp_c, np.array([0.03, Wb * 0.9, 0.008]),
                                0.004)

        parts.append((spoiler_sdf, lambda p: body_pattern(p), False))

    return ProcObject(parts, random_lighting(rng))


def build_chair(rng):
    """Seat + tilted backrest + 4 capsule legs + optional armrests."""
    sx = rng.uniform(0.14, 0.20)
    sy = rng.uniform(0.14, 0.20)
    st = rng.uniform(0.02, 0.04)          # seat thickness
    seat_z = rng.uniform(-0.04, 0.02)
    leg_h = rng.uniform(0.12, 0.18)
    leg_r = rng.uniform(0.012, 0.022)
    splay = rng.uniform(0.0, 0.04)
    back_h = rng.uniform(0.12, 0.19)      # keeps the top inside radius 0.45
    # (near=0.8 with cameras at rho=1.3 clips points >0.5 from the origin)
    back_t = rng.uniform(0.015, 0.03)
    tilt = rng.uniform(0.0, 0.25)
    rb = rng.uniform(0.008, 0.02)

    c_seat = rng.uniform(0.2, 0.95, size=3)
    c_alt = rng.uniform(0.2, 0.95, size=3)
    seat_pattern = make_pattern(rng, c_seat, c_alt)
    c_leg = rng.uniform(0.1, 0.6, size=3)

    def seat_sdf(p):
        return sd_round_box(p, np.array([0.0, 0.0, seat_z]),
                            np.array([sx, sy, st]), rb)

    def back_sdf(p):
        # tilt about the y axis, hinged at the seat's rear edge
        q = p - np.array([-sx + back_t, 0.0, seat_z + st])
        ct, stl = np.cos(tilt), np.sin(tilt)
        qx = ct * q[..., 0] - stl * q[..., 2]
        qz = stl * q[..., 0] + ct * q[..., 2]
        qr = np.stack([qx, q[..., 1], qz - back_h], axis=-1)
        return sd_round_box(qr, np.zeros(3),
                            np.array([back_t, sy * 0.95, back_h]), rb)

    parts = [(seat_sdf, seat_pattern, True), (back_sdf, seat_pattern, True)]

    for lx in (-1, 1):
        for ly in (-1, 1):
            base = np.array([lx * (sx - leg_r - splay),
                             ly * (sy - leg_r - splay),
                             seat_z - st - leg_h])

            def leg_sdf(p, b=base):
                return sd_vcapsule(p, b, leg_h, leg_r)

            parts.append((leg_sdf,
                          lambda p: np.broadcast_to(c_leg, p.shape).copy(),
                          False))

    if rng.random() < 0.4:
        arm_z = seat_z + st + rng.uniform(0.05, 0.09)
        for ly in (-1, 1):
            arm_c = np.array([0.0, ly * sy, arm_z])

            def arm_sdf(p, c=arm_c):
                return sd_round_box(p, c, np.array([sx * 0.8, 0.012, 0.01]),
                                    0.006)

            parts.append((arm_sdf,
                          lambda p: np.broadcast_to(c_leg, p.shape).copy(),
                          False))

    return ProcObject(parts, random_lighting(rng))


BUILDERS = {"cars": build_car, "chairs": build_chair}


def build_object(rng, category):
    if category == "mixed":
        category = "cars" if rng.random() < 0.5 else "chairs"
    return BUILDERS[category](rng)


# ---------------------------------------------------------------------------
# Sphere-traced rendering
# ---------------------------------------------------------------------------

BOUND_R = 0.55


def _trace(obj, ro, rd, t0, t1, n_steps=96, eps=8e-4):
    """Sphere-trace rays (ro fixed origin, rd [M,3]) from t0 to t1 [M]."""
    t = t0.copy()
    alive = t < t1
    for _ in range(n_steps):
        if not np.any(alive):
            break
        p = ro + rd[alive] * t[alive][..., None]
        d = obj.sdf(p)
        t_new = t[alive] + d
        hit_now = d < eps
        t[alive] = t_new
        still = ~hit_now & (t_new < t1[alive])
        alive[alive.nonzero()[0][~still]] = False
    p = ro + rd * t[..., None]
    hit = (obj.sdf(p) < 4 * eps) & (t < t1 + 1e-6)
    return hit, t


def _normals(obj, p, eps=1e-3):
    n = np.stack([
        obj.sdf(p + np.array([eps, 0, 0])) - obj.sdf(p - np.array([eps, 0, 0])),
        obj.sdf(p + np.array([0, eps, 0])) - obj.sdf(p - np.array([0, eps, 0])),
        obj.sdf(p + np.array([0, 0, eps])) - obj.sdf(p - np.array([0, 0, eps])),
    ], axis=-1)
    return n / _norm(n)[..., None]


def render_object(H, W, focal, pose, obj):
    """Sphere-traced Blinn-Phong render; returns (uint8 rgb, bool hit)."""
    ii, jj = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64), indexing="xy")
    dirs = np.stack([(ii - W / 2) / focal, -(jj - H / 2) / focal,
                     -np.ones_like(ii)], axis=-1)
    rd = dirs @ pose[:3, :3].T
    rd = rd / _norm(rd)[..., None]
    ro = pose[:3, 3]

    # bounding-sphere cull
    b = 2 * np.sum(rd * ro, axis=-1)
    c = np.dot(ro, ro) - BOUND_R ** 2
    disc = b ** 2 - 4 * c
    maybe = disc > 0
    img = np.ones((H, W, 3))
    hit_full = np.zeros((H, W), dtype=bool)
    if not np.any(maybe):
        return (img * 255).clip(0, 254.9).astype(np.uint8), hit_full

    rdm = rd[maybe]
    sq = np.sqrt(np.maximum(disc[maybe], 0.0))
    t0 = np.maximum((-b[maybe] - sq) / 2, 1e-4)
    t1 = (-b[maybe] + sq) / 2
    hit, t = _trace(obj, ro, rdm, t0, t1)
    if np.any(hit):
        p = ro + rdm[hit] * t[hit][..., None]
        n = _normals(obj, p)
        _, pid = obj.sdf_parts(p)
        alb = obj.albedo(p, pid)
        ld, ambient, ks, shininess, fill = (obj.light_dir, obj.ambient,
                                            obj.ks, obj.shininess, obj.fill)
        lam = np.maximum(np.sum(n * ld, axis=-1), 0.0)
        fill_dir = np.array([-ld[0], -ld[1], abs(ld[2])])
        fill_dir = fill_dir / _norm(fill_dir)
        lam_fill = np.maximum(np.sum(n * fill_dir, axis=-1), 0.0)
        v = -rdm[hit]
        h = (ld + v) / _norm(ld + v)[..., None]
        spec = ks * np.maximum(np.sum(n * h, axis=-1), 0.0) ** shininess
        shade = alb * (ambient + (1 - ambient) * lam[..., None]
                       + fill * lam_fill[..., None]) + spec[..., None]
        colors = np.clip(shade, 0.0, 1.0)
        flat = img.reshape(-1, 3)
        idx = np.flatnonzero(maybe.ravel())[hit]
        flat[idx] = colors
        hit_full.ravel()[idx] = True
    return (img * 255).clip(0, 254.9).astype(np.uint8), hit_full


def render_sphere(H, W, focal, pose, color, radius=0.35):
    """Round-1 analytic Lambertian sphere, kept for --style sphere."""
    ii, jj = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64), indexing="xy")
    dirs = np.stack([(ii - W / 2) / focal, -(jj - H / 2) / focal,
                     -np.ones_like(ii)], axis=-1)
    rd = dirs @ pose[:3, :3].T
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = pose[:3, 3]
    b = 2 * np.sum(rd * ro, axis=-1)
    c = np.dot(ro, ro) - radius ** 2
    disc = b ** 2 - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2, np.inf)
    p = ro + rd * t[..., None]
    n = p / radius
    light = np.array([0.5, 0.5, 0.7]) / np.linalg.norm([0.5, 0.5, 0.7])
    lam = np.clip(np.sum(n * light, axis=-1), 0.1, 1.0)
    img = np.ones((H, W, 3))
    img[hit] = color * lam[hit][..., None]
    return (img * 255).clip(0, 254.9).astype(np.uint8), hit


def make_renderer(rng, style, category):
    """Returns render(H, W, focal, pose) -> (rgb uint8, hit bool) closure."""
    if style == "sphere":
        color = rng.uniform(0.2, 1.0, size=3)
        return lambda H, W, f, pose: render_sphere(H, W, f, pose, color)
    obj = build_object(rng, category)
    return lambda H, W, f, pose: render_object(H, W, f, pose, obj)


def write_blender(root: Path, rng, H, W, views, val_views, style, category):
    """nerf_synthetic-style tree: transforms_{train,val}.json + RGBA PNGs.

    Cameras use the same spherical parametrization; focal derives from a
    fixed camera_angle_x as the loader expects."""
    import json
    camera_angle_x = 2.0 * np.arctan(0.5 * W / (0.9 * W))
    render = make_renderer(rng, style, category)
    for stage, n in [("train", views), ("val", val_views)]:
        (root / stage).mkdir(parents=True, exist_ok=True)
        frames = []
        for v in range(n):
            # nerf_synthetic-style upper-hemisphere orbit, full azimuth
            # (theta is elevation here; see the SRN writer's note)
            theta = rng.uniform(0.6, 1.5)
            phi = rng.uniform(0.0, 2.0 * np.pi)
            pose = spherical_pose(theta, phi, 1.3)
            img, hit = render(H, W, 0.5 * W / np.tan(0.5 * camera_angle_x),
                              pose)
            alpha = np.where(hit, 255, 0).astype(np.uint8)[..., None]
            rgba = np.concatenate([img, alpha], axis=-1)
            write_png(root / stage / f"r_{v}.png", rgba)
            frames.append({"file_path": f"./{stage}/r_{v}",
                           "transform_matrix": pose.tolist()})
        meta = {"camera_angle_x": float(camera_angle_x), "frames": frames}
        (root / f"transforms_{stage}.json").write_text(json.dumps(meta))
    print(f"Wrote synthetic Blender dataset to {root}")


def write_llff(root: Path, rng, H, W, views, style, category):
    """LLFF layout: images/ + poses_bounds.npy.

    Stored pose columns are [down, right, back] (the loader flips them back
    to [right, up, back]); the rendered scene sits at the world origin and
    the loader's recentering applies one rigid transform to every camera, so
    the multi-view scene stays consistent."""
    (root / "images").mkdir(parents=True, exist_ok=True)
    render = make_renderer(rng, style, category)
    focal = 0.9 * W
    pb = np.zeros((views, 17))
    for v in range(views):
        theta = rng.uniform(1.3, 1.9)
        phi = rng.uniform(-0.3, 0.3)
        pose = spherical_pose(theta, phi, 1.3)
        img, _ = render(H, W, focal, pose)
        write_png(root / "images" / f"img_{v:03d}.png", img)
        right, up, back, t = (pose[:3, 0], pose[:3, 1], pose[:3, 2],
                              pose[:3, 3])
        stored = np.stack([-up, right, back, t], axis=1)       # [3, 4]
        hwf = np.array([H, W, focal]).reshape(3, 1)
        pb[v, :15] = np.concatenate([stored, hwf], axis=1).ravel()
        pb[v, 15:] = [0.5, 2.5]
    np.save(root / "poses_bounds.npy", pb)
    print(f"Wrote synthetic LLFF dataset to {root}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--name", default="cars")
    ap.add_argument("--format", choices=["srn", "blender", "llff"],
                    default="srn")
    ap.add_argument("--style", choices=["proc", "sphere"], default="proc",
                    help="proc = multi-primitive textured SDF objects; "
                         "sphere = round-1 Lambertian spheres")
    ap.add_argument("--category", choices=["cars", "chairs", "mixed", "auto"],
                    default="auto",
                    help="auto picks by --name (contains 'chair' => chairs)")
    ap.add_argument("--objects", type=int, default=3)
    ap.add_argument("--val-objects", type=int, default=None,
                    help="number of held-out val objects (default: same as "
                         "--objects).  The round-3 finding that drove this "
                         "knob: with only 8 training objects the latent "
                         "space overfits (50k-step train PSNR 32 but "
                         "held-out TTO PSNR DROPS vs the 10k checkpoint), "
                         "so the campaign now trains on many more objects "
                         "than it evaluates.")
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--val-views", type=int, default=4)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--val-pose-jitter", type=float, default=0.0,
                    help="6-DOF off-sphere perturbation of val-stage "
                         "cameras (radians of rotation; translation scales "
                         "with it).  Uses a side rng so the generated "
                         "objects are identical to a jitter-free run with "
                         "the same seed.")
    ap.add_argument("--focal-jitter", type=float, default=0.0,
                    help="per-object fractional focal-length variation "
                         "(e.g. 0.1 = +-10%%).  Real SRN objects each carry "
                         "their own intrinsics.txt (reference "
                         "dataset.py:66-69); this flag generates such "
                         "heterogeneous-intrinsics data to exercise the "
                         "loader/harness contract.  Uses a side rng so the "
                         "objects are identical to a jitter-free run with "
                         "the same seed.")
    ap.add_argument("--only-stage", choices=["both", "train", "val"],
                    default="both",
                    help="restrict WRITING to one stage.  All random draws "
                         "for skipped objects still happen (the object "
                         "closures are built and the per-view angles are "
                         "drawn, nothing is rendered), so the output is "
                         "byte-identical to the corresponding slice of a "
                         "full sequential run.  '--only-stage val' "
                         "fast-forwards the whole train stage in seconds — "
                         "e.g. to regenerate only a lineage's held-out "
                         "split for an eval.")
    ap.add_argument("--obj-start", type=int, default=0,
                    help="first train-stage object index to WRITE (earlier "
                         "objects are rng-fast-forwarded).  With --obj-end "
                         "this shards the train stage across processes for "
                         "paper-scale lineages (2458 objects ~ 4 h "
                         "single-threaded); each shard deterministically "
                         "reproduces its slice of the sequential stream.")
    ap.add_argument("--obj-end", type=int, default=None,
                    help="one-past-last train-stage object index to WRITE "
                         "(default: all).  Val-stage sharding is not "
                         "supported (val splits are small).")
    args = ap.parse_args()

    category = args.category
    if category == "auto":
        category = "chairs" if "chair" in args.name else "cars"

    rng = np.random.default_rng(args.seed)
    H = W = args.size
    focal = 0.9 * args.size
    root = Path(args.out)

    if args.format == "blender":
        write_blender(root, rng, H, W, args.views, args.val_views,
                      args.style, category)
        return
    if args.format == "llff":
        write_llff(root, rng, H, W, args.views, args.style, category)
        return

    val_objects = (args.objects if args.val_objects is None
                   else args.val_objects)
    for stage, n_views, n_objects in [("train", args.views, args.objects),
                                      ("val", args.val_views, val_objects)]:
        if stage == "val" and args.only_stage == "train":
            break  # val draws come AFTER all train draws; nothing to skip to
        for o in range(n_objects):
            # Sharding/fast-forward: objects outside the write window still
            # consume the EXACT rng sequence (object closures built, theta/
            # phi drawn) so every shard reproduces its slice of the single
            # sequential stream byte-for-byte.  build_object + 2 draws/view
            # is ~micro­seconds vs ~6 s of sphere tracing per 128px object.
            write = True
            if stage == "train":
                if args.only_stage == "val":
                    write = False
                elif not (args.obj_start <= o
                          and (args.obj_end is None or o < args.obj_end)):
                    write = False
            obj_focal = focal
            if write:
                d = root / f"{args.name}_{stage}" / f"obj{o:03d}"
                (d / "rgb").mkdir(parents=True, exist_ok=True)
                (d / "pose").mkdir(parents=True, exist_ok=True)
                if args.focal_jitter > 0:
                    fr = np.random.default_rng(
                        [args.seed, 7007, 0 if stage == "train" else 1, o])
                    obj_focal = focal * float(
                        1.0 + fr.uniform(-args.focal_jitter,
                                         args.focal_jitter))
                (d / "intrinsics.txt").write_text(
                    f"{obj_focal} {W/2} {H/2} 0.\n0. 0. 0.\n1.\n{H} {W}\n")
            render = make_renderer(rng, args.style, category)
            for v in range(n_views):
                # theta is ELEVATION in this parametrization (the reference
                # pose_spherical docstring swaps the names, eval.py:22-38:
                # camera z = rho*sin(theta), so 1.57 is the pole).  Train
                # views cover a broad elevation band with full azimuth so
                # sides/wheels/legs are observed; val views sit nearer the
                # reference's (1.57, 0) TTO init, as its evaluation assumes.
                if stage == "train":
                    theta = rng.uniform(0.45, 1.95)
                else:
                    theta = rng.uniform(0.95, 1.45)
                phi = rng.uniform(0.0, 2.0 * np.pi)
                # camera radius matches each config's sampling window:
                # cars near/far 0.8-1.8 centers 1.3; chairs 1.25-2.75
                # centers 2.0 (the real SRN chairs rigs sit farther out)
                rho = 2.0 if category == "chairs" else 1.3
                pose_gl = spherical_pose(theta, phi, rho)
                if not write:
                    continue
                if stage == "val" and args.val_pose_jitter > 0:
                    jr = np.random.default_rng([args.seed, 9009, o, v])
                    pose_gl = jitter_pose(pose_gl, jr, args.val_pose_jitter)
                img, _ = render(H, W, obj_focal, pose_gl)
                write_png(d / "rgb" / f"{v:06d}.png", img)
                # loader applies diag(1,-1,-1,1) on read; store the
                # pre-flip (OpenGL) pose so it round-trips
                pose_store = pose_gl @ np.diag([1.0, -1.0, -1.0, 1.0])
                np.savetxt(d / "pose" / f"{v:06d}.txt",
                           pose_store.reshape(1, 16))
    print(f"Wrote synthetic SRN dataset to {root}")


if __name__ == "__main__":
    main()
