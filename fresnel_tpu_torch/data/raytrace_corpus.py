"""corpus_v2: raytraced TRUE-3D multi-view corpus with exact ground truth.

A copy of fresnel_tpu/data/raytrace_corpus.py (pure numpy), kept in the
port so that it imports nothing of the JAX package; it writes the same
bytes per (seed, index).

corpus_v1 (synthetic_corpus.py) is a 2.5-D screen-space composite — it has
exact frontal depth but NO ground truth from any other viewpoint, so novel
views could only ever be scored by coverage (the reference has the same
limitation on photos: experiments/011-view-aware-training/results.md scores
side views by coverage %, not SSIM, because no side-view GT exists for a
photo).  corpus_v2 removes that limitation: every scene is a true 3-D
arrangement of analytic primitives, raytraced from the SAME orbit cameras
the evaluator uses (evaluation/novel_view_eval.py:render_views — elevation
0, distance 2, azimuths 0..315 step 45), so novel-view SSIM/PSNR become
measurable — a metric the reference cannot produce at all.

Per scene this writes the corpus_v1 training contract (frontal {name}.png
+ {name}_depth.bin, 256^2 float32 disparity in [0,1], larger = closer,
min-max normalized like the reference's Depth-Anything cache,
scripts/inference/depth_inference.py:59-75) PLUS a multi-view sidecar
{name}_views.npz:

    images       (V, S, S, 3) uint8 — raytraced GT at each azimuth
    azimuths_deg (V,) float32

Scene model (all view-consistent by construction):
  * a textured ground plane y = gy and a textured cylindrical room wall of
    radius 4 centred on the origin (a flat backdrop would face only one
    azimuth; a cylinder shell looks the same class of background from
    every orbit camera),
  * 3-6 primitives — spheres, axis-aligned ellipsoids, vertical capped
    cylinders, Y-rotated boxes — inside the r<0.8 disc around the origin,
  * WORLD-SPACE procedural albedo (3-D stripes / polka lattice / value
    noise): texture is attached to the geometry, not the screen, so the
    same surface point keeps its color from every camera,
  * Lambertian shading from one random directional light + ambient, with
    a single hard shadow ray toward the light,
  * 2x supersampling.

Camera parity is the load-bearing contract here: rays are generated from
the exact Camera.from_pose conventions (core/camera.py — looks down -Z,
u = fx*x/(-z)+cx, v = fy*(-y)/(-z)+cy, R rows [right, up, -forward]), and
tests/test_raytrace_corpus.py renders a Gaussian splat at a raytraced
sphere's centre through render_tiled to pin alignment at several azimuths.

Pure numpy — runs anywhere, deterministic per (seed, index).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np

from fresnel_tpu_torch.data.synthetic_corpus import value_noise

DEFAULT_AZIMUTHS_DEG = (0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0)
_BIG = 1e9


# ----------------------------------------------------------------------
# world-space procedural textures (view-consistent)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Texture3D:
    """Albedo as a function of the WORLD hit point."""
    kind: str                  # "solid" | "stripes" | "polka" | "noise"
    c0: np.ndarray             # (3,)
    c1: np.ndarray             # (3,)
    direction: np.ndarray      # (3,) stripe normal / lattice offset
    scale: float               # stripes: spatial frequency; polka: cell size
    phase: float
    noise_grid: np.ndarray | None = None   # (g, g) for "noise"

    def albedo(self, p: np.ndarray) -> np.ndarray:
        """(N, 3) world points -> (N, 3) albedo."""
        if self.kind == "solid":
            return np.broadcast_to(self.c0, p.shape).copy()
        if self.kind == "stripes":
            s = np.sin(2.0 * np.pi * self.scale * (p @ self.direction)
                       + self.phase)
            m = (0.5 + 0.5 * np.tanh(8.0 * s))[:, None]   # soft square wave
            return self.c0 * (1 - m) + self.c1 * m
        if self.kind == "polka":
            cell = self.scale
            q = (p + self.direction) / cell
            frac = q - np.floor(q) - 0.5                  # (N, 3) in [-.5,.5)
            d = np.sqrt(np.sum(frac * frac, axis=-1))
            m = (d < 0.30).astype(np.float32)[:, None]
            return self.c0 * (1 - m) + self.c1 * m
        # "noise": slice the 2-D value-noise grid by two world coords —
        # cheap, seamless enough for backgrounds.
        g = self.noise_grid.shape[0]
        u = (p[:, 0] * self.scale + self.phase) % 1.0
        v = (p[:, 2] * self.scale + 0.37 * self.phase) % 1.0
        iu = np.minimum((u * (g - 1)).astype(np.int64), g - 2)
        iv = np.minimum((v * (g - 1)).astype(np.int64), g - 2)
        fu = (u * (g - 1) - iu)[:, None]
        fv = (v * (g - 1) - iv)[:, None]
        n00 = self.noise_grid[iv, iu][:, None]
        n01 = self.noise_grid[iv, iu + 1][:, None]
        n10 = self.noise_grid[iv + 1, iu][:, None]
        n11 = self.noise_grid[iv + 1, iu + 1][:, None]
        m = (n00 * (1 - fu) + n01 * fu) * (1 - fv) \
            + (n10 * (1 - fu) + n11 * fu) * fv
        return self.c0 * (1 - m) + self.c1 * m


def _random_texture(rng: np.random.Generator,
                    kinds=("stripes", "polka", "noise", "solid")) -> Texture3D:
    from fresnel_tpu_torch.data.synthetic_corpus import _palette
    kind = kinds[rng.integers(len(kinds))]
    c0, c1 = _palette(rng), _palette(rng)   # two fresh saturated colors
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction)
    return Texture3D(
        kind=kind, c0=c0.astype(np.float32), c1=c1.astype(np.float32),
        direction=direction.astype(np.float32),
        scale=float(rng.uniform(2.0, 6.0)) if kind != "polka"
        else float(rng.uniform(0.12, 0.3)),
        phase=float(rng.uniform(0, 2 * np.pi)),
        noise_grid=value_noise(rng, 128).astype(np.float32)
        if kind == "noise" else None,
    )


# ----------------------------------------------------------------------
# primitives: intersect(origins, dirs) -> (t, normal_at_hit)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Primitive:
    kind: str                  # "sphere" | "ellipsoid" | "cylinder" | "box"
    center: np.ndarray         # (3,)
    params: np.ndarray         # sphere: [r]; ellipsoid: [rx,ry,rz];
    #                            cylinder: [r, half_h]; box: [hx,hy,hz, yaw]
    texture: Texture3D = None

    def intersect(self, o: np.ndarray, d: np.ndarray):
        """(N,3) origins/dirs -> (t (N,), n (N,3)); t=_BIG on miss."""
        if self.kind in ("sphere", "ellipsoid"):
            radii = (np.array([self.params[0]] * 3, np.float32)
                     if self.kind == "sphere" else self.params[:3])
            oc = (o - self.center) / radii
            dn = d / radii
            a = np.sum(dn * dn, -1)
            b = np.sum(oc * dn, -1)
            c = np.sum(oc * oc, -1) - 1.0
            disc = b * b - a * c
            ok = disc > 0
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = (-b - sq) / np.maximum(a, 1e-12)
            t = np.where(ok & (t > 1e-4), t, _BIG)
            p = o + t[:, None] * d
            n = (p - self.center) / (radii * radii)
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            return t, n
        if self.kind == "cylinder":
            r, hh = float(self.params[0]), float(self.params[1])
            oc = o - self.center
            a = d[:, 0] ** 2 + d[:, 2] ** 2
            b = oc[:, 0] * d[:, 0] + oc[:, 2] * d[:, 2]
            c = oc[:, 0] ** 2 + oc[:, 2] ** 2 - r * r
            disc = b * b - a * c
            sq = np.sqrt(np.maximum(disc, 0.0))
            t_side = (-b - sq) / np.maximum(a, 1e-12)
            y = oc[:, 1] + t_side * d[:, 1]
            side_ok = (disc > 0) & (t_side > 1e-4) & (np.abs(y) <= hh)
            t_side = np.where(side_ok, t_side, _BIG)
            # caps
            dy = np.where(np.abs(d[:, 1]) < 1e-9, 1e-9, d[:, 1])
            t_top = (hh - oc[:, 1]) / dy
            t_bot = (-hh - oc[:, 1]) / dy
            t_cap = np.where(t_top < t_bot, t_top, t_bot)          # nearer cap
            cap_sign = np.where(t_top < t_bot, 1.0, -1.0)
            px = oc[:, 0] + t_cap * d[:, 0]
            pz = oc[:, 2] + t_cap * d[:, 2]
            cap_ok = (t_cap > 1e-4) & (px * px + pz * pz <= r * r)
            t_cap = np.where(cap_ok, t_cap, _BIG)
            use_side = t_side < t_cap
            t = np.where(use_side, t_side, t_cap)
            p = o + t[:, None] * d
            n_side = np.stack([p[:, 0] - self.center[0],
                               np.zeros_like(t),
                               p[:, 2] - self.center[2]], -1)
            n_side /= np.maximum(
                np.linalg.norm(n_side, axis=-1, keepdims=True), 1e-12)
            n_cap = np.stack([np.zeros_like(t), cap_sign,
                              np.zeros_like(t)], -1)
            n = np.where(use_side[:, None], n_side, n_cap)
            return t, n
        # Y-rotated box: rotate the ray into the box frame, slab test.
        hx, hy, hz, yaw = [float(v) for v in self.params[:4]]
        cy_, sy = np.cos(yaw), np.sin(yaw)
        def rot(v):   # world -> box frame (rotate by -yaw about Y)
            return np.stack([cy_ * v[:, 0] - sy * v[:, 2],
                             v[:, 1],
                             sy * v[:, 0] + cy_ * v[:, 2]], -1)
        ob = rot(o - self.center)
        db = rot(d)
        half = np.array([hx, hy, hz], np.float32)
        inv = 1.0 / np.where(np.abs(db) < 1e-9, 1e-9, db)
        t1 = (-half - ob) * inv
        t2 = (half - ob) * inv
        tmin = np.max(np.minimum(t1, t2), axis=-1)
        tmax = np.min(np.maximum(t1, t2), axis=-1)
        ok = (tmax > tmin) & (tmin > 1e-4)
        t = np.where(ok, tmin, _BIG)
        pb = ob + t[:, None] * db
        # face normal: the axis where |p| is closest to the half-extent
        rel = np.abs(np.abs(pb) / half - 1.0)
        axis = np.argmin(rel, axis=-1)
        nb = np.zeros_like(pb)
        nb[np.arange(len(t)), axis] = np.sign(
            pb[np.arange(len(t)), axis] + 1e-12)
        # box frame -> world (rotate by +yaw about Y)
        n = np.stack([cy_ * nb[:, 0] + sy * nb[:, 2],
                      nb[:, 1],
                      -sy * nb[:, 0] + cy_ * nb[:, 2]], -1)
        return t, n


@dataclasses.dataclass
class Scene:
    primitives: List[Primitive]
    ground_y: float
    ground_tex: Texture3D
    wall_radius: float
    wall_tex: Texture3D
    light_dir: np.ndarray      # (3,) unit, points FROM surface TOWARD light
    ambient: float


def sample_scene(rng: np.random.Generator) -> Scene:
    n_prims = int(rng.integers(3, 7))
    prims: List[Primitive] = []
    gy = float(rng.uniform(-0.75, -0.55))
    for _ in range(n_prims):
        kind = ("sphere", "ellipsoid", "cylinder", "box")[rng.integers(4)]
        # keep subjects inside the r<0.8 disc so every orbit camera sees them
        cx, cz = rng.uniform(-0.55, 0.55, size=2)
        tex = _random_texture(rng)
        if kind == "sphere":
            r = float(rng.uniform(0.15, 0.32))
            cy0 = gy + r if rng.random() < 0.7 else float(
                rng.uniform(gy + r, 0.6))
            prims.append(Primitive("sphere", np.array([cx, cy0, cz],
                         np.float32), np.array([r], np.float32), tex))
        elif kind == "ellipsoid":
            rx, ry, rz = rng.uniform(0.12, 0.35, size=3)
            cy0 = gy + ry
            prims.append(Primitive("ellipsoid",
                         np.array([cx, cy0, cz], np.float32),
                         np.array([rx, ry, rz], np.float32), tex))
        elif kind == "cylinder":
            r = float(rng.uniform(0.10, 0.24))
            hh = float(rng.uniform(0.15, 0.45))
            prims.append(Primitive("cylinder",
                         np.array([cx, gy + hh, cz], np.float32),
                         np.array([r, hh], np.float32), tex))
        else:
            hx, hy, hz = rng.uniform(0.10, 0.30, size=3)
            yaw = float(rng.uniform(0, np.pi))
            prims.append(Primitive("box",
                         np.array([cx, gy + hy, cz], np.float32),
                         np.array([hx, hy, hz, yaw], np.float32), tex))
    light = rng.normal(size=3)
    light[1] = abs(light[1]) + 0.5          # light from above
    light /= np.linalg.norm(light)
    return Scene(
        primitives=prims,
        ground_y=gy,
        ground_tex=_random_texture(rng, kinds=("stripes", "polka", "noise")),
        wall_radius=4.0,
        wall_tex=_random_texture(rng, kinds=("noise", "stripes")),
        light_dir=light.astype(np.float32),
        ambient=float(rng.uniform(0.25, 0.4)),
    )


# ----------------------------------------------------------------------
# raytracer
# ----------------------------------------------------------------------

def _trace(scene: Scene, o: np.ndarray, d: np.ndarray):
    """Nearest hit over primitives + ground + wall.

    Returns (t, point, normal, albedo, hit_kind) with hit_kind
    0=primitive, 1=ground, 2=wall; t=_BIG where nothing was hit."""
    N = o.shape[0]
    best_t = np.full(N, _BIG, np.float32)
    best_n = np.zeros((N, 3), np.float32)
    best_a = np.zeros((N, 3), np.float32)
    kind = np.full(N, 2, np.int8)

    for prim in scene.primitives:
        t, n = prim.intersect(o, d)
        closer = t < best_t
        if np.any(closer):
            p = o[closer] + t[closer, None] * d[closer]
            best_a[closer] = prim.texture.albedo(p)
            best_n[closer] = n[closer]
            best_t[closer] = t[closer]
            kind[closer] = 0

    # ground plane y = gy (only from above)
    dy = np.where(np.abs(d[:, 1]) < 1e-9, 1e-9, d[:, 1])
    tg = (scene.ground_y - o[:, 1]) / dy
    pg = o + tg[:, None] * d
    ground_ok = (tg > 1e-4) & (tg < best_t) \
        & (pg[:, 0] ** 2 + pg[:, 2] ** 2 < scene.wall_radius ** 2)
    if np.any(ground_ok):
        best_a[ground_ok] = scene.ground_tex.albedo(pg[ground_ok])
        best_n[ground_ok] = np.array([0.0, 1.0, 0.0], np.float32)
        best_t[ground_ok] = tg[ground_ok]
        kind[ground_ok] = 1

    # cylindrical room wall, radius R about the Y axis (hit from inside)
    R = scene.wall_radius
    a = d[:, 0] ** 2 + d[:, 2] ** 2
    b = o[:, 0] * d[:, 0] + o[:, 2] * d[:, 2]
    c = o[:, 0] ** 2 + o[:, 2] ** 2 - R * R
    disc = np.maximum(b * b - a * c, 0.0)
    tw = (-b + np.sqrt(disc)) / np.maximum(a, 1e-12)   # far root: inside
    wall_ok = (tw > 1e-4) & (tw < best_t)
    if np.any(wall_ok):
        pw = o[wall_ok] + tw[wall_ok, None] * d[wall_ok]
        best_a[wall_ok] = scene.wall_tex.albedo(pw)
        nw = -pw.copy()
        nw[:, 1] = 0.0
        nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
        best_n[wall_ok] = nw
        best_t[wall_ok] = tw[wall_ok]
        kind[wall_ok] = 2

    point = o + best_t[:, None] * d
    return best_t, point, best_n, best_a, kind


def _shadow(scene: Scene, p: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """1.0 = lit, 0.0 = in shadow (primitives only cast shadows)."""
    lit = np.ones(p.shape[0], np.float32)
    if not np.any(mask):
        return lit
    o = p[mask] + 1e-3 * scene.light_dir
    d = np.broadcast_to(scene.light_dir, o.shape)
    blocked = np.zeros(o.shape[0], bool)
    for prim in scene.primitives:
        t, _ = prim.intersect(o, d)
        blocked |= t < _BIG * 0.5
    out = lit[mask]
    out[blocked] = 0.0
    lit[mask] = out
    return lit


def render_view(scene: Scene, azimuth_deg: float, image_size: int = 256,
                elevation_deg: float = 0.0, distance: float = 2.0,
                focal_mult: float = 0.8, supersample: int = 2):
    """Raytrace one orbit view.  Returns (rgb (S,S,3) float32 [0,1],
    depth_cam (S,S) float32 — positive camera-space depth)."""
    S = image_size * supersample
    el, az = np.radians(elevation_deg), np.radians(azimuth_deg)
    cam_pos = np.array([distance * np.cos(el) * np.sin(az),
                        distance * np.sin(el),
                        distance * np.cos(el) * np.cos(az)], np.float32)
    # Camera basis — EXACTLY core/camera.py:look_at_view (target = origin,
    # up = +Y): forward = normalize(-cam), right = normalize(f x up),
    # true_up = right x f (wait-free: elevation 0 here keeps it regular).
    fwd = -cam_pos / np.linalg.norm(cam_pos)
    up0 = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(fwd, up0)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)

    fx = fy = image_size * focal_mult * supersample
    cx = cy = S / 2.0
    u, v = np.meshgrid(np.arange(S) + 0.5, np.arange(S) + 0.5)
    # invert the projection u = fx*x/(-z)+cx, v = fy*(-y)/(-z)+cy at z=-1
    x = (u.ravel() - cx) / fx
    y = -(v.ravel() - cy) / fy
    # world = R^T @ cam with R rows [right, up, -fwd] (look_at_view), so a
    # camera-space ray (x, y, -1) maps to x*right + y*up + fwd.
    d_world = x[:, None] * right + y[:, None] * up + fwd
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
    o = np.broadcast_to(cam_pos, d_world.shape).astype(np.float32)

    t, p, n, albedo, kind = _trace(scene, o, d_world.astype(np.float32))
    ndl = np.maximum(np.sum(n * scene.light_dir, -1), 0.0)
    lit = _shadow(scene, p, kind == 0)
    # background (wall/ground) keeps softer shading so subjects pop
    diffuse = np.where(kind == 0, ndl * lit, 0.55 * ndl + 0.25)
    shade = scene.ambient + (1.0 - scene.ambient) * diffuse
    rgb = albedo * shade[:, None]

    # camera-space depth = -z_cam = (p - cam) . (-fwd_cam_z) = t (unit dirs
    # scaled) — use the projection onto the view direction for exactness.
    depth = np.sum((p - cam_pos) * fwd, -1)

    rgb = rgb.reshape(S, S, 3)
    depth = depth.reshape(S, S)
    if supersample > 1:
        ss = supersample
        rgb = rgb.reshape(image_size, ss, image_size, ss, 3).mean((1, 3))
        depth = depth.reshape(image_size, ss, image_size, ss).mean((1, 3))
    return np.clip(rgb, 0.0, 1.0).astype(np.float32), depth.astype(np.float32)


# ----------------------------------------------------------------------
# corpus generation
# ----------------------------------------------------------------------

def render_scene_views(seed: int, index: int, image_size: int = 256,
                       azimuths_deg=DEFAULT_AZIMUTHS_DEG):
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    scene = sample_scene(rng)
    views, depths = [], []
    for az in azimuths_deg:
        rgb, depth = render_view(scene, az, image_size)
        views.append(rgb)
        depths.append(depth)
    return scene, np.stack(views), np.stack(depths)


def generate_corpus(out_dir: str, n_images: int = 160, image_size: int = 256,
                    seed: int = 0, azimuths_deg=DEFAULT_AZIMUTHS_DEG,
                    depth_size: int = 256, start: int = 0,
                    stride: int = 1) -> None:
    """start/stride shard the index range so N processes can generate in
    parallel (scene i is deterministic per (seed, i) regardless of which
    process renders it)."""
    from PIL import Image

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(start, n_images, stride):
        name = f"scene_{i:04d}"
        png = out / f"{name}.png"
        npz = out / f"{name}_views.npz"
        if png.exists() and npz.exists():
            continue
        _, views, depths = render_scene_views(seed, i, image_size,
                                              azimuths_deg)
        # frontal (az=0) is the training image + depth cache
        Image.fromarray((views[0] * 255).astype(np.uint8)).save(png)
        d = depths[0]
        if depth_size != d.shape[0]:
            from PIL import Image as I
            d = np.asarray(I.fromarray(d).resize((depth_size, depth_size),
                                                 I.BILINEAR))
        disp = 1.0 / np.maximum(d, 1e-3)
        disp = (disp - disp.min()) / max(disp.max() - disp.min(), 1e-9)
        disp.astype(np.float32).tofile(out / f"{name}_depth.bin")
        np.savez_compressed(
            npz,
            images=(views * 255).astype(np.uint8),
            azimuths_deg=np.asarray(azimuths_deg, np.float32))
        if (i + 1) % 10 == 0:
            print(f"{out_dir}: {i + 1}/{n_images}")


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--n_images", type=int, default=160)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--stride", type=int, default=1)
    args = ap.parse_args(argv)
    generate_corpus(args.out_dir, args.n_images, args.image_size, args.seed,
                    start=args.start, stride=args.stride)


if __name__ == "__main__":
    main()
