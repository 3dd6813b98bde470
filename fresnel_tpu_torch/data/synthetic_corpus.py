"""Photo-like synthetic corpus with ground-truth depth.

The reference trains on LPFF/FFHQ photographs with Depth-Anything-V2 depth
and DINOv2 features (reference: scripts/preprocessing/
preprocess_training_data.py:214-260).  Neither real photos nor pretrained
weights are obtainable in this environment (no egress), so the quality
campaign needs the best photo-like corpus we can *generate*: diverse,
shaded, textured 2.5-D scenes with EXACT per-pixel depth.

Each scene composes analytic primitives (spheres, boxes, vertical
cylinders, ellipses) over a textured ground plane and backdrop:

  * per-pixel depth from the analytic near surface (min-depth composite),
  * Lambertian shading from the analytic normals and a random light,
  * fractal value-noise / stripe / polka albedo textures,
  * 2x supersampling for soft edges.

`generate_corpus` writes {name}.png plus the ImageDataset depth-cache
contract `{name}_depth.bin` (256x256 float32 disparity in [0, 1], larger =
closer — Depth-Anything's convention after the reference's min-max
normalization, scripts/inference/depth_inference.py:59-75).  Ground-truth
depth stands in for the depth model exactly the way the reference's cache
files stand in for rerunning ONNX.

Pure numpy — runs anywhere, deterministic per (seed, index).

Counterpart of fresnel_tpu/data/synthetic_corpus.py: the same draws in
the same order, so both packages write the same bytes per (seed, index).

    python -m fresnel_tpu_torch.data.synthetic_corpus OUT_DIR --n_images 16
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


# ----------------------------------------------------------------------
# textures
# ----------------------------------------------------------------------

def _bilinear_upsample(grid: np.ndarray, size: int) -> np.ndarray:
    """(g, g) -> (size, size) bilinear, numpy only."""
    g = grid.shape[0]
    xs = np.linspace(0, g - 1, size)
    x0 = np.clip(xs.astype(np.int32), 0, g - 2)
    fx = xs - x0
    rows = grid[:, x0] * (1 - fx) + grid[:, x0 + 1] * fx        # (g, size)
    cols = rows[x0, :] * (1 - fx[:, None]) + rows[x0 + 1, :] * fx[:, None]
    return cols


def value_noise(rng: np.random.Generator, size: int, octaves: int = 4,
                base: int = 4) -> np.ndarray:
    """Fractal value noise in [0, 1], (size, size)."""
    out = np.zeros((size, size), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        g = min(base * (2 ** o) + 1, size)
        out += amp * _bilinear_upsample(
            rng.random((g, g), dtype=np.float32), size)
        total += amp
        amp *= 0.5
    return out / total


def _texture(rng: np.random.Generator, size: int, c0: np.ndarray,
             c1: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Albedo field (size, size, 3) mixing two colors by a random pattern.

    u, v are surface-ish coordinates in roughly [0, 1] used for stripes /
    polka so patterns follow the primitive, not the screen.
    """
    kind = rng.integers(0, 4)
    if kind == 0:        # fractal noise
        t = value_noise(rng, size, octaves=4, base=int(rng.integers(3, 7)))
    elif kind == 1:      # stripes
        freq = rng.uniform(4.0, 14.0)
        ang = rng.uniform(0, np.pi)
        t = 0.5 + 0.5 * np.sin(
            2 * np.pi * freq * (u * np.cos(ang) + v * np.sin(ang)))
    elif kind == 2:      # polka dots
        freq = rng.uniform(4.0, 10.0)
        t = (((u * freq) % 1.0 - 0.5) ** 2
             + ((v * freq) % 1.0 - 0.5) ** 2) < 0.06
        t = t.astype(np.float32)
    else:                # smooth gradient
        ang = rng.uniform(0, 2 * np.pi)
        t = 0.5 + 0.5 * (u * np.cos(ang) + v * np.sin(ang))
        t = np.clip(t, 0, 1)
    return (c0[None, None] * (1 - t[..., None])
            + c1[None, None] * t[..., None]).astype(np.float32)


def _palette(rng: np.random.Generator) -> np.ndarray:
    """A saturated-but-not-neon random color."""
    h = rng.uniform(0, 6.0)
    s = rng.uniform(0.35, 0.9)
    val = rng.uniform(0.45, 0.95)
    c = val * s
    x = c * (1 - abs(h % 2 - 1))
    rgb = [(c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c), (c, 0, x)][
        int(h) % 6]
    m = val - c
    return np.array([rgb[0] + m, rgb[1] + m, rgb[2] + m], np.float32)


# ----------------------------------------------------------------------
# primitives: each returns (depth, normal, albedo, mask)
# ----------------------------------------------------------------------

def _scene_arrays(rng: np.random.Generator, S: int):
    """Render one scene at supersampled size S.  Returns (rgb, depth)."""
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S  # [0,1], y down

    FAR = 10.0
    depth = np.full((S, S), FAR, np.float32)
    normal = np.zeros((S, S, 3), np.float32)
    normal[..., 2] = -1.0
    albedo = np.zeros((S, S, 3), np.float32)

    # Backdrop: textured wall at z ~ 7-9, slight vertical gradient.
    z_wall = rng.uniform(7.0, 9.0)
    depth[:] = z_wall
    albedo[:] = _texture(rng, S, _palette(rng), _palette(rng) * 0.7,
                         xx, yy)

    # Ground plane from a random horizon downward: z decreases toward the
    # viewer at the bottom of the frame.
    horizon = rng.uniform(0.45, 0.7)
    gmask = yy > horizon
    t = np.clip((yy - horizon) / (1 - horizon + 1e-6), 0, 1)
    z_ground = z_wall - t * (z_wall - 2.0)
    g_alb = _texture(rng, S, _palette(rng), _palette(rng) * 0.6,
                     xx, z_ground / z_wall)
    depth = np.where(gmask, z_ground, depth)
    albedo = np.where(gmask[..., None], g_alb, albedo)
    normal = np.where(gmask[..., None],
                      np.array([0, -0.9, -0.44], np.float32), normal)

    # Objects, far to near so the min-depth composite is trivially correct
    # per primitive (each already only claims pixels it is nearest on).
    n_obj = int(rng.integers(4, 9))
    for _ in range(n_obj):
        kind = int(rng.integers(0, 4))
        cx = rng.uniform(0.12, 0.88)
        cy = rng.uniform(0.2, 0.85)
        r = rng.uniform(0.06, 0.2)
        z0 = rng.uniform(2.5, 6.5)       # center depth of the object
        c0, c1 = _palette(rng), _palette(rng)

        if kind == 0:                    # sphere
            dx, dy = xx - cx, yy - cy
            d2 = dx * dx + dy * dy
            mask = d2 < r * r
            h = np.sqrt(np.clip(1 - d2 / (r * r), 0, 1))
            z = z0 - r * 4.0 * h         # bulge toward viewer
            n = np.stack([dx / r, dy / r, -h], axis=-1)
            u, v = dx / (2 * r) + 0.5, dy / (2 * r) + 0.5
        elif kind == 1:                  # screen-aligned box (slanted)
            w, hh = r * rng.uniform(0.8, 1.6), r * rng.uniform(0.8, 1.6)
            ang = rng.uniform(0, np.pi)
            dx = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
            dy = -(xx - cx) * np.sin(ang) + (yy - cy) * np.cos(ang)
            mask = (np.abs(dx) < w) & (np.abs(dy) < hh)
            slant = rng.uniform(-0.8, 0.8)
            z = z0 + slant * dx / max(w, 1e-6)
            nrm = np.array([np.sin(np.arctan(slant)), 0,
                            -np.cos(np.arctan(slant))], np.float32)
            n = np.broadcast_to(nrm, (S, S, 3))
            u, v = dx / (2 * w) + 0.5, dy / (2 * hh) + 0.5
        elif kind == 2:                  # vertical cylinder
            hh = r * rng.uniform(1.5, 3.0)
            dx, dy = xx - cx, yy - cy
            mask = (np.abs(dx) < r) & (np.abs(dy) < hh)
            h = np.sqrt(np.clip(1 - (dx / r) ** 2, 0, 1))
            z = z0 - r * 3.0 * h
            n = np.stack([dx / r, np.zeros_like(dx), -h], axis=-1)
            u, v = dx / (2 * r) + 0.5, dy / (2 * hh) + 0.5
        else:                            # ellipse blob
            w, hh = r * rng.uniform(0.7, 1.8), r * rng.uniform(0.7, 1.8)
            dx, dy = (xx - cx) / w, (yy - cy) / hh
            d2 = dx * dx + dy * dy
            mask = d2 < 1.0
            h = np.sqrt(np.clip(1 - d2, 0, 1))
            z = z0 - min(w, hh) * 3.0 * h
            n = np.stack([dx, dy, -h], axis=-1)
            u, v = dx / 2 + 0.5, dy / 2 + 0.5
        n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-8)
        a = _texture(rng, S, c0, c1, u.astype(np.float32),
                     v.astype(np.float32))
        closer = mask & (z < depth)
        depth = np.where(closer, z, depth)
        normal = np.where(closer[..., None], n, normal)
        albedo = np.where(closer[..., None], a, albedo)

    # Lambertian shading + soft ambient.  `light` is the direction the
    # light TRAVELS: into the scene (+z) and downward (+y, image-down), so
    # viewer-facing surfaces (n_z < 0) and top surfaces (n_y < 0) are lit.
    light = np.array([rng.uniform(-0.6, 0.6), rng.uniform(0.3, 0.9),
                      rng.uniform(0.4, 0.9)], np.float32)
    light /= np.linalg.norm(light)
    ndotl = np.clip(-(normal @ light), 0, 1)
    ambient = rng.uniform(0.35, 0.5)
    rgb = albedo * (ambient + (1 - ambient) * ndotl[..., None])
    # Mild distance haze so depth is visible in RGB too (photo-like).
    haze = np.clip((depth - 2.0) / 8.0, 0, 1)[..., None] * 0.25
    rgb = rgb * (1 - haze) + haze * 0.7
    return np.clip(rgb, 0, 1), depth


def render_scene(seed: int, image_size: int = 256, supersample: int = 2):
    """One scene: returns (rgb (S, S, 3) float32, disparity (S, S) [0, 1])."""
    rng = np.random.default_rng(seed)
    S = image_size * supersample
    rgb, depth = _scene_arrays(rng, S)
    if supersample > 1:
        k = supersample
        rgb = rgb.reshape(image_size, k, image_size, k, 3).mean((1, 3))
        depth = depth.reshape(image_size, k, image_size, k).min((1, 3))
    disp = 1.0 / depth
    disp = (disp - disp.min()) / (disp.max() - disp.min() + 1e-8)
    return rgb.astype(np.float32), disp.astype(np.float32)


def generate_corpus(out_dir: str, n_images: int = 160, image_size: int = 256,
                    depth_size: int = 256, seed: int = 0,
                    prefix: str = "scene") -> int:
    """Write {prefix}_{i:04d}.png + {name}_depth.bin ground-truth caches."""
    from PIL import Image

    root = Path(out_dir)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_images):
        name = f"{prefix}_{i:04d}"
        png = root / f"{name}.png"
        dep = root / f"{name}_depth.bin"
        if png.exists() and dep.exists():
            continue
        rgb, disp = render_scene(seed * 100003 + i, image_size)
        Image.fromarray((rgb * 255).astype(np.uint8)).save(png)
        if depth_size != image_size:
            d = _bilinear_upsample(disp, depth_size)
        else:
            d = disp
        d.astype(np.float32).tofile(dep)
    return n_images


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--n_images", type=int, default=160)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--prefix", default="scene")
    args = p.parse_args(argv)
    n = generate_corpus(args.out_dir, args.n_images, args.image_size,
                        seed=args.seed, prefix=args.prefix)
    print(f"{n} scenes in {args.out_dir}")


if __name__ == "__main__":
    main()
