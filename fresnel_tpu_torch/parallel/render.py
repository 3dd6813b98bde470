"""Multi-device rendering: the three sharded renders over a 1-D mesh.

Counterpart of fresnel_tpu/parallel/render.py.  Every rank is handed the
whole input and returns the whole image, as JAX's global arrays are
whole on every device; each rank renders its part through the tiled
renderer (K1, with K3 or K4 binning at a million Gaussians) and the parts
meet in one all_gather (the renders are not differentiable):

* `render_batch_sharded`: (B, N, ...) clouds; each rank renders its B / n
  clouds with `render_tiled_batched` (one K1 launch) -> (B, 3, H, W).
* `render_gaussian_sharded`: one cloud, pre-sorted front to back; each
  rank composites its depth-contiguous slab of N / n Gaussians against
  black with its residual transmittance, and the (colour, T) partials
  fold front to back: (c1, T1) + (c2, T2) = (c1 + T1 c2, T1 T2).
* `render_pixel_sharded`: one cloud; each rank renders a band of H / n
  rows through a band camera (cy shifted by the band's first row).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from fresnel_tpu_torch.core.camera import Camera, _f32
from fresnel_tpu_torch.render.tile import (
    TileRendererConfig, render_tiled, render_tiled_batched)


def _rank_world(mesh, axis: str = "data"):
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(n, *x.shape): every rank's x, in rank order."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _slab(n_items: int, n: int, rank: int, what: str) -> slice:
    if n_items % n:
        raise ValueError(f"{what} {n_items} not divisible by {n} devices")
    b = n_items // n
    return slice(rank * b, (rank + 1) * b)


def render_batch_sharded(positions, scales, rotations, colors, opacities,
                         camera: Camera, mesh,
                         config: TileRendererConfig = TileRendererConfig()):
    """(B, N, ...) Gaussian batches -> (B, 3, H, W), batch sharded on
    "data"."""
    group, rank, n = _rank_world(mesh)
    rows = _slab(positions.shape[0], n, rank, "batch")
    with torch.no_grad():
        img, _, _ = render_tiled_batched(
            positions[rows], scales[rows], rotations[rows], colors[rows],
            opacities[rows], camera, config=config)
        parts = _gather(img, group, n)            # (n, B / n, 3, H, W)
    return parts.reshape(-1, *img.shape[1:])


def render_gaussian_sharded(positions, scales, rotations, colors, opacities,
                            camera: Camera, mesh,
                            config: TileRendererConfig = TileRendererConfig(),
                            background: Tuple[float, float, float] = (0, 0, 0)
                            ):
    """One cloud, Gaussian axis sharded over "data"; the cloud must be
    pre-sorted front to back so each shard is a depth-contiguous slab."""
    group, rank, n = _rank_world(mesh)
    sl = _slab(positions.shape[0], n, rank, "Gaussian count")
    with torch.no_grad():
        img, T = render_tiled(positions[sl], scales[sl], rotations[sl],
                              colors[sl], opacities[sl], camera,
                              background=(0.0, 0.0, 0.0),
                              return_transmittance=True, config=config)
        parts = _gather(torch.stack([img, T.expand_as(img)]), group, n)
    # parts: (n, 2, 3, H, W), one (colour, T) partial per depth slab,
    # folded front to back.
    color, T = parts[0, 0], parts[0, 1]
    for d in range(1, n):
        color = color + T * parts[d, 0]
        T = T * parts[d, 1]
    bg = torch.tensor(background, dtype=torch.float32, device=color.device)
    return torch.clamp(color + T * bg[:, None, None], 0.0, 1.0)


def render_pixel_sharded(positions, scales, rotations, colors, opacities,
                         camera: Camera, mesh,
                         config: TileRendererConfig = TileRendererConfig(),
                         background: Tuple[float, float, float] = (0, 0, 0)):
    """One cloud on every rank; image rows sharded over "data": each rank
    renders the band of rows [rank * H / n, (rank + 1) * H / n) through a
    camera whose principal point is shifted by the band's first row."""
    group, rank, n = _rank_world(mesh)
    if camera.height % n:
        raise ValueError(
            f"height {camera.height} not divisible by {n} devices")
    band_h = camera.height // n
    band_cam = camera.replace(cy=_f32(camera.cy - rank * band_h),
                              height=band_h)
    with torch.no_grad():
        band = render_tiled(positions, scales, rotations, colors, opacities,
                            band_cam, background=background, config=config)
        bands = _gather(band, group, n)           # (n, 3, band_h, W)
    return torch.cat(list(bands), dim=1)
