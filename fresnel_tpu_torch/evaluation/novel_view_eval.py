"""Orbit views of a Gaussian cloud.

Counterpart of fresnel_tpu/evaluation/novel_view_eval.py's `render_views`;
`evaluate_novel_views` is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled

DEFAULT_AZIMUTHS_DEG = (0, 45, 90, 135, 180, 225, 270, 315)


def render_views(gaussians: Dict[str, torch.Tensor], render_size: int = 256,
                 azimuths_deg: Sequence[float] = DEFAULT_AZIMUTHS_DEG,
                 elevation_deg: float = 0.0, distance: float = 2.0,
                 max_per_tile: int = 256) -> torch.Tensor:
    """Render (V, 3, S, S) orbit views of a Gaussian dict (positions,
    scales, rotations, colors, opacities), on the tensors' device."""
    cfg = TileRendererConfig(max_per_tile=max_per_tile)
    views = []
    for az in azimuths_deg:
        cam = Camera.from_pose(np.radians(elevation_deg), np.radians(az),
                               render_size, distance=distance)
        views.append(render_tiled(
            gaussians["positions"], gaussians["scales"],
            gaussians["rotations"], gaussians["colors"],
            gaussians["opacities"], cam, config=cfg))
    return torch.stack(views)
