from fresnel_tpu_torch.render.projection import (
    GaussianProjection,
    compute_2d_covariance,
    conic_from_cov,
    depth_sort_indices,
    effective_radius,
    project_gaussians,
)
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled

__all__ = [
    "GaussianProjection",
    "TileRendererConfig",
    "compute_2d_covariance",
    "conic_from_cov",
    "depth_sort_indices",
    "effective_radius",
    "project_gaussians",
    "render_tiled",
]
