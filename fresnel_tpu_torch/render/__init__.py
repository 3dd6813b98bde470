"""Renderers of Gaussian clouds (counterpart of fresnel_tpu/render/):
the tiled renderer, the dense golden reference, the simplified point
splats, the wave-field, angular-spectrum and Fourier renderers, and the
factory that picks one by name."""

from fresnel_tpu_torch.render.asm import (
    AngularSpectrumPropagator,
    render_asm_wave_field,
)
from fresnel_tpu_torch.render.dense import render_dense
from fresnel_tpu_torch.render.factory import (
    make_renderer,
    select_training_renderer,
)
from fresnel_tpu_torch.render.fourier import render_fourier
from fresnel_tpu_torch.render.projection import (
    GaussianProjection,
    compute_2d_covariance,
    conic_from_cov,
    depth_sort_indices,
    effective_radius,
    project_gaussians,
)
from fresnel_tpu_torch.render.simplified import render_simplified
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled
from fresnel_tpu_torch.render.wave import render_wave_field

__all__ = [
    "AngularSpectrumPropagator",
    "GaussianProjection",
    "TileRendererConfig",
    "compute_2d_covariance",
    "conic_from_cov",
    "depth_sort_indices",
    "effective_radius",
    "make_renderer",
    "project_gaussians",
    "render_asm_wave_field",
    "render_dense",
    "render_fourier",
    "render_simplified",
    "render_tiled",
    "render_wave_field",
    "select_training_renderer",
]
