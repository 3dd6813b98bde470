"""Training renderer selection.

Counterpart of fresnel_tpu/render/factory.py::select_training_renderer,
"tile" route only: the tiled renderer (K1 forward, K2 backward on CUDA
tensors) with the config's `max_per_tile`.  The routes to the Fourier and
wave-field renderers and phase blending raise NotImplementedError (ROADMAP
Queue 1, item 5).
"""

from __future__ import annotations

from fresnel_tpu_torch.render.tile import (
    TileRendererConfig,
    render_tiled_batched,
)


class TileRenderer:
    """The tiled renderer under one TileRendererConfig, for a batch: `batch`
    renders B clouds through one pack (`render_tiled_batched`), with the
    capacity telemetry the trainer logs."""

    def __init__(self, max_per_tile: int = 256):
        self.config = TileRendererConfig(max_per_tile=max_per_tile)

    def batch(self, p, s, r, c, o, cameras):
        """(images (B, 3, H, W), depth (B, H, W), overflow (B, 4))."""
        return render_tiled_batched(p, s, r, c, o, cameras,
                                    config=self.config)


def select_training_renderer(config, physics_config=None,
                             hfgs_config=None) -> TileRenderer:
    """The reference's renderer selection over the config triple; only its
    default, the tiled renderer without phase blending, is ported."""
    routes = {
        "hfgs.use_fourier_renderer (tiled with phase blending)":
            hfgs_config is not None and hfgs_config.use_fourier_renderer,
        "experiment 4 with use_phase_blending (Fourier)":
            config.experiment == 4 and config.use_phase_blending,
        "physics.use_wave_rendering (wave field)":
            physics_config is not None and physics_config.use_wave_rendering,
        "use_phase_blending": config.use_phase_blending,
    }
    on = [k for k, v in routes.items() if v]
    if on:
        raise NotImplementedError(
            f"training renderer routes not ported: {on} (ROADMAP Queue 1, "
            "item 5)")
    return TileRenderer(max_per_tile=getattr(config, "max_per_tile", 256))
