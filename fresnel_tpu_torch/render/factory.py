"""Renderer selection: `make_renderer` by name and the training renderer.

Counterpart of fresnel_tpu/render/factory.py.  Each renderer renders one
cloud (`__call__`, the JAX signature) or a batch of B clouds in one launch
of each kernel (`batch`, what the trainer calls: `jax.vmap` of the JAX
renderer):
  "tile"     the tiled renderer (K1 / K2 on the card; with phases and
             `use_phase_blending`, K1-phi / K2-phi), which bins and so
             reports overflow telemetry;
  "wave"     the complex wave-field renderer (render/wave.py, K5 / K6),
             which needs phases;
  "fourier"  the HFGS Fourier renderer in its spatial mode
             (render/fourier.py, K5 / K6).
"dense", "asm", "simplified" and "fourier_true" raise NotImplementedError
(ROADMAP Queue 1, item 5).  `select_training_renderer` follows the JAX
package's routes over the config triple, in its order:
  hfgs.use_fourier_renderer     -> tiled, phase blending at amplitude 0.3
  experiment 4 + phase blending -> Fourier (spatial)
  physics.use_wave_rendering    -> wave field
  otherwise                     -> tiled, phase blending per the config
A tiled renderer with phase blending handed no phases (a decoder without
phase output) composites plain, as the JAX package's does.
"""

from __future__ import annotations

from fresnel_tpu_torch.render.fourier import (
    render_fourier, render_fourier_batched)
from fresnel_tpu_torch.render.tile import (
    TileRendererConfig,
    render_tiled,
    render_tiled_batched,
)
from fresnel_tpu_torch.render.wave import (
    render_wave_field, render_wave_field_batched)

NOT_PORTED = ("dense", "asm", "simplified", "fourier_true")


class TileRenderer:
    """The tiled renderer under one TileRendererConfig: `batch` renders B
    clouds through one pack (`render_tiled_batched`) with the capacity
    telemetry the trainer logs."""

    supports_overflow = True

    def __init__(self, max_per_tile: int = 256,
                 use_phase_blending: bool = False,
                 phase_amplitude: float = 0.25):
        self.config = TileRendererConfig(
            max_per_tile=max_per_tile, use_phase_blending=use_phase_blending,
            phase_amplitude=phase_amplitude)

    def batch(self, p, s, r, c, o, cameras, phases=None):
        """(images (B, 3, H, W), depth (B, H, W), overflow (B, 4))."""
        return render_tiled_batched(p, s, r, c, o, cameras,
                                    config=self.config, phases=phases)

    def __call__(self, p, s, r, c, o, cam, phases=None, return_depth=False,
                 return_overflow=False):
        return render_tiled(p, s, r, c, o, cam, phases=phases,
                            return_depth=return_depth,
                            return_overflow=return_overflow,
                            config=self.config)


class WaveRenderer:
    """The wave-field renderer; it needs phases and bins nothing."""

    supports_overflow = False

    def batch(self, p, s, r, c, o, cameras, phases=None):
        """(images (B, 3, H, W), depth (B, H, W), None)."""
        if phases is None:
            raise ValueError("wave renderer requires phases")
        img, depth = render_wave_field_batched(p, s, r, c, o, cameras,
                                               phases)
        return img, depth, None

    def __call__(self, p, s, r, c, o, cam, phases=None, return_depth=False):
        if phases is None:
            raise ValueError("wave renderer requires phases")
        return render_wave_field(p, s, r, c, o, cam, phases,
                                 return_depth=return_depth)


class FourierRenderer:
    """The Fourier renderer's spatial mode; it reads no phases and bins
    nothing."""

    supports_overflow = False

    def batch(self, p, s, r, c, o, cameras, phases=None):
        """(images (B, 3, H, W), depth (B, H, W) of zeros, None)."""
        img, depth = render_fourier_batched(p, s, r, c, o, cameras)
        return img, depth, None

    def __call__(self, p, s, r, c, o, cam, phases=None, return_depth=False):
        return render_fourier(p, s, r, c, o, cam, phases=phases,
                              return_depth=return_depth)


def make_renderer(name: str, *, use_phase_blending: bool = False,
                  phase_amplitude: float = 0.25, max_per_tile: int = 256,
                  **kw):
    """A renderer by name: tile | wave | fourier (dense, asm, simplified
    and fourier_true raise NotImplementedError)."""
    name = name.lower()
    if name == "tile":
        return TileRenderer(max_per_tile=max_per_tile,
                            use_phase_blending=use_phase_blending,
                            phase_amplitude=phase_amplitude)
    if name == "wave":
        return WaveRenderer()
    if name == "fourier":
        return FourierRenderer()
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"renderer {name!r} is not ported (ROADMAP Queue 1, item 5)")
    raise ValueError(f"unknown renderer: {name}")


def select_training_renderer(config, physics_config=None, hfgs_config=None):
    """The JAX package's renderer selection over the config triple."""
    mpt = getattr(config, "max_per_tile", 256)
    if hfgs_config is not None and hfgs_config.use_fourier_renderer:
        return make_renderer("tile", use_phase_blending=True,
                             phase_amplitude=0.3, max_per_tile=mpt)
    if config.experiment == 4 and config.use_phase_blending:
        return make_renderer("fourier")
    if physics_config is not None and physics_config.use_wave_rendering:
        return make_renderer("wave")
    return make_renderer("tile", use_phase_blending=config.use_phase_blending,
                         phase_amplitude=config.phase_amplitude,
                         max_per_tile=mpt)
