"""Shared utilities: bf16 mixed precision (`precision`), render stage
timing, the profiler trace and a step timer (`profiling`), and host image
helpers (`image`).  `vlm_guidance` is not ported."""

from fresnel_tpu_torch.utils.image import (
    depth_colormap, load_ppm, normalize_depth, resize, save_png, save_ppm)
from fresnel_tpu_torch.utils.profiling import (
    RenderStats, StepTimer, render_with_stats, trace)

__all__ = [
    "RenderStats", "render_with_stats", "trace", "StepTimer",
    "depth_colormap", "normalize_depth", "save_ppm", "load_ppm", "save_png",
    "resize",
]
