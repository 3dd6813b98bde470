"""Tracing / profiling utilities.

Counterpart of fresnel_tpu/utils/profiling.py.  The reference's
observability is std::chrono phase timers in the renderer and wall-clock
epoch prints (SURVEY.md §5.1).  Here:
  * RenderStats / render_with_stats: the renderer's stages (projection
    and depth sort, binning, the whole render with compositing) run one
    after the other, each timed on the host clock between two points
    where the card has finished its work (a synchronize on CUDA), with
    the Gaussian, tile and overflow counts;
  * trace(): a `torch.profiler` context that writes a Chrome trace;
  * StepTimer: EMA step timing for training loops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch


@dataclasses.dataclass
class RenderStats:
    project_ms: float = 0.0
    bin_ms: float = 0.0
    composite_ms: float = 0.0
    total_ms: float = 0.0
    num_gaussians: int = 0
    num_visible: int = 0
    num_tiles: int = 0
    # Capacity telemetry: (gaussian, tile) pairs dropped by the static
    # max_per_tile cap, tiles over cap, and the largest tile's hit count.
    dropped_pairs: int = 0
    total_pairs: int = 0
    overflow_tiles: int = 0
    max_tile_hits: int = 0

    def __str__(self):
        return (f"render: {self.total_ms:.2f} ms "
                f"(project {self.project_ms:.2f} | bin {self.bin_ms:.2f} | "
                f"composite {self.composite_ms:.2f}) "
                f"{self.num_visible}/{self.num_gaussians} gaussians, "
                f"{self.num_tiles} tiles, "
                f"overflow {self.dropped_pairs}/{self.total_pairs} pairs "
                f"({self.overflow_tiles} tiles over cap, "
                f"max {self.max_tile_hits}/tile)")


def _settle(device: torch.device) -> float:
    """The host clock once `device` has finished its queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def render_with_stats(positions, scales, rotations, colors, opacities,
                      camera, config=None) -> tuple:
    """Stage-timed render: returns (image, RenderStats).

    Runs projection + depth sort, binning (`config.binning`: K3 under
    "search", K4 under "stream" on the card) and the whole
    `render_tiled(return_overflow=True)` one after the other to
    attribute time per stage (`render_tiled` does the first two again;
    use this for diagnostics only)."""
    from fresnel_tpu_torch.render.projection import (
        depth_sort_indices, project_gaussians)
    from fresnel_tpu_torch.render.tile import (
        TileRendererConfig, _check_supported, _layout, bin_tiles,
        render_tiled)

    cfg = config or TileRendererConfig()
    _check_supported(cfg)
    dev = positions.device
    stats = RenderStats(num_gaussians=positions.shape[0])
    ntx, nty, m_cap = _layout(cfg, camera, positions.shape[0])
    stats.num_tiles = ntx * nty

    with torch.no_grad():
        t0 = _settle(dev)
        proj = project_gaussians(
            positions, scales, rotations, camera,
            max_radius=min(cfg.max_radius,
                           (cfg.tile_window // 2) * cfg.tile_size))
        visible = proj.visible & (opacities > 0)
        order = depth_sort_indices(proj.replace(visible=visible))
        t1 = _settle(dev)
        stats.project_ms = (t1 - t0) * 1000
        stats.num_visible = int(visible.sum())

        t0 = _settle(dev)
        bin_tiles(proj.means2d[order], proj.radii[order], visible[order],
                  ntx, nty, m_cap, cfg)
        t1 = _settle(dev)
        stats.bin_ms = (t1 - t0) * 1000

    t0 = _settle(dev)
    img, ovf = render_tiled(positions, scales, rotations, colors, opacities,
                            camera, config=cfg, return_overflow=True)
    t1 = _settle(dev)
    stats.composite_ms = (t1 - t0) * 1000
    stats.total_ms = stats.project_ms + stats.bin_ms + stats.composite_ms
    (stats.dropped_pairs, stats.total_pairs, stats.overflow_tiles,
     stats.max_tile_hits) = (int(x) for x in ovf.tolist())
    return img, stats


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """`torch.profiler` over the block (the card's kernels too when CUDA
    is available); on exit a Chrome trace (chrome://tracing, Perfetto)
    is written into `log_dir` (default: fresnel_trace under the temporary
    directory).  Yields `log_dir`."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "fresnel_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """EMA step timing + throughput for training loops."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.ema_s: Optional[float] = None
        self._t0: Optional[float] = None

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.ema_s = (dt if self.ema_s is None
                      else self.momentum * self.ema_s + (1 - self.momentum) * dt)
        return dt

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.ema_s if self.ema_s else 0.0
