"""Novel-view evaluation: orbit cameras, per-view SSIM and coverage,
view consistency.

Counterpart of fresnel_tpu/evaluation/novel_view_eval.py: 8 azimuth
cameras around the subject (one K1 launch each on the card), frontal
SSIM / PSNR against the target, per-view coverage (the share of pixels
whose channel mean is above 0.01), view_consistency (the mean over samples
of the standard deviation of coverage across azimuths; lower is better),
the frontal spectrum's per-band power ratio, and with GT orbit views
(corpus_v2) per-view SSIM / PSNR, side-view and novel-view SSIM.  The same
JSON keys, key order and rounding as the JAX package's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.evaluation.spectrum import (
    band_labels, band_power_ratio)
from fresnel_tpu_torch.evaluation.visual_eval import (
    compute_psnr, compute_ssim, resize_to)
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


def evaluate_novel_views(
    samples: List[Dict],
    render_size: int = 256,
    azimuths_deg: Sequence[float] = DEFAULT_AZIMUTHS_DEG,
    output_json: Optional[str] = None,
    max_per_tile: int = 256,
) -> Dict:
    """Each sample: {"gaussians": dict of tensors, "target": (3, S, S)
    image in [0, 1]}, optionally "views": (V, 3, S, S) GT orbit views at
    `azimuths_deg`.  Returns per_view_coverage, frontal_ssim, frontal_psnr,
    view_consistency, num_samples, spectrum_band_ratio, and with GT views
    per_view_ssim, per_view_psnr, side_view_ssim (90 and 270) and
    novel_view_ssim (every non-frontal view); also written to
    `output_json` when given."""
    per_view: Dict[str, List[float]] = {str(az): [] for az in azimuths_deg}
    pv_ssim: Dict[str, List[float]] = {str(az): [] for az in azimuths_deg}
    pv_psnr: Dict[str, List[float]] = {str(az): [] for az in azimuths_deg}
    frontal_ssim, frontal_psnr = [], []
    spec_ratios: List[np.ndarray] = []
    coverage_matrix = []                 # (samples, views)

    for s in samples:
        with torch.no_grad():
            views = render_views(s["gaussians"], render_size, azimuths_deg,
                                 max_per_tile=max_per_tile)
        coverages = [float(torch.mean(
            (torch.mean(v, 0) > 0.01).to(torch.float32))) for v in views]
        coverage_matrix.append(coverages)
        for az, cov in zip(azimuths_deg, coverages):
            per_view[str(az)].append(cov)
        dev = views.device
        target = resize_to(torch.as_tensor(
            np.asarray(s["target"]), dtype=torch.float32, device=dev),
            render_size)
        frontal_ssim.append(compute_ssim(views[0], target))
        frontal_psnr.append(compute_psnr(views[0], target))
        spec_edges, ratio = band_power_ratio(views[0].cpu().numpy(),
                                             target.cpu().numpy())
        spec_ratios.append(ratio)
        gt_views = s.get("views")
        if gt_views is not None:
            gt_views = resize_to(torch.as_tensor(
                np.asarray(gt_views), dtype=torch.float32, device=dev),
                render_size)
            for az, rv, gv in zip(azimuths_deg, views, gt_views):
                pv_ssim[str(az)].append(compute_ssim(rv, gv))
                pv_psnr[str(az)].append(compute_psnr(rv, gv))

    cov = np.asarray(coverage_matrix)
    results = {
        "per_view_coverage": {k: float(np.mean(v))
                              for k, v in per_view.items()},
        "frontal_ssim": float(np.mean(frontal_ssim)),
        "frontal_psnr": float(np.mean(frontal_psnr)),
        "view_consistency": float(np.mean(np.std(cov, axis=1)))
        if len(cov) else 0.0,
        "num_samples": len(samples),
    }
    if spec_ratios:
        results["spectrum_band_ratio"] = {
            k: round(float(v), 4)
            for k, v in zip(band_labels(spec_edges),
                            np.mean(spec_ratios, axis=0))}
    if any(pv_ssim[k] for k in pv_ssim):
        results["per_view_ssim"] = {
            k: float(np.mean(v)) for k, v in pv_ssim.items() if v}
        results["per_view_psnr"] = {
            k: float(np.mean(v)) for k, v in pv_psnr.items() if v}
        side = [np.mean(pv_ssim[k]) for k in ("90.0", "270.0")
                if pv_ssim.get(k)] or \
               [np.mean(pv_ssim[k]) for k in ("90", "270") if pv_ssim.get(k)]
        nonfrontal = [v for k, v in results["per_view_ssim"].items()
                      if float(k) != 0.0]
        results["side_view_ssim"] = float(np.mean(side)) if side else None
        results["novel_view_ssim"] = (float(np.mean(nonfrontal))
                                      if nonfrontal else None)
    if output_json:
        Path(output_json).parent.mkdir(parents=True, exist_ok=True)
        Path(output_json).write_text(json.dumps(results, indent=2))
    return results
