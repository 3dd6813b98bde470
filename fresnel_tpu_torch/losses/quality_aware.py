"""Quality-aware losses for Gaussian-bootstrap CVS training.

Counterpart of fresnel_tpu/losses/quality_aware.py: bootstrap targets are
Gaussian renders with artifacts, so regions whose rendered-depth Laplacian
flags splat artifacts are down-weighted.

  * depth_laplacian  5-point |Laplacian| of depth, edge padding;
  * quality_mask     sigmoid(-sharpness * (laplacian - threshold));
  * gradient_penalty TV penalty, optionally quality-masked;
  * consistency_weight_schedule  staircase 0.1 / 0.3 / 1.0 at the 1/3 and
    2/3 marks;
  * quality_aware_cvs_loss  masked L1 + gradient penalty + the scheduled
    consistency term.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


def depth_laplacian(depth: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> |5-point Laplacian| with edge padding."""
    d = F.pad(depth[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    lap = (d[:, :-2, 1:-1] + d[:, 2:, 1:-1] + d[:, 1:-1, :-2]
           + d[:, 1:-1, 2:] - 4.0 * d[:, 1:-1, 1:-1])
    return torch.abs(lap)


def quality_mask(rendered_depth: torch.Tensor, threshold: float = 0.1,
                 sharpness: float = 10.0) -> torch.Tensor:
    """(B, H, W) depth -> (B, H, W) quality in [0, 1] (1 = trustworthy)."""
    return torch.sigmoid(-sharpness * (depth_laplacian(rendered_depth)
                                       - threshold))


def gradient_penalty(image: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TV penalty on (B, C, H, W), optionally weighted by a (B, H, W)
    mask."""
    gx = torch.abs(image[..., :, 1:] - image[..., :, :-1])
    gy = torch.abs(image[..., 1:, :] - image[..., :-1, :])
    if mask is not None:
        return (torch.mean(gx * mask[:, None, :, 1:])
                + torch.mean(gy * mask[:, None, 1:, :]))
    return torch.mean(gx) + torch.mean(gy)


def consistency_weight_schedule(epoch: int, total_epochs: int) -> float:
    """Staircase ramp: bootstrap data is noisy, so consistency pressure
    grows only once reconstruction has stabilised."""
    progress = epoch / max(total_epochs, 1)
    if progress < 1 / 3:
        return 0.1
    if progress < 2 / 3:
        return 0.3
    return 1.0


def quality_aware_cvs_loss(
    x0_pred: torch.Tensor,                       # (B, 3, H, W)
    target: torch.Tensor,                        # (B, 3, H, W)
    target_depth: Optional[torch.Tensor] = None,  # (B, H, W)
    x0_ema: Optional[torch.Tensor] = None,
    consistency_weight: float = 1.0,
    lambda_gradient: float = 0.05,
    threshold: float = 0.1,
) -> Dict[str, torch.Tensor]:
    ld: Dict[str, torch.Tensor] = {}
    if target_depth is not None:
        qm = quality_mask(target_depth, threshold=threshold)
        l1 = torch.mean(torch.abs(x0_pred - target) * qm[:, None])
        ld["quality_coverage"] = torch.mean(qm)
    else:
        qm = None
        l1 = torch.mean(torch.abs(x0_pred - target))
    ld["l1"] = l1
    ld["gradient"] = gradient_penalty(x0_pred, qm) * lambda_gradient
    total = l1 + ld["gradient"]
    if x0_ema is not None:
        cons = torch.mean((x0_pred - x0_ema.detach()) ** 2)
        ld["consistency"] = cons * consistency_weight
        total = total + ld["consistency"]
    ld["total"] = total
    return ld
