"""Bidirectional Chamfer Gaussian-matching loss (v2 distillation).

Counterpart of fresnel_tpu/losses/matching.py: the forward direction
matches every prediction to its nearest target (quality), the backward
direction every target to its nearest prediction (coverage); the terms
are position / scale / colour / opacity MSE, the quaternion distance
1 - |q . q'|, and a weighted coverage bundle.

Batched over B as the JAX package's vmap batches it: invalid entries
(zero position and zero opacity, or masked) get +inf distance so they
are never matched, and masked means replace filtering.  Distances are
sum((a - b)^2) over the last axis, in that order, on the full (B, Na,
Nb, 3) difference: `torch.cdist` switches to the |a|^2 + |b|^2 - 2 a.b
form above 25 rows, which rounds differently and flips argmin at
near-ties.  argmin ties go to the lower index.  The optional subsample
to `max_match_points` takes floor(arange(k) * (n / k)) in float32, as
JAX rounds it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MatchingWeights:
    position: float = 10.0
    scale: float = 5.0
    rotation: float = 2.0
    color: float = 5.0
    opacity: float = 3.0
    coverage: float = 1.0


def _valid_mask(g: torch.Tensor, extra: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Zero-padded Gaussians (zero position AND opacity) are invalid."""
    v = (g[..., :3].abs().sum(-1) > 1e-6) | (g[..., 13].abs() > 1e-6)
    if extra is not None:
        v = v & extra.bool()
    return v


def _subsample(g: torch.Tensor, mask: torch.Tensor, k: int):
    """(B, n, ...) -> (B, k, ...) at a fixed float32 stride when n > k."""
    n = g.shape[1]
    if n <= k:
        return g, mask
    stride = torch.tensor(n / k, dtype=torch.float32)
    idx = torch.floor(torch.arange(k, dtype=torch.float32) * stride).to(
        device=g.device, dtype=torch.long)
    return g[:, idx], mask[:, idx]


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, Na, 3), (B, Nb, 3) -> (B, Na, Nb): sum of squared differences
    over the last axis, x then y then z."""
    diff = a[:, :, None, :] - b[:, None, :, :]
    sq = diff * diff
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def _nearest(a_pos, b_pos, b_valid):
    """For each a: index of the nearest valid b (lowest index on ties)."""
    d2 = _sq_dist(a_pos, b_pos)
    d2 = torch.where(b_valid[:, None, :], d2, torch.full_like(d2, torch.inf))
    return torch.argmin(d2, dim=2)


def _take(g: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """g (B, N, F) gathered at idx (B, M) -> (B, M, F)."""
    return torch.gather(g, 1, idx[..., None].expand(-1, -1, g.shape[-1]))


def _masked_mse(a, b, mask):
    """(B,): the mean over valid rows of sum((a - b)^2, -1), per feature."""
    se = ((a - b) ** 2).sum(-1)
    denom = torch.clamp(mask.sum(-1).to(a.dtype), min=1.0)
    return torch.where(mask, se, torch.zeros_like(se)).sum(-1) / (
        denom * a.shape[-1])


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.sqrt((q * q).sum(-1, keepdim=True)),
                           min=1e-8)


def gaussian_matching_loss(
    pred: torch.Tensor,                    # (B, Np, 14)
    target: torch.Tensor,                  # (B, Nt, 14)
    pred_mask: Optional[torch.Tensor] = None,
    target_mask: Optional[torch.Tensor] = None,
    weights: MatchingWeights = MatchingWeights(),
    max_match_points: int = 4096,
) -> Dict[str, torch.Tensor]:
    """Batch means of the total and of each term: "total", "position",
    "scale", "rotation", "color", "opacity", "coverage".  Rows are
    position (3), scale (3), quaternion (4), colour (3), opacity (1)."""
    w = weights
    p, t = pred, target
    pv = _valid_mask(p, pred_mask)
    tv = _valid_mask(t, target_mask)
    p, pv = _subsample(p, pv, max_match_points)
    t, tv = _subsample(t, tv, max_match_points * 2)

    # Forward: predictions -> nearest targets (quality).
    tm = _take(t, _nearest(p[..., :3], t[..., :3], tv))
    pos_l = _masked_mse(p[..., :3], tm[..., :3], pv)
    scale_l = _masked_mse(p[..., 3:6], tm[..., 3:6], pv)
    qdot = (_unit(p[..., 6:10]) * _unit(tm[..., 6:10])).sum(-1).abs()
    rot_l = torch.where(pv, 1.0 - qdot, torch.zeros_like(qdot)).sum(-1) / (
        torch.clamp(pv.sum(-1).to(p.dtype), min=1.0))
    color_l = _masked_mse(p[..., 10:13], tm[..., 10:13], pv)
    op_l = _masked_mse(p[..., 13:14], tm[..., 13:14], pv)

    # Backward: targets -> nearest predictions (coverage).
    pm = _take(p, _nearest(t[..., :3], p[..., :3], pv))
    cov = (2.0 * _masked_mse(t[..., :3], pm[..., :3], tv)
           + 0.5 * _masked_mse(t[..., 3:6], pm[..., 3:6], tv)
           + 0.5 * _masked_mse(t[..., 10:13], pm[..., 10:13], tv)
           + 2.0 * _masked_mse(t[..., 13:14], pm[..., 13:14], tv))

    total = (w.position * pos_l + w.scale * scale_l + w.rotation * rot_l
             + w.color * color_l + w.opacity * op_l + w.coverage * cov)
    return {"total": total.mean(), "position": pos_l.mean(),
            "scale": scale_l.mean(), "rotation": rot_l.mean(),
            "color": color_l.mean(), "opacity": op_l.mean(),
            "coverage": cov.mean()}


def occupancy_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked binary cross-entropy on occupancy logits."""
    loss = (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    if mask is not None:
        return torch.where(mask.bool(), loss, torch.zeros_like(loss)).sum() / (
            torch.clamp(mask.sum().to(loss.dtype), min=1.0))
    return loss.mean()


def proximity_occupancy_targets(coords: torch.Tensor,
                                gaussian_positions: torch.Tensor,
                                coord_valid: torch.Tensor,
                                gauss_valid: torch.Tensor,
                                threshold: float = 0.15,
                                grid_resolution: int = 64) -> torch.Tensor:
    """(N,) float32: a voxel (coords (N, 4), the last three its grid
    index) is occupied if a valid Gaussian (positions (M, 3)) lies within
    `threshold` (in [-1, 1] units) of its centre."""
    centers = coords[..., 1:4].to(torch.float32) / grid_resolution * 2 - 1
    d2 = _sq_dist(centers[None], gaussian_positions[None])[0]
    d2 = torch.where(gauss_valid.bool()[None, :], d2,
                     torch.full_like(d2, torch.inf))
    occ = d2.min(dim=1).values < threshold ** 2
    return (occ & coord_valid.bool()).to(torch.float32)
