"""Procedural depth estimators and the depth-estimator factory.

Counterpart of the depth half of fresnel_tpu/models/encoders.py:
`gradient_depth_estimate` (luminance Sobel magnitude, blurred, blended
with a centre prior), `center_depth_estimate` (radial prior),
`FallbackDepthEstimator` and `create_depth_estimator`.  The real
Depth-Anything estimator with weights from disk is not ported: when
"auto" or "depth_anything" finds weights, `create_depth_estimator` raises
NotImplementedError rather than quietly using the gradient fallback.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from fresnel_tpu_torch.physics.fresnel_zones import sobel_gradients

_DEPTH_CANDIDATES = ("depth_anything_v2_small.pth",
                     "depth_anything_v2_small.pt",
                     "depth_anything_v2_small.safetensors",
                     "depth_anything_v2_small.bin",
                     "depth_anything.pth", "depth_anything.safetensors")
_LUMA = (0.299, 0.587, 0.114)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W) -> (..., out_h, out_w) bilinear with half-pixel centres,
    antialiased when downsampling: what jax.image.resize(..., "linear")
    does to the last two axes."""
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(1, -1, *x.shape[-2:]), size=(out_h, out_w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(*lead, out_h, out_w)


def _box_blur(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """(..., H, W) box blur: edge padding, then window means along H and
    then W."""
    pad = k // 2
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = F.pad(img.reshape(1, -1, H, W), (pad, pad, pad, pad),
              mode="replicate")
    x = x.unfold(2, k, 1).sum(-1) / k
    x = x.unfold(3, k, 1).sum(-1) / k
    return x.reshape(*lead, H, W)


def _center_prior(out_size: int, device) -> torch.Tensor:
    """1 - r / sqrt(2) over a [-1, 1]^2 grid: 1 at the centre."""
    ys = torch.linspace(-1.0, 1.0, out_size, device=device)
    YY, XX = torch.meshgrid(ys, ys, indexing="ij")
    return 1.0 - torch.sqrt(XX * XX + YY * YY) / math.sqrt(2.0)


def gradient_depth_estimate(image: torch.Tensor,
                            out_size: int = 256) -> torch.Tensor:
    """(H, W, 3) image in [0, 1] -> (out_size, out_size) depth in [0, 1]:
    strong edges read as closer, blended with a centre prior."""
    luma = torch.tensor(_LUMA, dtype=image.dtype, device=image.device)
    gray = (image * luma).sum(-1)
    gray = resize_linear(gray, out_size, out_size)
    gx, gy = sobel_gradients(gray)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-8)
    mag = _box_blur(mag, 7)
    mag = mag / torch.clamp(mag.max(), min=1e-6)
    depth = 0.6 * mag + 0.4 * _center_prior(out_size, image.device)
    lo, hi = depth.min(), depth.max()
    return (depth - lo) / torch.clamp(hi - lo, min=1e-6)


def center_depth_estimate(image: torch.Tensor,
                          out_size: int = 256) -> torch.Tensor:
    """Radial centre-prior depth (closer at the centre); ignores the
    image but for its device."""
    return _center_prior(out_size, image.device)


def _probe_weights(candidates) -> Optional[str]:
    """First existing candidate file under FRESNEL_TPU_MODELS (env),
    ./models or ~/models."""
    roots = [os.environ.get("FRESNEL_TPU_MODELS"), "models",
             os.path.join(os.path.expanduser("~"), "models")]
    for root in roots:
        if not root or not os.path.isdir(root):
            continue
        for name in candidates:
            path = os.path.join(root, name)
            if os.path.exists(path):
                return path
    return None


class FallbackDepthEstimator:
    """Procedural estimator: callable (image (H, W, 3), out_size=256) ->
    (out_size, out_size) depth, with `.kind` and `.weights_path`."""

    def __init__(self, kind: str):
        if kind not in ("gradient", "center"):
            raise ValueError(f"unknown fallback estimator: {kind}")
        self.kind = kind
        self.weights_path = None
        self._fn = (gradient_depth_estimate if kind == "gradient"
                    else center_depth_estimate)

    def __call__(self, image: torch.Tensor,
                 out_size: int = 256) -> torch.Tensor:
        return self._fn(image, out_size)


def create_depth_estimator(kind: str = "auto") -> FallbackDepthEstimator:
    """'auto' probes for Depth-Anything weights and falls back to the
    gradient estimator when there are none; 'gradient' and 'center' are
    the procedural estimators.  Found weights raise NotImplementedError:
    the weight-loaded Depth-Anything estimator is not ported."""
    if kind in ("auto", "depth_anything"):
        path = _probe_weights(_DEPTH_CANDIDATES)
        if path is not None:
            raise NotImplementedError(
                f"Depth-Anything weights found at {path}, but loading them "
                "is not ported (ROADMAP Queue 1, item 12); pass "
                "depth_estimator='gradient' to use the procedural estimator")
        if kind == "depth_anything":
            raise FileNotFoundError(
                "no Depth-Anything weights found (set FRESNEL_TPU_MODELS or "
                f"place one of {_DEPTH_CANDIDATES} under ./models)")
        return FallbackDepthEstimator("gradient")
    if kind in ("gradient", "center"):
        return FallbackDepthEstimator(kind)
    raise ValueError(f"unknown depth estimator: {kind}")
