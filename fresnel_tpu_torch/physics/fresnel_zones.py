"""Fresnel-zone utilities: only `sobel_gradients` is ported so far.

Counterpart of fresnel_tpu/physics/fresnel_zones.py::sobel_gradients,
which the gradient depth fallback uses.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel x / y gradients of (..., H, W) maps, zero padded to the same
    size (the JAX package's 3x3 convolution with SAME padding).

    The taps are small integers, so each map is a sum of shifted slices:
    exact float32 products on any device, and no cuDNN (whose float32
    convolutions may run in TF32)."""
    if not img.is_floating_point():
        img = img.to(torch.float32)
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = F.pad(img.reshape(-1, H, W), (1, 1, 1, 1))

    def tap(i, j):
        return x[:, i:i + H, j:j + W]

    # kx = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]; ky is its transpose.
    gx = (tap(0, 2) - tap(0, 0)) + 2.0 * (tap(1, 2) - tap(1, 0)) \
        + (tap(2, 2) - tap(2, 0))
    gy = (tap(2, 0) - tap(0, 0)) + 2.0 * (tap(2, 1) - tap(0, 1)) \
        + (tap(2, 2) - tap(0, 2))
    return gx.reshape(*lead, H, W), gy.reshape(*lead, H, W)
