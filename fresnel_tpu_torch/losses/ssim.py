"""SSIM (Wang et al.) with an 11-tap Gaussian window, sigma 1.5.

Counterpart of fresnel_tpu/losses/ssim.py (`ssim`, `ssim_loss`,
`ms_ssim`), with the usual K1 = 0.01, K2 = 0.03 stabilisers and the window
shrink for images smaller than the window.

The Gaussian window is the outer product of one 1-D tap vector, so the
valid filter runs as two 1-D passes (rows, then columns) of elementwise
multiply-adds over `unfold` views.  That keeps it in full float32 on any
device whatever the TF32 flags say: a cuDNN convolution may run in TF32
(`torch.backends.cudnn.allow_tf32` is True by default), and reduced
precision in the filter breaks the E[x^2] - E[x]^2 cancellation of the
variance terms, which once gave SSIM values of -7.4 on smooth images
(the JAX package's T-017).
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    """Normalised 1-D taps (size,) float32; the JAX package's 2-D window
    is np.outer(taps, taps)."""
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / np.sum(g)


def _filter2d(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Valid 2-D filter of (B, C, H, W) with the window outer(taps, taps),
    as two separable passes."""
    w = torch.as_tensor(taps, dtype=img.dtype, device=img.device)
    k = w.numel()
    x = (img.unfold(2, k, 1) * w).sum(-1)           # (B, C, H-k+1, W)
    return (x.unfold(3, k, 1) * w).sum(-1)          # (B, C, H-k+1, W-k+1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         window_size: int = 11, sigma: float = 1.5,
         size_average: bool = True) -> torch.Tensor:
    """SSIM between (B, C, H, W) images (or (C, H, W), batched here)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    # Images smaller than the window would make the valid filter empty:
    # shrink the window to the largest odd size that fits.
    min_side = min(img1.shape[-2], img1.shape[-1])
    if min_side < window_size:
        window_size = max(1, min_side - (min_side + 1) % 2)
    w = _gaussian_window(window_size, sigma)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2

    mu1 = _filter2d(img1, w)
    mu2 = _filter2d(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    # True variances are nonnegative; clamp away float32 cancellation noise.
    sigma1_sq = torch.clamp(_filter2d(img1 * img1, w) - mu1_sq, min=0.0)
    sigma2_sq = torch.clamp(_filter2d(img2 * img2, w) - mu2_sq, min=0.0)
    sigma12 = _filter2d(img1 * img2, w) - mu12

    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor,
              data_range: float = 1.0) -> torch.Tensor:
    return 1.0 - ssim(img1, img2, data_range=data_range)


def _downsample(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 VALID average pool of the last two axes (an odd last row or
    column is dropped), summed in the window's row-major order."""
    H, W = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :H, :W]
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
            + x[..., 1::2, 1::2]) / 4.0


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
            weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
            window_size: int = 11) -> torch.Tensor:
    """Multi-scale SSIM over up to five dyadic scales with the standard
    weights.  Levels whose side would fall under the window are dropped
    and the remaining weights renormalised (the window itself shrinks as
    in `ssim` when level 0 is smaller); each level's value is floored at
    1e-6 before the weighted product."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    min_side = min(img1.shape[-2], img1.shape[-1])
    if min_side < window_size:
        window_size = max(1, min_side - (min_side + 1) % 2)
    w = _gaussian_window(window_size, 1.5)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    usable = 1
    while (usable < len(weights)
           and min_side // (2 ** usable) >= window_size):
        usable += 1
    wts = torch.tensor(weights[:usable], dtype=torch.float32,
                       device=img1.device)
    wts = wts / wts.sum()

    vals = []
    a, b = img1, img2
    for lvl in range(usable):
        mu1, mu2 = _filter2d(a, w), _filter2d(b, w)
        s1 = torch.clamp(_filter2d(a * a, w) - mu1 * mu1, min=0.0)
        s2 = torch.clamp(_filter2d(b * b, w) - mu2 * mu2, min=0.0)
        s12 = _filter2d(a * b, w) - mu1 * mu2
        if lvl < usable - 1:
            vals.append(((2 * s12 + C2) / (s1 + s2 + C2)).mean())
            a, b = _downsample(a), _downsample(b)
        else:
            vals.append((((2 * mu1 * mu2 + C1) * (2 * s12 + C2))
                         / ((mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))
                         ).mean())
    vals = torch.clamp(torch.stack(vals), min=1e-6)
    return torch.prod(vals ** wts)
