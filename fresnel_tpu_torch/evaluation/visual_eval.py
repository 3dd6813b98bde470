"""Visual evaluation: rendered-against-target SSIM and PSNR.

Counterpart of fresnel_tpu/evaluation/visual_eval.py: the frontal training
camera, the SSIM comparator and PSNR.  Targets of another size are resized
with the port's `resize_linear` (the JAX package's linear resize,
antialiased when downsampling), never `F.interpolate`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.losses.ssim import ssim
from fresnel_tpu_torch.models.encoders import resize_linear
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled


def compute_ssim(img1, img2) -> float:
    """SSIM between (3, H, W) or (B, 3, H, W) images in [0, 1]."""
    return float(ssim(torch.as_tensor(img1), torch.as_tensor(img2)))


def compute_psnr(img1, img2) -> float:
    """PSNR in dB of images in [0, 1]; 99.0 when the mean squared error is
    at most 1e-12."""
    mse = float(torch.mean((torch.as_tensor(img1)
                            - torch.as_tensor(img2)) ** 2))
    if mse <= 1e-12:
        return 99.0
    return float(10.0 * math.log10(1.0 / mse))


def resize_to(img: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W) -> (..., size, size) by `resize_linear`, unchanged when
    it is that size already."""
    if img.shape[-1] == size and img.shape[-2] == size:
        return img
    return resize_linear(img, size, size)


class VisualEvaluator:
    """Renders a Gaussian dict from the frontal training camera and scores
    it against a target image.  `max_per_tile` is the training default,
    256: a decoder is scored under the compositing cap it was trained
    with."""

    def __init__(self, render_size: int = 256, max_per_tile: int = 256):
        self.render_size = render_size
        self.camera = Camera.default_training(render_size)
        self.cfg = TileRendererConfig(max_per_tile=max_per_tile)

    def render(self, gaussians: Dict[str, torch.Tensor],
               camera: Optional[Camera] = None) -> torch.Tensor:
        cam = camera or self.camera
        with torch.no_grad():
            return render_tiled(
                gaussians["positions"], gaussians["scales"],
                gaussians["rotations"], gaussians["colors"],
                gaussians["opacities"], cam, config=self.cfg)

    def evaluate(self, gaussians: Dict[str, torch.Tensor],
                 target) -> Dict[str, float]:
        """target: (3, H, W) in [0, 1] -> ssim, psnr and coverage."""
        img = self.render(gaussians)
        target = resize_to(torch.as_tensor(target, dtype=torch.float32,
                                           device=img.device),
                           self.render_size)
        return {
            "ssim": compute_ssim(img, target),
            "psnr": compute_psnr(img, target),
            "coverage": float(torch.mean(
                (torch.mean(img, dim=0) > 0.01).to(torch.float32))),
        }
