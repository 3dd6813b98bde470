"""Single image -> 3D Gaussian splats -> verification render.

Counterpart of bench.py's `image_to_3dgs`: resize the image to 518^2, run
DINOv2 (ViT-S/14) for features and Depth-Anything (ViT-S + DPT) for depth,
decode K = 4 Gaussians per patch with DirectPatchDecoder (5 476 Gaussians)
and render them at 512^2 with the tiled rasterizer, whose compositing runs
on the hand-written CUDA kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
from fresnel_tpu_torch.models.vit import DINOv2, DepthAnything
from fresnel_tpu_torch.render.tile import render_tiled
from fresnel_tpu_torch.weights import init_flax_like_

IMAGE_SIZE = 518
RENDER_SIZE = 512
GAUSSIANS_PER_PATCH = 4


@dataclasses.dataclass
class Models:
    dino: DINOv2
    depth: DepthAnything
    decoder: DirectPatchDecoder


def build_models(seed: int = 0, device: Optional[Union[str, torch.device]] = None,
                 dtype: torch.dtype = torch.bfloat16) -> Models:
    """The three models of the path at full width (ViT-S/14 x 2, decoder
    K = 4), with random Flax-like weights drawn from a torch.Generator
    seeded with `seed`.  `dtype` is the ViTs' compute dtype (bf16 as in
    bench.py; parameters stay float32).  Defaults to CUDA."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    dino = init_flax_like_(DINOv2(dtype=dtype), g)
    depth = init_flax_like_(DepthAnything(dtype=dtype), g)
    decoder = init_flax_like_(
        DirectPatchDecoder(gaussians_per_patch=GAUSSIANS_PER_PATCH), g)
    return Models(dino=dino.to(dev).eval(), depth=depth.to(dev).eval(),
                  decoder=decoder.to(dev).eval())


def resize_to_model(image: torch.Tensor, size: int = IMAGE_SIZE
                    ) -> torch.Tensor:
    """(H, W, 3) -> (1, size, size, 3), plain bilinear with half-pixel
    centres: what jax.image.resize(..., "linear") does when upsampling."""
    x = image.permute(2, 0, 1)[None]
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def image_to_3dgs(models: Models, image: torch.Tensor,
                  camera: Optional[Camera] = None,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 3) image in [0, 1] -> (positions (1, N, 3), image (3, 512,
    512)).  Runs on `device` (CUDA by default; the models must be there)."""
    dev = resolve_device(device)
    if camera is None:
        camera = Camera.default_training(RENDER_SIZE)
    x = resize_to_model(image.to(dev, torch.float32), models.dino.image_size)
    feats = models.dino(x)                              # (1, 37, 37, 384)
    depth = models.depth(x)                             # (1, 256, 256)
    out = models.decoder(feats, depth)
    img = render_tiled(out["positions"][0], out["scales"][0],
                       out["rotations"][0], out["colors"][0],
                       out["opacities"][0], camera)
    return out["positions"], img
