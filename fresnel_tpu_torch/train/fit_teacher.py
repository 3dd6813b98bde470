"""Per-scene Gaussian fit in the decoder's raw head space (`fresnel refine`).

Counterpart of fresnel_tpu/train/fit_teacher.py, experiment 2: raw head
values (1, grid, grid, K, 16) pass through `head_transform` (the
DirectPatchDecoder's output transform, Z locked to depth) and the tiled
rasterizer, and Adam fits them, with the depth offset unless it is fixed,
to one image under L1 + 0.5 * (1 - SSIM).  On CUDA every step composites
through the forward kernel K1 and back through the backward kernel K2.

Differences from the JAX function: no `step_fn_cache` (there is no jit
compile to reuse), a `device` argument (None means CUDA), experiment 4
(the Fibonacci spiral head) raises NotImplementedError, and the metrics
carry the loss of every step.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.losses.ssim import ssim
from fresnel_tpu_torch.models.decoders import head_transform
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled

OPG = 16                     # outputs per Gaussian (no phase head)
IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def teacher_path(img_path: Path, experiment: int = 2) -> Path:
    """Sidecar path `{stem}_teacher.npz` (experiment 2) or
    `{stem}_teacher{experiment}.npz`."""
    suffix = "_teacher.npz" if experiment == 2 else f"_teacher{experiment}.npz"
    return img_path.with_name(img_path.stem + suffix)


def init_raw(image: np.ndarray, depth: np.ndarray, camera: Camera, *,
             grid: int = 37, K: int = 4,
             head_kwargs: Optional[dict] = None) -> np.ndarray:
    """Surface init in raw head space: K Gaussians per patch on a sub-grid,
    sigma ~= the sub-grid pitch, opacity ~0.82, colours sampled from the
    (3, H, W) image at each Gaussian's projected pixel.  Runs on the CPU,
    so the card and the CPU start from the same init."""
    raw = np.zeros((1, grid, grid, K, OPG), np.float32)
    pitch = 2.0 / (grid - 1)
    side = int(np.ceil(np.sqrt(K)))
    offs = (np.arange(side) - (side - 1) / 2.0) * (pitch / side)
    oy, ox = np.meshgrid(offs, offs, indexing="ij")
    sub = np.stack([ox.ravel(), oy.ravel()], -1)[:K]            # (K, 2)
    raw[..., 0] = sub[:, 0] / 0.25
    raw[..., 1] = sub[:, 1] / 0.25
    # sigma = softplus(raw_scale + 1) * 0.15  ->  raw for sigma = pitch/side.
    target_sigma = pitch / side
    raw[..., 3:6] = np.log(np.expm1(target_sigma / 0.15)) - 1.0
    raw[..., 6:12] = IDENTITY_6D
    raw[..., 15] = 1.5                                          # op ~0.82

    out = head_transform(torch.from_numpy(raw),
                         torch.from_numpy(np.array(depth, np.float32))[None],
                         torch.tensor(-2.0), **(head_kwargs or {}))
    uv, _ = camera.to("cpu").project(out["positions"][0])
    uv = uv.numpy()
    # numpy rounding (half to even), as the JAX package does.
    u = np.clip(uv[:, 0].round().astype(int), 0, image.shape[2] - 1)
    v = np.clip(uv[:, 1].round().astype(int), 0, image.shape[1] - 1)
    col = image[:, v, u].T                                      # (N, 3)
    logit = np.log(np.clip(col, 1e-3, 1 - 1e-3)
                   / np.clip(1 - col, 1e-3, 1.0))
    raw[..., 12:15] = logit.reshape(grid, grid, K, 3)
    return raw


def render_raw(raw: torch.Tensor, depth: torch.Tensor,
               depth_offset: torch.Tensor, camera: Camera,
               config: TileRendererConfig,
               head_kwargs: Optional[dict] = None) -> torch.Tensor:
    """Raw head values (1, g, g, K, 16) and depth (1, H, W) -> the
    (3, res, res) render of the cloud they decode to."""
    out = head_transform(raw, depth, depth_offset, **(head_kwargs or {}))
    return render_tiled(out["positions"][0], out["scales"][0],
                        out["rotations"][0], out["colors"][0],
                        out["opacities"][0], camera, config=config)


def photometric_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 + 0.5 * (1 - SSIM) between (3, H, W) images."""
    return (torch.mean(torch.abs(img - target))
            + 0.5 * (1.0 - ssim(img[None], target[None])))


def fit_scene(image: np.ndarray, depth: np.ndarray, *,
              steps: int = 800, lr: float = 1e-2, grid: int = 37, K: int = 4,
              res: int = 256, fixed_depth_offset: Optional[float] = None,
              head_kwargs: Optional[dict] = None,
              max_per_tile: int = 1024,
              experiment: int = 2,
              freeze_geometry: bool = False,
              geometry_prox: float = 0.0,
              depth_offset_init: float = -2.0,
              device: Optional[Union[str, torch.device]] = None,
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, object]]:
    """Fit raw head values (and the depth offset unless fixed) to one
    (3, res, res) image with `depth` (H, W) by `steps` Adam steps.

    freeze_geometry pins the XY offsets (channels 0:3) and the 6D
    rotations (channels 6:12) at their surface init by zeroing their
    gradient; geometry_prox > 0 adds an L2 pull of those channels toward
    the init.  Returns (teacher dict for npz: raw (grid, grid, K, 16),
    depth_offset, ssim, psnr; metrics: ssim, psnr, losses per step).
    Runs on `device` (CUDA by default)."""
    if experiment == 4:
        raise NotImplementedError(
            "experiment 4 (the Fibonacci spiral head) is not ported "
            "(ROADMAP Queue 1, item 12)")
    if experiment != 2:
        raise ValueError(f"unknown experiment {experiment}")
    dev = resolve_device(device)
    hk = dict(head_kwargs or {})
    camera = Camera.default_training(res)
    cfg = TileRendererConfig(max_per_tile=max_per_tile)
    target = torch.from_numpy(np.array(image, np.float32)).to(dev)
    depth_t = torch.from_numpy(np.array(depth, np.float32)).to(dev)[None]

    raw0 = init_raw(image, depth, camera, grid=grid, K=K, head_kwargs=hk)
    camera = camera.to(dev)
    raw = torch.from_numpy(raw0).to(dev).requires_grad_()
    params = [raw]
    if fixed_depth_offset is None:
        # -2.0 is the reference's value but far from the per-scene optimum
        # (~-0.13 at the training camera): Adam moves a lone scalar ~lr per
        # step, so short fits should start near it.
        do = torch.tensor(depth_offset_init, dtype=torch.float32,
                          device=dev).requires_grad_()
        params.append(do)
    else:
        do = torch.tensor(float(fixed_depth_offset), dtype=torch.float32,
                          device=dev)
    geo_mask = torch.zeros(OPG, dtype=torch.bool, device=dev)
    geo_mask[0:3] = True
    geo_mask[6:12] = True
    raw0_geo = raw.detach() * geo_mask
    # optax.adam's update: eps outside the square root, no eps_root.
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def render():
        return render_raw(raw, depth_t, do, camera, cfg, hk)

    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = photometric_loss(render(), target)
        if geometry_prox > 0:
            dgeo = raw * geo_mask - raw0_geo
            loss = loss + geometry_prox * torch.mean(dgeo * dgeo)
        loss.backward()
        if freeze_geometry:
            raw.grad.masked_fill_(geo_mask, 0.0)
        opt.step()
        losses.append(loss.detach())

    with torch.no_grad():
        img = render()
        sv = float(ssim(img[None], target[None]))
        mse = float(torch.mean((img - target) ** 2))
    teacher = {
        "raw": raw.detach()[0].cpu().numpy().astype(np.float32),
        "depth_offset": np.float32(do.item()),
        "ssim": np.float32(sv),
        "psnr": np.float32(-10 * np.log10(max(mse, 1e-10))),
    }
    metrics = {"ssim": sv, "psnr": float(teacher["psnr"]),
               "losses": (torch.stack(losses).cpu().tolist()
                          if losses else [])}
    return teacher, metrics
