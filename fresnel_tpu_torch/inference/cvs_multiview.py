"""CVS multi-view generation, and a 3DGS fit to the generated views.

Counterpart of fresnel_tpu/inference/cvs_multiview.py: orbit or
hemisphere camera paths, one CVS generation per pose, and
`optimize_3dgs`, which fits a Gaussian cloud to the generated views by
Adam through the tiled rasterizer.  Here the V views render as one
batched pack (`render_tiled_batched`, V cameras): on the card one K1
launch forward and one K2 launch backward per step, where the JAX
function renders the views one at a time (each image equals its own
`render_tiled`).

Differences from the JAX module: a `device` argument (None means CUDA;
`--device` for `main`); the noise of each view is drawn on the CPU from a
`torch.Generator` seeded with `--seed` (JAX's draws cannot be reproduced);
`main` reads a `.pt` of the port's trainer or the JAX package's `.msgpack`,
passes the input view to `generate` for a concat_input_view model (the
JAX `main` does not, so it raises for one), and `--fit_steps` sets the
fit's length.

Run:  python -m fresnel_tpu_torch.inference.cvs_multiview IMAGE \\
          --checkpoint CKPT --path orbit --views 8 --optimize_3dgs out.ply
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.gaussians import GaussianCloud
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.losses.ssim import ssim
from fresnel_tpu_torch.render.tile import (
    TileRendererConfig, render_tiled_batched)


def camera_path(kind: str, n_views: int, distance: float = 2.0
                ) -> List[Tuple[float, float]]:
    """(elevation, azimuth) radians per view."""
    if kind == "orbit":
        return [(0.0, az) for az in np.linspace(0, 2 * np.pi, n_views,
                                                endpoint=False)]
    if kind == "hemisphere":
        out = []
        rings = max(1, n_views // 4)
        per = max(1, n_views // rings)
        for el in np.linspace(0.1, 1.0, rings):
            for az in np.linspace(0, 2 * np.pi, per, endpoint=False):
                out.append((float(el), float(az)))
        return out[:n_views]
    raise ValueError(kind)


def fit_init(n_gaussians: int, seed: int) -> dict:
    """The fit's starting parameters, on the CPU: positions normal * 0.4
    from numpy's generator, scales 0.05, identity rotations, colour and
    opacity logits 0."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n_gaussians, 3)).astype(np.float32) * 0.4
    rot = np.zeros((n_gaussians, 4), np.float32)
    rot[:, 0] = 1.0
    return {"positions": torch.from_numpy(pos),
            "log_scales": torch.full((n_gaussians, 3), float(np.log(0.05))),
            "rotations": torch.from_numpy(rot),
            "color_logits": torch.zeros(n_gaussians, 3),
            "opacity_logits": torch.zeros(n_gaussians)}


def optimize_3dgs(views, poses, image_size: int, n_gaussians: int = 2000,
                  steps: int = 300, lr: float = 1e-2, seed: int = 0,
                  device=None, losses: Optional[list] = None
                  ) -> GaussianCloud:
    """Fit a Gaussian cloud to (V, 3, S, S) views at the given (elevation,
    azimuth) poses by Adam on L1 + 0.5 (1 - SSIM) through the tiled
    rasterizer (M 256).  `losses`, if given, receives each step's loss
    (at the parameters before the step) as a 0-d tensor."""
    dev = resolve_device(device)
    target = torch.as_tensor(np.asarray(views), dtype=torch.float32,
                             device=dev)
    cams = [Camera.from_pose(el, az, image_size).to(dev) for el, az in poses]
    cfg = TileRendererConfig(max_per_tile=256)
    p = {k: v.to(dev).requires_grad_()
         for k, v in fit_init(n_gaussians, seed).items()}
    # optax.adam's update: eps outside the square root, no eps_root.
    opt = torch.optim.Adam(list(p.values()), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    def rep(x):                      # the cloud once per camera
        return x[None].expand(len(cams), *x.shape)

    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        imgs, _, _ = render_tiled_batched(
            rep(p["positions"]), rep(torch.exp(p["log_scales"])),
            rep(p["rotations"]), rep(torch.sigmoid(p["color_logits"])),
            rep(torch.sigmoid(p["opacity_logits"])), cams, cfg)
        loss = (torch.mean(torch.abs(imgs - target))
                + 0.5 * (1.0 - ssim(imgs, target)))
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(loss.detach())
        if (i + 1) % 50 == 0:
            print(f"  3dgs fit step {i + 1}/{steps} loss={loss.item():.4f}")
    with torch.no_grad():
        rot = p["rotations"]
        return GaussianCloud(
            positions=p["positions"].detach(),
            scales=torch.exp(p["log_scales"]),
            rotations=rot / torch.linalg.norm(rot, dim=-1, keepdim=True),
            colors=torch.sigmoid(p["color_logits"]),
            opacities=torch.sigmoid(p["opacity_logits"]))


def main(argv=None) -> dict:
    """Generate one view per pose from IMAGE with a CVS checkpoint, write
    the PNGs (and with --optimize_3dgs the fitted cloud as PLY).  Returns
    {"views": (V, 3, S, S) numpy, "poses", "cloud", "fit_losses" (one
    0-d tensor per step), "fit_seconds" (the fit and the PLY write, host
    clock); the last three None without --optimize_3dgs}."""
    p = argparse.ArgumentParser(description="CVS multi-view generation")
    p.add_argument("image")
    p.add_argument("--checkpoint", required=True,
                   help="CVS checkpoint (.pt from train_cvs, or the JAX "
                        "package's .msgpack), with its .json sidecar")
    p.add_argument("--output_dir", default="cvs_views")
    p.add_argument("--path", choices=["orbit", "hemisphere"], default="orbit")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--num_steps", type=int, default=1)
    p.add_argument("--optimize_3dgs", default=None,
                   help="fit a Gaussian cloud to the views -> PLY path")
    p.add_argument("--fit_steps", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from PIL import Image
    from fresnel_tpu_torch.models.encoders import create_feature_extractor
    from fresnel_tpu_torch.train.train_cvs import CVSTrainConfig, CVSTrainer

    dev = resolve_device(args.device)
    meta = json.loads(Path(args.checkpoint + ".json").read_text())
    cfg = CVSTrainConfig(**meta["config"])
    trainer = CVSTrainer(cfg, device=dev)
    S = cfg.image_size

    img = Image.open(args.image).convert("RGB").resize((S, S))
    image = np.asarray(img, np.float32) / 255.0
    feats = create_feature_extractor(dim=384, device=dev)(
        torch.from_numpy(image).to(dev))[None]
    chw = np.transpose(image, (2, 0, 1))[None]
    batch = {"input_image": chw, "features": feats.cpu().numpy(),
             "R_rel": np.eye(3, dtype=np.float32)[None],
             "t_rel": np.zeros((1, 3), np.float32), "target_image": chw}
    state, _ = trainer.load_checkpoint(args.checkpoint, batch)

    poses = camera_path(args.path, args.views)
    base = Camera.from_pose(0.0, 0.0, S).view.numpy()
    R0, t0 = base[:3, :3], base[:3, 3]
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(args.seed)
    views = []
    for i, (el, az) in enumerate(poses):
        view = Camera.from_pose(el, az, S).view.numpy()
        R, t = view[:3, :3], view[:3, 3]
        R_rel = (R @ R0.T)[None]
        t_rel = (t - (R @ R0.T) @ t0)[None]
        noise = torch.randn((1, 3, S, S), generator=gen)
        out = trainer.generate(state, feats, R_rel, t_rel, noise,
                               num_steps=args.num_steps,
                               input_image=(chw if cfg.concat_input_view
                                            else None))
        v = out[0].cpu().numpy()
        views.append(v)
        arr = np.clip(v.transpose(1, 2, 0), 0, 1)
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            out_dir / f"view_{i:03d}.png")
    print(f"generated {len(views)} views -> {out_dir}")

    cloud = losses = fit_s = None
    if args.optimize_3dgs:
        from fresnel_tpu_torch.core import io as gio
        t0, losses = time.perf_counter(), []
        cloud = optimize_3dgs(np.stack(views), poses, S,
                              steps=args.fit_steps, seed=args.seed,
                              device=dev, losses=losses)
        gio.save_ply(args.optimize_3dgs, cloud.to("cpu"))
        fit_s = time.perf_counter() - t0
        print(f"optimized 3DGS -> {args.optimize_3dgs}")
    return {"views": np.stack(views), "poses": poses, "cloud": cloud,
            "fit_losses": losses, "fit_seconds": fit_s}


if __name__ == "__main__":
    main()
