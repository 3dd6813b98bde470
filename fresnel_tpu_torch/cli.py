"""Command-line interface of the port: `refine`, `render` and `orbit`.

    python -m fresnel_tpu_torch.cli refine IMG OUT.ply [--device cpu]
    python -m fresnel_tpu_torch.cli render CLOUD OUT.png [--device cpu]
    python -m fresnel_tpu_torch.cli orbit CLOUD DIR [--device cpu]

Counterparts of fresnel_tpu/cli.py's subcommands of the same names, with
the same flags and defaults.  `refine`: image -> per-scene fitted 3D
Gaussian cloud; `--steps` Adam steps through the tiled rasterizer fit
decoder-space Gaussians (grid 37, K per patch) to the image, with depth
from the procedural gradient estimator unless Depth-Anything weights are
found (which raises: they are not ported).  `render`: a `.ply` / `.bin`
cloud from an orbit pose to a PNG; `orbit`: `--views` PNGs around it.
Clouds of 98 304 Gaussians or more go through the rank-table search
binning.  Everything runs on the card unless `--device cpu` is given.  The
other subcommands of the JAX CLI are not ported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from fresnel_tpu_torch.core import io as gio
from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.gaussians import GaussianCloud
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.models.decoders import head_transform
from fresnel_tpu_torch.models.encoders import (
    create_depth_estimator, resize_linear)
from fresnel_tpu_torch.evaluation.novel_view_eval import render_views
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled
from fresnel_tpu_torch.train.fit_teacher import fit_scene


def _load_image(path: str, size: int = 512) -> np.ndarray:
    """(size, size, 3) float32 in [0, 1], bilinear-resized by PIL."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def _load_cloud(path: str) -> GaussianCloud:
    if str(path).endswith(".ply"):
        return gio.load_ply(path)
    return gio.load_binary(path)


def _save_png(img: torch.Tensor, path: str) -> None:
    """(3, H, W) in [0, 1] -> 8-bit PNG (truncating, as the JAX CLI does)."""
    from PIL import Image

    arr = (img.detach().cpu().numpy().transpose(1, 2, 0) * 255).astype(
        np.uint8)
    Image.fromarray(arr).save(path)


def render(cloud: GaussianCloud, *, elevation: float = 0.0,
           azimuth: float = 0.0, distance: float = 2.0, size: int = 512,
           max_per_tile: int = 512,
           device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """A cloud from the orbit pose (elevation, azimuth in degrees) -> (3,
    size, size) image in [0, 1] on `device`.  No gradient.  CUDA by
    default."""
    dev = resolve_device(device)
    cloud = cloud.to(dev)
    cam = Camera.from_pose(np.radians(elevation), np.radians(azimuth), size,
                           distance=distance)
    with torch.no_grad():
        return render_tiled(
            cloud.positions, cloud.scales, cloud.rotations, cloud.colors,
            cloud.opacities, cam,
            config=TileRendererConfig(max_per_tile=max_per_tile))


def orbit(cloud: GaussianCloud, *, views: int = 8, elevation: float = 0.0,
          distance: float = 2.0, size: int = 256,
          device: Optional[Union[str, torch.device]] = None
          ) -> Tuple[np.ndarray, torch.Tensor]:
    """`views` renders at evenly spaced azimuths -> (azimuths in degrees,
    (views, 3, size, size) images on `device`).  No gradient.  CUDA by
    default."""
    dev = resolve_device(device)
    cloud = cloud.to(dev)
    gaussians = {
        "positions": cloud.positions, "scales": cloud.scales,
        "rotations": cloud.rotations, "colors": cloud.colors,
        "opacities": cloud.opacities}
    azimuths = np.linspace(0, 360, views, endpoint=False)
    with torch.no_grad():
        return azimuths, render_views(
            gaussians, render_size=size, azimuths_deg=azimuths,
            elevation_deg=elevation, distance=distance)


def refine(image: Union[np.ndarray, torch.Tensor], *, steps: int = 800,
           lr: float = 1e-2, size: int = 256, gaussians_per_patch: int = 4,
           max_per_tile: int = 1024, depth_estimator: str = "auto",
           depth_offset_init: float = -0.13,
           device: Optional[Union[str, torch.device]] = None
           ) -> Tuple[GaussianCloud, Dict[str, object]]:
    """(H, W, 3) image in [0, 1] -> (fitted cloud on `device`, metrics).

    Metrics: ssim and psnr after the fit, the loss of every step, steps,
    the depth estimator's kind.  CUDA by default."""
    dev = resolve_device(device)
    image = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
    estimator = create_depth_estimator(depth_estimator)
    depth = estimator(image, 256).cpu().numpy().astype(np.float32)

    target = image.permute(2, 0, 1)
    if target.shape[-1] != size:
        target = resize_linear(target, size, size)
    # No head biases: init_raw encodes the surface init directly in raw
    # space, and biases would apply twice.
    hk: dict = {}
    teacher, metrics = fit_scene(
        target.cpu().numpy(), depth, steps=steps, lr=lr,
        K=gaussians_per_patch, res=size, head_kwargs=hk,
        max_per_tile=max_per_tile, depth_offset_init=depth_offset_init,
        device=dev)

    with torch.no_grad():
        out = head_transform(
            torch.from_numpy(teacher["raw"])[None].to(dev),
            torch.from_numpy(depth)[None].to(dev),
            torch.tensor(float(teacher["depth_offset"]), device=dev), **hk)
    cloud = GaussianCloud(
        positions=out["positions"][0], scales=out["scales"][0],
        rotations=out["rotations"][0], colors=out["colors"][0],
        opacities=out["opacities"][0])
    return cloud, dict(metrics, steps=steps, depth_estimator=estimator.kind)


def cmd_refine(args) -> int:
    t0 = time.perf_counter()
    image = _load_image(args.image, size=args.size)
    cloud, metrics = refine(
        image, steps=args.steps, lr=args.lr, size=args.size,
        gaussians_per_patch=args.gaussians_per_patch,
        max_per_tile=args.max_per_tile, depth_estimator=args.depth_estimator,
        depth_offset_init=args.depth_offset_init, device=args.device)
    print(f"depth estimator: {metrics['depth_estimator']} "
          "(procedural fallback)")
    out_path = Path(args.output)
    if out_path.suffix == ".ply":
        gio.save_ply(out_path, cloud)
    else:
        gio.save_binary(out_path, cloud)
    dt = (time.perf_counter() - t0) * 1000
    print(f"{cloud.num_gaussians} gaussians -> {out_path}  ({dt:.0f} ms)")
    print(json.dumps({"ssim": round(metrics["ssim"], 4),
                      "psnr": round(metrics["psnr"], 2),
                      "steps": args.steps}))
    return 0


def cmd_render(args) -> int:
    cloud = _load_cloud(args.cloud)
    img = render(cloud, elevation=args.elevation, azimuth=args.azimuth,
                 distance=args.distance, size=args.size,
                 max_per_tile=args.max_per_tile, device=args.device)
    _save_png(img, args.output)
    print(f"rendered {cloud.num_gaussians} gaussians -> {args.output}")
    return 0


def cmd_orbit(args) -> int:
    cloud = _load_cloud(args.cloud)
    azimuths, views = orbit(cloud, views=args.views,
                            elevation=args.elevation, distance=args.distance,
                            size=args.size, device=args.device)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for az, v in zip(azimuths, views):
        _save_png(v, str(out_dir / f"view_az{int(az):03d}.png"))
    print(f"wrote {args.views} views to {out_dir}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fresnel-torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser(
        "refine", help="image -> per-scene optimized 3D Gaussian cloud")
    p.add_argument("image")
    p.add_argument("output", help="OUT.ply or OUT.bin")
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--gaussians_per_patch", type=int, default=4)
    p.add_argument("--max_per_tile", type=int, default=1024)
    p.add_argument("--depth_estimator", default="auto")
    p.add_argument("--depth_offset_init", type=float, default=-0.13,
                   help="depth_offset start value; the reference's -2.0 "
                        "stalls short fits")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")

    p = sub.add_parser("render", help="render a cloud file to PNG")
    p.add_argument("cloud")
    p.add_argument("output")
    p.add_argument("--azimuth", type=float, default=0.0)
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--distance", type=float, default=2.0)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--max_per_tile", type=int, default=512,
                   help="per-tile compositing capacity; 512 here (against "
                        "256 in training and evaluation) because standalone "
                        "clouds are much larger than decoder outputs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")

    p = sub.add_parser("orbit", help="export an orbit of views")
    p.add_argument("cloud")
    p.add_argument("output_dir")
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--elevation", type=float, default=0.0)
    p.add_argument("--distance", type=float, default=2.0)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"refine": cmd_refine, "render": cmd_render,
            "orbit": cmd_orbit}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
