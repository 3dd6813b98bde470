"""Command-line interface of the port: `infer`, `refine`, `render`, `orbit`,
`view`, `train`, `eval`.

    python -m fresnel_tpu_torch.cli infer IMG OUT.ply [--checkpoint CKPT]
    python -m fresnel_tpu_torch.cli infer IMG OUT.ply --saag [--html V.html]
    python -m fresnel_tpu_torch.cli refine IMG OUT.ply [--device cpu]
    python -m fresnel_tpu_torch.cli render CLOUD OUT.png [--device cpu]
    python -m fresnel_tpu_torch.cli orbit CLOUD DIR [--device cpu]
    python -m fresnel_tpu_torch.cli view CLOUD OUT.html
    python -m fresnel_tpu_torch.cli view --serve IMG [--port 8008]
    python -m fresnel_tpu_torch.cli train [training flags] [--device cpu]
    python -m fresnel_tpu_torch.cli eval CKPT [--data_dir DIR] [--device cpu]

Counterparts of fresnel_tpu/cli.py's subcommands of the same names, with
the same flags and defaults.  `infer`: image -> 3D Gaussian cloud.  With
`--saag` (or `--no_model` and no checkpoint) the geometric pipeline: the
depth at 256^2 (its `--depth_exponent` curve), a point cloud over the
256^2 image scaled by `--depth_scale` and normalised, and
`geometry.to_surface_gaussians` with the `--saag_*`, wrap, shell and
density flags (65 536 points x 12 static blocks at the defaults);
otherwise through a trained checkpoint (its `.json` sidecar rebuilds the
model; Flax msgpack or `.pt`) or, without one, a decoder initialised from
seed 0, with features from the checkpoint's own encoder, DINOv2 (weights
found under $FRESNEL_TPU_MODELS, ./models or ~/models) or the patch
extractor, and depth from Depth-Anything (weights found there) or the
gradient estimator; `--fused_encoder` runs both found backbones in one
trunk forward (it prints which route ran).  Gaussians of opacity
<= 1e-4 are dropped before the file is written; `--html` also writes the
interactive viewer (with the SAAG categories on the SAAG path).
`refine`: image -> per-scene fitted 3D Gaussian cloud; `--steps` Adam
steps through the tiled rasterizer fit decoder-space Gaussians (grid 37,
K per patch) to the image, with depth from Depth-Anything when its
weights are found, else from the procedural gradient estimator.
`render`: a `.ply` / `.bin` cloud from an orbit pose to a
PNG; `orbit`: `--views` PNGs around it.  Clouds of 98 304 Gaussians or
more go through the rank-table search binning.  `view`: a cloud file to
the self-contained HTML viewer, or with `--serve` the live reprocess
server over an image (viewer.serve).  `train`: decoder training, the
flags of `train.train_gaussian_decoder` (the JAX package's `fresnel
train`).  `eval`: novel-view evaluation of a checkpoint over a corpus (8
orbit views per scene, `evaluation.novel_view_eval`).  Everything runs on
the card unless `--device cpu` is given.  The `smoke` subcommand is not
ported.
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
from fresnel_tpu_torch.evaluation.novel_view_eval import (
    evaluate_novel_views, render_views)
from fresnel_tpu_torch.evaluation.visual_eval import VisualEvaluator, resize_to
from fresnel_tpu_torch.geometry import (
    AdaptiveDensityParams, SilhouetteWrapParams, SurfaceGaussianParams,
    VolumetricShellParams, pointcloud_from_depth, to_surface_gaussians)
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder, head_transform
from fresnel_tpu_torch.models.encoders import (
    create_depth_estimator, create_feature_extractor, create_fused_encoder,
    resize_linear)
from fresnel_tpu_torch.render.tile import TileRendererConfig, render_tiled
from fresnel_tpu_torch.train.fit_teacher import fit_scene
from fresnel_tpu_torch.train.harness import trainer_from_checkpoint
from fresnel_tpu_torch.viewer.html_viewer import export_html, saag_categories
from fresnel_tpu_torch.weights import init_flax_like_

SAAG_GRID = 256     # the SAAG path's depth and image side


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


def _fields(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The first sample's Gaussian fields of a decoder's batched output."""
    return {k: out[k][0] for k in ("positions", "scales", "rotations",
                                   "colors", "opacities")}


def _add_saag_quality_flags(p) -> None:
    """The reference viewer's quality panel as flags, grouped by the SAAG
    parameter structs; defaults are the dataclasses' (geometry/saag.py)."""
    g = p.add_argument_group("SAAG quality (with --saag)")
    g.add_argument("--depth_exponent", type=float, default=1.0,
                   help="depth**exponent preprocessing")
    g.add_argument("--saag_base_size", type=float, default=0.008)
    g.add_argument("--saag_aspect_ratio", type=float, default=5.0)
    g.add_argument("--saag_edge_threshold", type=float, default=0.15)
    g.add_argument("--saag_edge_shrink", type=float, default=0.3)
    g.add_argument("--saag_min_confidence", type=float, default=0.1)
    g.add_argument("--saag_gradient_scale", type=float, default=50.0)
    g.add_argument("--saag_normal_strength", type=float, default=1.0)
    g.add_argument("--no_wrap", action="store_true",
                   help="disable silhouette wrap Gaussians")
    g.add_argument("--wrap_layers", type=int, default=3)
    g.add_argument("--wrap_layer_spacing", type=float, default=0.5)
    g.add_argument("--wrap_opacity_falloff", type=float, default=0.7)
    g.add_argument("--wrap_max_angle", type=float, default=75.0)
    g.add_argument("--wrap_aspect", type=float, default=2.0)
    g.add_argument("--wrap_edge_threshold", type=float, default=0.15)
    g.add_argument("--no_shell", action="store_true",
                   help="disable the volumetric back shell")
    g.add_argument("--shell_thickness", type=float, default=0.3)
    g.add_argument("--shell_back_opacity", type=float, default=0.6)
    g.add_argument("--shell_back_darken", type=float, default=0.8)
    g.add_argument("--no_shell_walls", action="store_true")
    g.add_argument("--shell_wall_segments", type=int, default=3)
    g.add_argument("--shell_wall_opacity", type=float, default=0.5)
    g.add_argument("--shell_edge_threshold", type=float, default=0.1)
    g.add_argument("--no_density", action="store_true",
                   help="disable adaptive edge densification")
    g.add_argument("--density_gradient_threshold", type=float, default=0.08)
    g.add_argument("--density_extra_count", type=int, default=4)
    g.add_argument("--density_position_jitter", type=float, default=0.6)
    g.add_argument("--density_size_variance", type=float, default=0.3)
    g.add_argument("--density_opacity_scale", type=float, default=0.7)


def _saag_params_from_args(args):
    """(surface, wrap, shell, density) parameters from the flags."""
    return (
        SurfaceGaussianParams(
            base_size=args.saag_base_size,
            aspect_ratio=args.saag_aspect_ratio,
            edge_threshold=args.saag_edge_threshold,
            edge_shrink=args.saag_edge_shrink,
            min_confidence=args.saag_min_confidence,
            gradient_scale=args.saag_gradient_scale,
            normal_strength=args.saag_normal_strength),
        SilhouetteWrapParams(
            enabled=not args.no_wrap,
            edge_threshold=args.wrap_edge_threshold,
            wrap_layers=args.wrap_layers,
            layer_spacing=args.wrap_layer_spacing,
            opacity_falloff=args.wrap_opacity_falloff,
            max_wrap_angle=args.wrap_max_angle,
            wrap_aspect=args.wrap_aspect),
        VolumetricShellParams(
            enabled=not args.no_shell,
            thickness=args.shell_thickness,
            back_opacity=args.shell_back_opacity,
            back_darken=args.shell_back_darken,
            connect_walls=not args.no_shell_walls,
            wall_segments=args.shell_wall_segments,
            wall_opacity=args.shell_wall_opacity,
            edge_threshold=args.shell_edge_threshold),
        AdaptiveDensityParams(
            enabled=not args.no_density,
            gradient_threshold=args.density_gradient_threshold,
            extra_count=args.density_extra_count,
            position_jitter=args.density_position_jitter,
            size_variance=args.density_size_variance,
            opacity_scale=args.density_opacity_scale),
    )


def saag_infer(image: Union[np.ndarray, torch.Tensor], *,
               params=None, depth_estimator: str = "auto",
               depth_exponent: float = 1.0, depth_scale: float = 2.0,
               opacity: float = 0.8,
               device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[GaussianCloud, np.ndarray]:
    """(H, W, 3) image in [0, 1] -> (the static-shape SAAG cloud on
    `device`, before compaction; its uint8 category per Gaussian).  The
    depth at 256^2 with the depth**exponent curve, the image resized to
    256^2 (antialiased), the point cloud scaled by `depth_scale` and
    normalised to extent 3; `params` the (surface, wrap, shell, density)
    parameters (their defaults when None).  CUDA by default."""
    dev = resolve_device(device)
    sp, wp, shp, dp = params or (
        SurfaceGaussianParams(), SilhouetteWrapParams(),
        VolumetricShellParams(), AdaptiveDensityParams())
    image = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
    estimator = create_depth_estimator(depth_estimator, device=dev)
    print(_described("depth estimator", estimator))
    with torch.no_grad():
        depth = estimator(image, SAAG_GRID)
        if depth_exponent != 1.0:
            depth = torch.pow(torch.clamp(depth, 0.0, 1.0), depth_exponent)
        color = resize_linear(image.permute(2, 0, 1), SAAG_GRID,
                              SAAG_GRID).permute(1, 2, 0)
        pc = pointcloud_from_depth(
            resize_linear(depth, SAAG_GRID, SAAG_GRID), color=color,
            depth_scale=depth_scale).normalize(3.0)
        cloud = to_surface_gaussians(
            pc, depth, params=sp, wrap_params=wp, shell_params=shp,
            density_params=dp, opacity=opacity)
    return cloud, saag_categories(SAAG_GRID * SAAG_GRID, wp, shp, dp)


def _described(what: str, model) -> str:
    """`what: kind (weights path)`, or the procedural fallback's note."""
    if model.weights_path:
        return f"{what}: {model.kind} ({model.weights_path})"
    return f"{what}: {model.kind} (procedural fallback - no weights found)"


def infer(image: Union[np.ndarray, torch.Tensor],
          checkpoint: Optional[str] = None, *, gaussians_per_patch: int = 4,
          depth_estimator: str = "auto", feature_extractor: str = "auto",
          fused_encoder: bool = False,
          device: Optional[Union[str, torch.device]] = None
          ) -> GaussianCloud:
    """(H, W, 3) image in [0, 1] -> the decoded cloud on `device`, before
    compaction.  With a checkpoint, the model its sidecar describes, with
    its weights (and its encoder's features with `train_encoder`);
    without one, a DirectPatchDecoder of `gaussians_per_patch` initialised
    from seed 0.  `fused_encoder` runs found DINOv2 and Depth-Anything
    weights in one trunk forward (models.encoders.FusedDinoDepthEncoder),
    else the two apart.  CUDA by default."""
    dev = resolve_device(device)
    image = torch.as_tensor(np.asarray(image, np.float32)).to(dev)
    estimator = create_depth_estimator(depth_estimator, device=dev)
    print(_described("depth estimator", estimator))
    extractor = create_feature_extractor(feature_extractor, grid=37,
                                         dim=384, device=dev)
    print(_described("feature extractor", extractor))
    fused = (create_fused_encoder(extractor, estimator) if fused_encoder
             else None)
    if fused is not None:
        print("encoder route: fused dual trunk (features + depth in one "
              "trunk forward)")
        f, d = fused(image, 256)
        feats, depth = f[None], d[None]
    else:
        print("encoder route: separate" + (
            " (--fused_encoder needs both backbones' weights with matching "
            "trunks)" if fused_encoder else ""))
        with torch.no_grad():
            depth = estimator(image, 256)[None]
            feats = extractor(image)[None]
    if checkpoint:
        trainer = trainer_from_checkpoint(checkpoint, device=dev)
        state, _ = trainer.load_checkpoint(checkpoint)
        if trainer.config.train_encoder:
            # The checkpoint's own encoder on the 256^2 image: its
            # features, not the extractor's, are the model's input.
            img256 = resize_linear(image.permute(2, 0, 1), 256, 256)[None]
            feats = trainer.encode(state["params"], img256)
            print("feature extractor: jointly-trained encoder (from "
                  "checkpoint)")
        out = trainer.decode(state["params"], feats, depth)
    else:
        model = DirectPatchDecoder(gaussians_per_patch=gaussians_per_patch)
        init_flax_like_(model, torch.Generator().manual_seed(0))
        print("note: no checkpoint given - using randomly initialized "
              "decoder (pass --saag for the geometric pipeline)")
        with torch.no_grad():
            out = model.to(dev)(feats, depth)
    return GaussianCloud(**_fields(out))


def compact(cloud: GaussianCloud,
            categories: Optional[np.ndarray] = None):
    """Drop the Gaussians of opacity <= 1e-4, on the host (the
    static-shape pipelines emit them masked) -> (cloud, categories), the
    categories compacted with the cloud (None stays None)."""
    live = (cloud.opacities > 1e-4).cpu().numpy()
    if live.all():
        return cloud, categories
    idx = torch.from_numpy(np.flatnonzero(live)).to(cloud.positions.device)
    cloud = GaussianCloud(
        positions=cloud.positions[idx], scales=cloud.scales[idx],
        rotations=cloud.rotations[idx], colors=cloud.colors[idx],
        opacities=cloud.opacities[idx])
    return cloud, None if categories is None else categories[live]


def cmd_infer(args) -> int:
    t0 = time.perf_counter()
    if args.saag or args.checkpoint is None and args.no_model:
        cloud, categories = saag_infer(
            _load_image(args.image), params=_saag_params_from_args(args),
            depth_estimator=args.depth_estimator,
            depth_exponent=args.depth_exponent,
            depth_scale=args.depth_scale, opacity=args.opacity,
            device=args.device)
    else:
        if (args.checkpoint
                and not Path(args.checkpoint + ".json").exists()):
            print("checkpoint meta json missing; cannot reconstruct model",
                  file=sys.stderr)
            return 1
        cloud = infer(_load_image(args.image), args.checkpoint,
                      gaussians_per_patch=args.gaussians_per_patch,
                      depth_estimator=args.depth_estimator,
                      feature_extractor=args.feature_extractor,
                      fused_encoder=args.fused_encoder, device=args.device)
        categories = None
    cloud, categories = compact(cloud, categories)
    dt = (time.perf_counter() - t0) * 1000
    out_path = Path(args.output)
    if out_path.suffix == ".ply":
        gio.save_ply(out_path, cloud)
    else:
        gio.save_binary(out_path, cloud)
    print(f"{cloud.num_gaussians} gaussians -> {out_path}  ({dt:.0f} ms)")
    if args.html:
        n = export_html(cloud, args.html, max_gaussians=args.max_gaussians,
                        categories=categories)
        print(f"viewer with {n} gaussians -> {args.html}"
              + (" (SAAG category toggles live)"
                 if categories is not None else ""))
    return 0


def evaluate(checkpoint: str, *, data_dir: Optional[str] = None,
             synthetic: bool = False, max_images: Optional[int] = None,
             size: int = 256, output_json: Optional[str] = None,
             max_per_tile: Optional[int] = None,
             device: Optional[Union[str, torch.device]] = None):
    """Novel-view evaluation of a checkpoint -> (results dict, samples).
    Scenes from `data_dir` (default: the sidecar's) or, with `synthetic`,
    `max_images` (default 4) synthetic scenes, in order; the render cap
    defaults to the checkpoint's training cap.  CUDA by default."""
    from fresnel_tpu_torch.data.dataset import (
        ImageDataset, SyntheticGaussianDataset)

    dev = resolve_device(device)
    trainer = trainer_from_checkpoint(checkpoint, device=dev)
    cfg = trainer.config
    if synthetic:
        ds = SyntheticGaussianDataset(n_samples=max_images or 4,
                                      image_size=cfg.image_size, device=dev)
    else:
        ds = ImageDataset(data_dir or cfg.data_dir,
                          image_size=cfg.image_size, use_augmentation=False,
                          max_images=max_images, device=dev)
    rng = np.random.default_rng(0)
    state, _ = trainer.load_checkpoint(checkpoint)
    params = state["params"]
    samples = []
    for batch in ds.batches(1, rng, shuffle=False):
        feats = (trainer.encode(params, batch["image"]) if cfg.train_encoder
                 else batch["features"])
        out = trainer.decode(params, feats, batch["depth"])
        sample = {"gaussians": _fields(out), "target": batch["image"][0]}
        if "views" in batch:
            # corpus_v2 GT orbit views -> per-view SSIM / PSNR
            sample["views"] = batch["views"][0]
        samples.append(sample)
        if max_images and len(samples) >= max_images:
            break
    # The cap defaults to the checkpoint's training cap: a decoder is
    # scored under the compositing it was trained with.
    mpt = max_per_tile or cfg.max_per_tile
    results = evaluate_novel_views(samples, render_size=size,
                                   output_json=output_json, max_per_tile=mpt)
    return results, samples, mpt


def save_grid(samples, path: str, size: int = 256,
              max_per_tile: int = 256) -> None:
    """Rows of [frontal render | target] for the first 8 scenes -> PNG."""
    ev = VisualEvaluator(render_size=size, max_per_tile=max_per_tile)
    rows = []
    for s in samples[:8]:
        img = ev.render(s["gaussians"])
        tgt = resize_to(torch.as_tensor(np.asarray(s["target"]),
                                        dtype=torch.float32,
                                        device=img.device), size)
        rows.append(torch.cat([img, tgt], dim=2))
    _save_png(torch.clamp(torch.cat(rows, dim=1), 0, 1), path)


def cmd_eval(args) -> int:
    results, samples, mpt = evaluate(
        args.checkpoint, data_dir=args.data_dir, synthetic=args.synthetic,
        max_images=args.max_images, size=args.size,
        output_json=args.output_json, max_per_tile=args.max_per_tile,
        device=args.device)
    print(json.dumps(results, indent=2))
    if args.save_grid:
        save_grid(samples, args.save_grid, args.size, mpt)
        print(f"qualitative grid -> {args.save_grid}")
    return 0


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
    estimator = create_depth_estimator(depth_estimator, device=dev)
    print(_described("depth estimator", estimator))
    with torch.no_grad():
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


def cmd_view(args) -> int:
    dev = resolve_device(args.device)
    if args.serve:
        from fresnel_tpu_torch.viewer.serve import serve_image

        serve_image(args.cloud, port=args.port,
                    depth_estimator=args.depth_estimator, device=dev)
        return 0
    if args.output is None:
        print("output .html required in static export mode", file=sys.stderr)
        return 1
    cloud = _load_cloud(args.cloud).to(dev)
    n = export_html(cloud, args.output, args.max_gaussians, args.distance)
    print(f"viewer with {n} gaussians -> {args.output}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fresnel-torch",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("infer", help="image -> 3D Gaussian cloud")
    p.add_argument("image")
    p.add_argument("output", help=".ply or .bin")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--saag", action="store_true",
                   help="use the geometric SAAG pipeline (no learned model)")
    p.add_argument("--no_model", action="store_true",
                   help="without --checkpoint: the SAAG pipeline")
    p.add_argument("--gaussians_per_patch", type=int, default=4)
    p.add_argument("--depth_scale", type=float, default=2.0)
    p.add_argument("--opacity", type=float, default=0.8)
    p.add_argument("--depth_estimator", default="auto",
                   choices=["auto", "depth_anything", "gradient", "center"],
                   help="'auto' loads Depth-Anything weights when found, "
                        "else the gradient estimator")
    p.add_argument("--fused_encoder", action="store_true",
                   help="DINOv2 and Depth-Anything in one trunk forward "
                        "(both weights found)")
    p.add_argument("--feature_extractor", default="auto",
                   choices=["auto", "dinov2", "patch"],
                   help="'auto' loads DINOv2 weights when found, else the "
                        "patch extractor")
    p.add_argument("--html", default=None, metavar="OUT.html",
                   help="also export the interactive HTML viewer (with live "
                        "SAAG category toggles on the --saag path)")
    p.add_argument("--max_gaussians", type=int, default=30000,
                   help="viewer preview cap (highest-opacity kept)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    _add_saag_quality_flags(p)

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

    p = sub.add_parser("view", help="export an interactive HTML splat viewer")
    p.add_argument("cloud", help="a .ply/.bin cloud (static export) or, with "
                                 "--serve, the source IMAGE to reprocess")
    p.add_argument("output", nargs="?", default=None,
                   help="output .html (static export mode only)")
    p.add_argument("--max_gaussians", type=int, default=30000)
    p.add_argument("--distance", type=float, default=2.0)
    p.add_argument("--serve", action="store_true",
                   help="live mode: serve the viewer over HTTP with an "
                        "in-page reprocess panel (SAAG run again with new "
                        "params on the server)")
    p.add_argument("--port", type=int, default=8008)
    p.add_argument("--depth_estimator", default="auto")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")

    sub.add_parser("train", add_help=False,
                   help="train a Gaussian decoder (the flags of "
                        "fresnel_tpu_torch.train.train_gaussian_decoder)")

    p = sub.add_parser("eval", help="novel-view evaluation of a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--output_json", default=None)
    p.add_argument("--save_grid", default=None, metavar="OUT.png",
                   help="save a qualitative grid (render | target rows) "
                        "for the first scenes")
    p.add_argument("--max_per_tile", type=int, default=None,
                   help="eval-render capacity (default: the checkpoint's "
                        "training cap)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["train"]:
        from fresnel_tpu_torch.train import train_gaussian_decoder
        train_gaussian_decoder.main(argv[1:])
        return 0
    args = build_parser().parse_args(argv)
    return {"infer": cmd_infer, "refine": cmd_refine, "render": cmd_render,
            "orbit": cmd_orbit, "eval": cmd_eval,
            "view": cmd_view}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
