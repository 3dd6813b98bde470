"""Preprocessing: image dir -> cached feature / depth files.

Counterpart of fresnel_tpu/data/preprocess.py (reference:
scripts/preprocessing/preprocess_training_data.py): DINOv2 features
cached as {name}_dinov2[suffix].bin, raw float32 (37, 37, C), and depth
as {name}_depth.bin, raw float32 (256, 256): the same cache contract,
so caches are interchangeable between the packages and the reference.
The extractor and the estimator are the port's factories
(`models/encoders.py`: DINOv2 / Depth-Anything when their weights are
found, the procedural fallbacks otherwise), on the card unless
`--device cpu`.  rembg background removal is availability-gated as in
the reference (:82-169).  `--vlm_density` needs `utils/vlm_guidance.py`,
which is not ported, and raises NotImplementedError.

Run:  python -m fresnel_tpu_torch.data.preprocess IMAGES_DIR [--feature_dim 384]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from fresnel_tpu_torch.data.dataset import IMG_EXTS, _DIM_SUFFIX, _load_image
from fresnel_tpu_torch.device import resolve_device


def remove_background(img: np.ndarray) -> np.ndarray:
    """Optional u2net background removal (gated on rembg availability)."""
    try:
        from rembg import remove
        from PIL import Image

        out = remove(Image.fromarray((img * 255).astype(np.uint8)))
        rgba = np.asarray(out, np.float32) / 255.0
        alpha = rgba[..., 3:4]
        return rgba[..., :3] * alpha + (1 - alpha)  # white background
    except ImportError:
        print("rembg unavailable — skipping background removal",
              file=sys.stderr)
        return img


def preprocess_dataset(data_dir: str, image_size: int = 518,
                       feature_dim: int = 384, depth_size: int = 256,
                       use_rembg: bool = False, overwrite: bool = False,
                       vlm_density: bool = False, device=None) -> int:
    """Write the caches of every image in `data_dir` that lacks them (all
    with `overwrite`); returns how many images were processed."""
    if vlm_density:
        raise NotImplementedError(
            "--vlm_density needs utils/vlm_guidance.py (an LM Studio "
            "endpoint), which is not ported (ROADMAP.md, Not queued)")
    from fresnel_tpu_torch.models.encoders import (
        create_depth_estimator, create_feature_extractor)

    dev = resolve_device(device)
    extractor = create_feature_extractor(dim=feature_dim, device=dev)
    estimator = create_depth_estimator("auto", device=dev)
    for name, obj in (("features", extractor), ("depth", estimator)):
        print(f"{name}: {obj.kind}"
              + (f" ({obj.weights_path})" if obj.weights_path
                 else " (procedural fallback — no weights found)"))
    suffix = _DIM_SUFFIX.get(feature_dim, f"_{feature_dim}")
    root = Path(data_dir)
    paths = sorted(p for p in root.glob("*") if p.suffix.lower() in IMG_EXTS)
    done = 0
    for p in paths:
        feat_path = root / f"{p.stem}_dinov2{suffix}.bin"
        depth_path = root / f"{p.stem}_depth.bin"
        if feat_path.exists() and depth_path.exists() and not overwrite:
            continue
        img = _load_image(p, image_size)
        if use_rembg:
            img = remove_background(img)
        timg = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev)
        with torch.no_grad():
            feats = extractor(timg).float().cpu().numpy()
            depth = estimator(timg, depth_size).float().cpu().numpy()
        feats.tofile(feat_path)
        depth.tofile(depth_path)
        done += 1
        print(f"  {p.name}: features {feats.shape} depth {depth.shape}")
    return done


def main(argv=None):
    p = argparse.ArgumentParser(description="Preprocess training images")
    p.add_argument("data_dir")
    p.add_argument("--image_size", type=int, default=518)
    p.add_argument("--feature_dim", type=int, default=384,
                   choices=[384, 768, 1024])
    p.add_argument("--depth_size", type=int, default=256)
    p.add_argument("--rembg", action="store_true")
    p.add_argument("--vlm_density", action="store_true")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    n = preprocess_dataset(args.data_dir, args.image_size, args.feature_dim,
                           args.depth_size, args.rembg, args.overwrite,
                           args.vlm_density, device=args.device)
    print(f"preprocessed {n} images")
    return n


if __name__ == "__main__":
    main()
