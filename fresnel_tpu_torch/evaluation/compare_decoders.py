"""Side-by-side multi-angle decoder comparison.

Counterpart of fresnel_tpu/evaluation/compare_decoders.py: checkpoints
rendered from several azimuths into one PNG grid (PIL), a row per
checkpoint.  Each checkpoint is rebuilt from its sidecar and read by
`Trainer.load_checkpoint` (Flax msgpack or `.pt`); its decoder takes the
patch extractor's features and the gradient depth of the image, as in the
JAX package.  On the card unless `--device cpu` is given.

Run:  python -m fresnel_tpu_torch.evaluation.compare_decoders CKPT_A \
          [CKPT_B ...] --image test.png --out compare.png
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.evaluation.novel_view_eval import render_views
from fresnel_tpu_torch.models.encoders import (
    create_feature_extractor, gradient_depth_estimate)
from fresnel_tpu_torch.train.harness import trainer_from_checkpoint


def load_and_decode(checkpoint: str, image: torch.Tensor, device=None):
    """(512, 512, 3) image -> the checkpoint's decoded Gaussian dict."""
    trainer = trainer_from_checkpoint(checkpoint, device=device)
    image = image.to(trainer.device)
    feats = create_feature_extractor(dim=trainer.config.feature_dim,
                                     device=trainer.device)(image)[None]
    depth = gradient_depth_estimate(image, 256)[None]
    state, _ = trainer.load_checkpoint(checkpoint)
    out = trainer.decode(state["params"], feats, depth)
    return {k: v[0] for k, v in out.items()
            if k in ("positions", "scales", "rotations", "colors",
                     "opacities")}


def compare(checkpoints, image_path: str, out_path: str,
            azimuths=(0, 45, 90, 180), render_size: int = 256, device=None):
    from PIL import Image

    dev = resolve_device(device)
    img = Image.open(image_path).convert("RGB").resize((512, 512))
    image = torch.from_numpy(np.asarray(img, np.float32) / 255.0).to(dev)

    rows = []
    labels = []
    for ckpt in checkpoints:
        g = load_and_decode(ckpt, image, dev)
        with torch.no_grad():
            views = render_views(g, render_size=render_size,
                                 azimuths_deg=azimuths)
        rows.append(np.concatenate(
            [v.cpu().numpy().transpose(1, 2, 0) for v in views], axis=1))
        labels.append(Path(ckpt).stem)

    grid = np.concatenate(rows, axis=0)
    Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(out_path)
    print(f"comparison grid ({len(rows)} checkpoints x {len(azimuths)} views)"
          f" -> {out_path}")
    for lbl in labels:
        print(f"  row: {lbl}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Compare decoder checkpoints")
    p.add_argument("checkpoints", nargs="+")
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="compare.png")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    compare(args.checkpoints, args.image, args.out, render_size=args.size,
            device=args.device)


if __name__ == "__main__":
    main()
