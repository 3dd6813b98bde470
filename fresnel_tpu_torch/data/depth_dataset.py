"""Depth datasets (folder pseudo-labels + synthetic) and pseudo-label
generation.

Counterpart of fresnel_tpu/data/depth_dataset.py (reference:
scripts/utils/depth_dataset.py and preprocessing/generate_pseudo_labels.py):
folder datasets of (image, depth) pairs with augmentation, a synthetic
depth dataset (procedural shapes), and pseudo-depth generation for image
folders through the port's depth estimator factory (Depth-Anything when
its weights are found, the gradient estimator otherwise), on the card
unless `--device cpu`.  The datasets are host numpy and PIL, as in the
JAX package, and draw from the caller's generator in the same order.
NYU Depth V2 streams from the HuggingFace hub, which needs a network: it
is not ported, and `NYUDepthV2Dataset` raises saying so.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from fresnel_tpu_torch.data.dataset import IMG_EXTS, _load_image, color_jitter
from fresnel_tpu_torch.device import resolve_device


def generate_pseudo_labels(image_dir: str, out_dir: Optional[str] = None,
                           depth_size: int = 256,
                           estimator: str = "auto", device=None) -> int:
    """Write {name}_pseudo_depth.bin float32 maps for every image.

    "auto" uses the real Depth-Anything-V2 model whenever its weights are
    present (models/encoders.py probing), the reference's torch-hub
    pseudo-labeling (generate_pseudo_labels.py:43-115), and the gradient
    estimator otherwise."""
    from fresnel_tpu_torch.models.encoders import create_depth_estimator

    dev = resolve_device(device)
    est = create_depth_estimator(estimator, device=dev)
    print(f"pseudo-label estimator: {est.kind}"
          + (f" ({est.weights_path})" if est.weights_path
             else " (procedural fallback — no weights found)"))
    root = Path(image_dir)
    out = Path(out_dir) if out_dir else root
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(root.glob("*")):
        if p.suffix.lower() not in IMG_EXTS:
            continue
        img = torch.from_numpy(_load_image(p, 512)).to(dev)
        with torch.no_grad():
            depth = est(img, depth_size).float().cpu().numpy()
        depth.tofile(out / f"{p.stem}_pseudo_depth.bin")
        n += 1
    return n


class FolderDepthDataset:
    """(image, depth) pairs from a folder: images plus {name}_depth.bin or
    {name}_pseudo_depth.bin float32 maps."""

    def __init__(self, data_dir: str, image_size: int = 256,
                 augment: bool = True):
        self.image_size = image_size
        self.augment = augment
        root = Path(data_dir)
        self._items = []
        for p in sorted(root.glob("*")):
            if p.suffix.lower() not in IMG_EXTS:
                continue
            for cand in (root / f"{p.stem}_depth.bin",
                         root / f"{p.stem}_pseudo_depth.bin"):
                if cand.exists():
                    self._items.append((p, cand))
                    break
        if not self._items:
            raise FileNotFoundError(f"no (image, depth) pairs in {data_dir}")

    def __len__(self):
        return len(self._items)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._items))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            imgs, depths = [], []
            for j in order[i : i + batch_size]:
                ip, dp = self._items[j]
                img = _load_image(ip, self.image_size)
                if self.augment:
                    img = color_jitter(rng, img)
                d = np.fromfile(dp, np.float32)
                side = int(round(len(d) ** 0.5))
                depths.append(d.reshape(side, side))
                imgs.append(np.transpose(img, (2, 0, 1)))
            yield {"image": np.stack(imgs), "depth": np.stack(depths)}


class DepthAugmentation:
    """Paired RGB/depth augmentation: the SAME spatial transform (random
    crop 80-100% + horizontal flip) applies to both, color jitter to RGB
    only (reference: scripts/utils/depth_dataset.py:28-107)."""

    def __init__(self, size: int = 256, horizontal_flip: bool = True,
                 jitter: bool = True, random_crop: bool = True):
        self.size = size
        self.horizontal_flip = horizontal_flip
        self.jitter = jitter
        self.random_crop = random_crop

    def __call__(self, rng: np.random.Generator, rgb: np.ndarray,
                 depth: np.ndarray):
        """(H, W, 3) rgb + (H, W) depth -> (size, size, 3), (size, size)."""
        from PIL import Image

        h, w = depth.shape
        if self.random_crop and rng.random() > 0.5:
            s = rng.uniform(0.8, 1.0)
            ch, cw = int(h * s), int(w * s)
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            rgb = rgb[top : top + ch, left : left + cw]
            depth = depth[top : top + ch, left : left + cw]
        if self.horizontal_flip and rng.random() > 0.5:
            rgb = rgb[:, ::-1]
            depth = depth[:, ::-1]
        S = self.size
        rgb = np.asarray(
            Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
            .resize((S, S), Image.BILINEAR), np.float32) / 255.0
        d = depth.astype(np.float32)
        d = (d - d.min()) / (d.max() - d.min() + 1e-8)
        depth = np.asarray(
            Image.fromarray((d * 255).astype(np.uint8))
            .resize((S, S), Image.NEAREST), np.float32) / 255.0
        if self.jitter:
            rgb = color_jitter(rng, rgb, 0.2, 0.2, 0.2)
        return rgb, depth


class NYUDepthV2Dataset:
    """NYU Depth V2 via HuggingFace tanganke/nyuv2 (reference:
    scripts/utils/depth_dataset.py:110-197).  The JAX package downloads it
    from the hub and raises offline; the port has no network path and
    raises always."""

    def __init__(self, split: str = "train", image_size: int = 256,
                 augment: bool = True, max_samples: Optional[int] = None):
        raise NotImplementedError(
            "NYUv2 download failed (offline?): the dataset streams from the "
            "HuggingFace hub (tanganke/nyuv2), which needs a network, so it "
            "is not ported (ROADMAP.md, Not queued); use --dataset folder "
            "with {name}_depth.bin or {name}_pseudo_depth.bin maps")


class SyntheticDepthDataset:
    """Procedural (image, depth) pairs: colored spheres/boxes on gradients."""

    def __init__(self, n_samples: int = 32, image_size: int = 128,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self._items = []
        S = image_size
        yy, xx = np.mgrid[0:S, 0:S].astype(np.float32) / S
        for _ in range(n_samples):
            depth = np.full((S, S), 0.9, np.float32)
            img = np.full((S, S, 3), 0.1, np.float32)
            for _ in range(rng.integers(2, 6)):
                cx, cy = rng.uniform(0.2, 0.8, 2)
                r = rng.uniform(0.08, 0.25)
                z = rng.uniform(0.1, 0.7)
                col = rng.uniform(0.3, 1.0, 3)
                dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
                inside = dist < r
                closer = inside & (z < depth)
                depth[closer] = z + (dist[closer] / r) * 0.1  # sphere bulge
                img[closer] = col * (1 - dist[closer, None] / r * 0.5)
            self._items.append((img, depth))

    def __len__(self):
        return len(self._items)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._items))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            imgs = [np.transpose(self._items[j][0], (2, 0, 1))
                    for j in order[i : i + batch_size]]
            depths = [self._items[j][1] for j in order[i : i + batch_size]]
            yield {"image": np.stack(imgs), "depth": np.stack(depths)}


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate pseudo depth labels")
    p.add_argument("image_dir")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--depth_size", type=int, default=256)
    p.add_argument("--estimator", default="auto",
                   choices=["gradient", "center", "auto", "depth_anything"])
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    n = generate_pseudo_labels(args.image_dir, args.out_dir, args.depth_size,
                               args.estimator, device=args.device)
    print(f"generated {n} pseudo-depth labels")
    return n


if __name__ == "__main__":
    main()
