"""Training datasets: cached-feature image dataset + synthetic scenes.

Counterpart of fresnel_tpu/data/dataset.py: the same cache file names and
layouts (caches written by either package are read by the other), the
same sidecars, and `batches` draws from the `np.random.Generator` with the
same calls in the same order, so a seed gives the same batches.

ImageDataset mirrors the reference's cache contract (reference:
scripts/training/train_gaussian_decoder.py:525-681 and
scripts/preprocessing/preprocess_training_data.py):
  {name}_dinov2.bin        raw float32 (37, 37, 384) HWC   (_base/_large for 768/1024)
  {name}_depth.bin         raw float32 (256, 256)
  {name}_vlm_density.npy   optional (gh, gw) density grid
Missing caches are computed on the fly with the fallback extractors
(models/encoders.py) on `device` and written back — the reference instead
hard-skips such images.

SyntheticGaussianDataset renders random Gaussian clouds into images so the
full train loop runs (and can overfit) with zero external data — used by
tests, benchmarks, and `--synthetic`.

Host-side numpy; batches are dicts of numpy arrays handed to the trainer.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from fresnel_tpu_torch.device import resolve_device

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}

_DIM_SUFFIX = {384: "", 768: "_base", 1024: "_large"}


def cache_paths(img_path: Path, image_size: int, feature_dim: int):
    """The on-disk cache contract, shared by ImageDataset and
    StreamingImageDataset (reference: train_gaussian_decoder.py:525-681):
    returns (rgb_bin, dinov2_bin, depth_bin, vlm_density_npy) paths."""
    name = img_path.stem
    suffix = _DIM_SUFFIX.get(feature_dim, f"_{feature_dim}")
    return (
        img_path.parent / f"{name}_rgb{image_size}.bin",
        img_path.parent / f"{name}_dinov2{suffix}.bin",
        img_path.parent / f"{name}_depth.bin",
        img_path.parent / f"{name}_vlm_density.npy",
    )


def _load_image(path: Path, size: int) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0  # (S, S, 3)


def _resize_rgb(img: np.ndarray, size: int) -> np.ndarray:
    """(S0, S0, 3) float [0,1] -> (size, size, 3), PIL bilinear."""
    from PIL import Image

    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(pil.resize((size, size), Image.BILINEAR),
                      np.float32) / 255.0


def color_jitter(rng: np.random.Generator, img: np.ndarray,
                 brightness: float = 0.1, contrast: float = 0.1,
                 saturation: float = 0.1) -> np.ndarray:
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    s = 1.0 + rng.uniform(-saturation, saturation)
    out = img * b
    mean = out.mean()
    out = (out - mean) * c + mean
    gray = out @ np.array([0.299, 0.587, 0.114], np.float32)
    out = (out - gray[..., None]) * s + gray[..., None]
    return np.clip(out, 0.0, 1.0)


@dataclasses.dataclass
class Sample:
    name: str
    image: np.ndarray          # (S, S, 3)
    features: np.ndarray       # (37, 37, C)
    depth: np.ndarray          # (256, 256)
    vlm_density: Optional[np.ndarray] = None
    # Distillation teacher (train/fit_teacher.py sidecar): raw decoder-head
    # targets (g, g, K, 16) + the fitted depth_offset scalar.
    teacher_raw: Optional[np.ndarray] = None
    teacher_do: Optional[np.ndarray] = None
    # Multi-view GT (corpus_v2 {name}_views.npz sidecar): (V, S, S, 3)
    # float32 in [0,1] + (V,) azimuth degrees — orbit cameras match
    # evaluation/novel_view_eval.py:render_views (el 0, distance 2).
    views: Optional[np.ndarray] = None
    view_azimuths_deg: Optional[np.ndarray] = None


class ImageDataset:
    def __init__(self, data_dir: str, image_size: int = 256,
                 feature_size: int = 37, feature_dim: int = 384,
                 use_augmentation: bool = True,
                 max_images: Optional[int] = None,
                 write_cache: bool = True,
                 teacher_experiment: int = 2, device=None):
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.image_size = image_size
        self.feature_size = feature_size
        self.feature_dim = feature_dim
        self.use_augmentation = use_augmentation
        self.write_cache = write_cache
        # Which experiment's distillation sidecars to pick up (exp-2 keeps
        # the bare "_teacher.npz" name, others are numbered — see
        # train/fit_teacher.py teacher_path).
        self.teacher_experiment = teacher_experiment
        self._extractor = None
        self._depth_estimator = None
        self._samples: List[Sample] = []

        paths = sorted(p for p in self.data_dir.glob("*")
                       if p.suffix.lower() in IMG_EXTS)
        if max_images is not None:
            paths = paths[:max_images]
        if not paths:
            raise FileNotFoundError(f"no images in {data_dir}")
        self.paths = paths
        for p in paths:
            self._samples.append(self._load_sample(p))

    def _get_extractor(self):
        if self._extractor is None:
            from fresnel_tpu_torch.models.encoders import (
                create_feature_extractor)
            self._extractor = create_feature_extractor(
                grid=self.feature_size, dim=self.feature_dim,
                device=self.device)
        return self._extractor

    def _load_sample(self, path: Path) -> Sample:
        name = path.stem
        img = _load_image(path, self.image_size)
        g, c = self.feature_size, self.feature_dim
        _, feat_path, depth_path, vlm_path = cache_paths(
            path, self.image_size, c)
        if feat_path.exists():
            feats = np.fromfile(feat_path, np.float32).reshape(g, g, c)
        else:
            feats = self._get_extractor()(
                torch.from_numpy(img).to(self.device)).cpu().numpy()
            if self.write_cache:
                feats.astype(np.float32).tofile(feat_path)

        if depth_path.exists():
            d = np.fromfile(depth_path, np.float32)
            side = int(round(len(d) ** 0.5))
            depth = d.reshape(side, side)
        else:
            from fresnel_tpu_torch.models.encoders import (
                create_depth_estimator)
            if self._depth_estimator is None:
                self._depth_estimator = create_depth_estimator(
                    "auto", device=self.device)
            depth = self._depth_estimator(
                torch.from_numpy(img).to(self.device), 256).cpu().numpy()
            if self.write_cache:
                depth.astype(np.float32).tofile(depth_path)

        vlm = np.load(vlm_path) if vlm_path.exists() else None
        t_raw = t_do = None
        suffix = ("_teacher.npz" if self.teacher_experiment == 2
                  else f"_teacher{self.teacher_experiment}.npz")
        t_path = path.with_name(path.stem + suffix)
        if t_path.exists():
            with np.load(t_path) as t:
                t_raw = t["raw"].astype(np.float32)
                t_do = t["depth_offset"].astype(np.float32)
        views = view_az = None
        v_path = path.with_name(path.stem + "_views.npz")
        if v_path.exists():
            with np.load(v_path) as z:
                views = z["images"].astype(np.float32) / 255.0
                view_az = z["azimuths_deg"].astype(np.float32)
            if views.shape[1] != self.image_size:
                views = np.stack([_resize_rgb(v, self.image_size)
                                  for v in views])
        return Sample(name=name, image=img, features=feats, depth=depth,
                      vlm_density=vlm, teacher_raw=t_raw, teacher_do=t_do,
                      views=views, view_azimuths_deg=view_az)

    def __len__(self) -> int:
        return len(self._samples)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._samples))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            imgs, feats, depths, vlms = [], [], [], []
            for j in idx:
                s = self._samples[j]
                img = s.image
                if self.use_augmentation:
                    img = color_jitter(rng, img)
                imgs.append(np.transpose(img, (2, 0, 1)))       # (3, S, S)
                feats.append(s.features)
                depths.append(s.depth)
                if s.vlm_density is not None:
                    vlms.append(s.vlm_density)
            batch = {
                "image": np.stack(imgs),
                "features": np.stack(feats),
                "depth": np.stack(depths),
            }
            if len(vlms) == len(idx):
                batch["vlm_density"] = np.stack(vlms)[:, None]  # (B, 1, gh, gw)
            teachers = [self._samples[j] for j in idx]
            if all(s.teacher_raw is not None for s in teachers):
                batch["teacher_raw"] = np.stack(
                    [s.teacher_raw for s in teachers])
                batch["teacher_do"] = np.stack(
                    [s.teacher_do for s in teachers])
            if all(s.views is not None for s in teachers):
                # (B, V, 3, S, S) — channels-first like "image"
                batch["views"] = np.stack(
                    [np.transpose(s.views, (0, 3, 1, 2)) for s in teachers])
                batch["view_azimuths_deg"] = teachers[0].view_azimuths_deg
            yield batch


class SyntheticGaussianDataset:
    """Procedural scenes: random Gaussian clouds rendered to images on
    `device` (the tiled renderer: K1 on the card)."""

    def __init__(self, n_samples: int = 16, image_size: int = 256,
                 feature_size: int = 37, feature_dim: int = 384,
                 n_gaussians: int = 120, seed: int = 0, device=None):
        from fresnel_tpu_torch.core.camera import Camera
        from fresnel_tpu_torch.core.gaussians import GaussianCloud
        from fresnel_tpu_torch.models.encoders import (
            create_feature_extractor, gradient_depth_estimate)
        from fresnel_tpu_torch.render.tile import render_tiled

        dev = resolve_device(device)
        self.image_size = image_size
        extractor = create_feature_extractor(grid=feature_size,
                                             dim=feature_dim, device=dev)
        cam = Camera.default_training(image_size)
        self._samples: List[Sample] = []
        with torch.no_grad():
            for i in range(n_samples):
                cloud = GaussianCloud.test_cloud(
                    n_gaussians, seed=seed * 1000 + i, spread=0.5,
                    z_offset=-2.0, scale=0.12).to(dev)
                img, _ = render_tiled(
                    cloud.positions, cloud.scales, cloud.rotations,
                    cloud.colors, cloud.opacities, cam, return_depth=True)
                img_hwc = img.permute(1, 2, 0).contiguous()
                feats = extractor(img_hwc).cpu().numpy()
                depth = gradient_depth_estimate(img_hwc, 256).cpu().numpy()
                self._samples.append(Sample(
                    name=f"synthetic_{i}", image=img_hwc.cpu().numpy(),
                    features=feats, depth=depth))

    def __len__(self) -> int:
        return len(self._samples)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._samples))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            batch = {
                "image": np.stack(
                    [np.transpose(self._samples[j].image, (2, 0, 1)) for j in idx]),
                "features": np.stack([self._samples[j].features for j in idx]),
                "depth": np.stack([self._samples[j].depth for j in idx]),
            }
            teachers = [self._samples[j] for j in idx]
            if all(s.teacher_raw is not None for s in teachers):
                batch["teacher_raw"] = np.stack(
                    [s.teacher_raw for s in teachers])
                batch["teacher_do"] = np.stack(
                    [s.teacher_do for s in teachers])
            if all(s.views is not None for s in teachers):
                batch["views"] = np.stack(
                    [np.transpose(s.views, (0, 3, 1, 2)) for s in teachers])
                batch["view_azimuths_deg"] = teachers[0].view_azimuths_deg
            yield batch
