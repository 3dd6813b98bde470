"""TRELLIS distillation datasets (Fresnel v2).

Counterpart of fresnel_tpu/data/trellis.py.  A sample directory holds the
teacher's outputs:
  features.pt    (num_patches, 1024) DINOv2-large features (or (1, P, F))
  coords.pt      (N, 4) [batch_idx, x, y, z] sparse voxel coords (or (N, 3))
  gaussians.ply  a standard 3DGS PLY (read by core/io.py)
Samples are padded to static (max_coords, max_gaussians) with validity
masks, and occupancy targets come from Gaussian proximity (a voxel centre
within 0.15 of a Gaussian, in [-1, 1] units).  `SyntheticTrellisDataset`
fabricates consistent samples (Gaussians on random blob surfaces, their
voxels plus distractors, random features) so the path runs with no
outside data.

The numpy code is the JAX package's, so a seed gives the same samples and
the same batch order, bit for bit.  Samples stay numpy on the host; the
trainer moves each batch to its device.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _load_pt(path: Path) -> np.ndarray:
    t = torch.load(str(path), map_location="cpu", weights_only=False)
    return np.asarray(t.detach().numpy() if hasattr(t, "detach") else t,
                      np.float32)


def _occupancy_targets(coords_xyz: np.ndarray, gauss_pos: np.ndarray,
                       threshold: float = 0.15,
                       grid_resolution: int = 64) -> np.ndarray:
    """(N,) float32: 1 where a voxel's centre lies within `threshold` of a
    Gaussian position.  The squared distances are summed axis by axis, x
    then y then z: the JAX package's `sum(-1)` over the 3 axis in the same
    order (the same bits), without its (N, M, 3) temporary (4x faster at
    4 096 x 16 384)."""
    centers = coords_xyz.astype(np.float32) / grid_resolution * 2 - 1
    if len(gauss_pos) == 0:
        return np.zeros(len(centers), np.float32)
    d2 = (centers[:, None, 0] - gauss_pos[None, :, 0]) ** 2
    for k in (1, 2):
        d2 += (centers[:, None, k] - gauss_pos[None, :, k]) ** 2
    return (d2.min(1) < threshold ** 2).astype(np.float32)


class TrellisDistillationDataset:
    """The sample directories under `data_dir` that hold all three files,
    sorted by name, loaded and padded at construction."""

    def __init__(self, data_dir: str, max_coords: int = 4096,
                 max_gaussians: int = 16384,
                 occupancy_threshold: float = 0.15,
                 max_samples: Optional[int] = None):
        self.max_coords = max_coords
        self.max_gaussians = max_gaussians
        self.occupancy_threshold = occupancy_threshold
        root = Path(data_dir)
        dirs = sorted(d for d in root.iterdir() if d.is_dir()
                      and (d / "features.pt").exists()
                      and (d / "coords.pt").exists()
                      and (d / "gaussians.ply").exists())
        if max_samples:
            dirs = dirs[:max_samples]
        if not dirs:
            raise FileNotFoundError(f"no TRELLIS samples in {data_dir}")
        self._samples = [self._load(d) for d in dirs]

    def _load(self, d: Path) -> Dict[str, np.ndarray]:
        from fresnel_tpu_torch.core import io as gio

        feats = _load_pt(d / "features.pt")
        if feats.ndim == 3:
            feats = feats[0]
        coords = _load_pt(d / "coords.pt").astype(np.int32)
        if coords.shape[-1] == 3:
            coords = np.concatenate(
                [np.zeros((len(coords), 1), np.int32), coords], -1)
        cloud = gio.load_ply(d / "gaussians.ply")
        gauss = cloud.to_flat().numpy().astype(np.float32)
        return self._pad(feats, coords, gauss)

    def _pad(self, feats, coords, gauss) -> Dict[str, np.ndarray]:
        mc, mg = self.max_coords, self.max_gaussians
        nc = min(len(coords), mc)
        ng = min(len(gauss), mg)
        c = np.zeros((mc, 4), np.int32)
        c[:nc] = coords[:nc]
        cm = np.zeros(mc, bool)
        cm[:nc] = True
        g = np.zeros((mg, 14), np.float32)
        g[:ng] = gauss[:ng]
        gm = np.zeros(mg, bool)
        gm[:ng] = True
        occ = _occupancy_targets(c[:, 1:4], g[:ng, :3],
                                 self.occupancy_threshold) * cm
        return {"features": feats.astype(np.float32), "coords": c,
                "coord_mask": cm, "gaussians": g, "gaussian_mask": gm,
                "occupancy": occ.astype(np.float32)}

    def __len__(self) -> int:
        return len(self._samples)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._samples))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i: i + batch_size]
            keys = self._samples[0].keys()
            yield {k: np.stack([self._samples[j][k] for j in idx])
                   for k in keys}


class SyntheticTrellisDataset(TrellisDistillationDataset):
    """Procedural teacher samples: Gaussians on random blob surfaces, coords
    their voxelization plus half as many random distractor voxels,
    features random normals (deterministic per seed)."""

    def __init__(self, n_samples: int = 8, max_coords: int = 512,
                 max_gaussians: int = 1024, n_gaussians: int = 600,
                 feature_dim: int = 1024, num_patches: int = 1369,
                 seed: int = 0):
        self.max_coords = max_coords
        self.max_gaussians = max_gaussians
        self.occupancy_threshold = 0.15
        self._samples = []
        rng = np.random.default_rng(seed)
        for _ in range(n_samples):
            dirs = rng.normal(size=(n_gaussians, 3))
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            radii = 0.5 + 0.2 * np.sin(3 * dirs[:, 0]) * np.cos(2 * dirs[:, 1])
            pos = (dirs * radii[:, None]).astype(np.float32)
            gauss = np.zeros((n_gaussians, 14), np.float32)
            gauss[:, :3] = pos
            gauss[:, 3:6] = rng.uniform(0.005, 0.03, (n_gaussians, 3))
            quat = rng.normal(size=(n_gaussians, 4)).astype(np.float32)
            gauss[:, 6:10] = quat / np.linalg.norm(quat, -1, keepdims=True)
            gauss[:, 10:13] = rng.uniform(0.2, 1.0, (n_gaussians, 3))
            gauss[:, 13] = rng.uniform(0.5, 1.0, n_gaussians)

            vox = np.unique(((pos + 1) / 2 * 63).astype(np.int32), axis=0)
            coords = np.concatenate(
                [np.zeros((len(vox), 1), np.int32), vox], -1)
            extra = rng.integers(0, 64, size=(len(vox) // 2, 3)).astype(
                np.int32)
            coords = np.concatenate(
                [coords,
                 np.concatenate([np.zeros((len(extra), 1), np.int32), extra],
                                -1)])
            feats = rng.normal(size=(num_patches, feature_dim)).astype(
                np.float32)
            self._samples.append(self._pad(feats, coords, gauss))

    def write(self, data_dir: str) -> None:
        """Write each sample's valid rows in the TRELLIS layout under
        `data_dir/sample_{i:04d}/` (features.pt, coords.pt, gaussians.ply),
        which TrellisDistillationDataset reads back (the PLY stores log
        scales and logit opacities, so those come back within float32
        rounding)."""
        from fresnel_tpu_torch.core import io as gio
        from fresnel_tpu_torch.core.gaussians import GaussianCloud

        for i, s in enumerate(self._samples):
            d = Path(data_dir) / f"sample_{i:04d}"
            d.mkdir(parents=True, exist_ok=True)
            torch.save(torch.from_numpy(s["features"]), d / "features.pt")
            torch.save(torch.from_numpy(s["coords"][s["coord_mask"]]),
                       d / "coords.pt")
            gauss = torch.from_numpy(s["gaussians"][s["gaussian_mask"]])
            gio.save_ply(d / "gaussians.ply", GaussianCloud.from_flat(gauss))
