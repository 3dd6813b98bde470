"""Streaming dataset: batches read from disk caches by a prefetch thread.

Counterpart of fresnel_tpu/data/streaming.py.  `ImageDataset` holds
every decoded sample in host memory; a corpus at LPFF / FFHQ scale does
not fit, so this streams instead.  One pass materialises raw float32
caches next to the images ({name}_rgb{S}.bin beside the reference's
{name}_dinov2.bin / {name}_depth.bin contract, reference:
scripts/training/train_gaussian_decoder.py:525-681), with the byte
sizes checked; then each batch is read from them.

The JAX package double-buffers through its native C++ prefetcher.  Here
one background thread reads batch k+1 (into pinned host tensors when the
dataset's device is the card, so the trainer's copy to the card is a DMA)
while step k runs.  The thread only reads: colour jitter draws from the
caller's generator, in the consumer, one draw per image in index order,
so the batches are the JAX class's for the same generator.  An exception
in the thread is raised in the consumer; nothing falls back to a
synchronous read on its own (`prefetch=False` asks for one).
"""

from __future__ import annotations

import queue
import sys
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from fresnel_tpu_torch.data.dataset import (
    IMG_EXTS, _load_image, cache_paths, color_jitter)
from fresnel_tpu_torch.device import resolve_device

DEPTH_SIDE = 256          # every depth cache is (256, 256)


class StreamingImageDataset:
    """Disk-streamed batches, read ahead by one thread.

    Interface-compatible with ImageDataset (`__len__` / `batches`).
    """

    def __init__(self, data_dir: str, image_size: int = 256,
                 feature_size: int = 37, feature_dim: int = 384,
                 use_augmentation: bool = True,
                 max_images: Optional[int] = None,
                 prefetch: bool = True, device=None):
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.image_size = image_size
        self.feature_size = feature_size
        self.feature_dim = feature_dim
        self.use_augmentation = use_augmentation
        self.prefetch = prefetch

        paths = sorted(p for p in self.data_dir.glob("*")
                       if p.suffix.lower() in IMG_EXTS)
        if max_images is not None:
            paths = paths[:max_images]
        if not paths:
            raise FileNotFoundError(f"no images in {data_dir}")
        self._image_files: List[Path] = paths
        self._extractor = None
        self._depth_estimator = None
        self._ensure_caches()

    # -- cache materialisation ------------------------------------------

    def _get_extractor(self):
        if self._extractor is None:
            from fresnel_tpu_torch.models.encoders import (
                create_feature_extractor)
            self._extractor = create_feature_extractor(
                grid=self.feature_size, dim=self.feature_dim,
                device=self.device)
        return self._extractor

    def _cache_paths(self, img_path: Path):
        return cache_paths(img_path, self.image_size, self.feature_dim)[:3]

    def _region_floats(self):
        S, g, c = self.image_size, self.feature_size, self.feature_dim
        return S * S * 3, g * g * c, DEPTH_SIDE * DEPTH_SIDE

    def _ensure_caches(self):
        """Create (or re-create) caches; validates byte sizes.

        Batches read fixed float counts per region, so a cache written at
        another resolution (ImageDataset accepts any square depth map)
        would be read as garbage: a cache of the wrong size is recomputed
        at this dataset's shapes, with a warning."""
        expect = [4 * n for n in self._region_floats()]

        def ok(path, kind):
            return path.exists() and path.stat().st_size == expect[kind]

        for p in self._image_files:
            rgb_path, feat_path, depth_path = self._cache_paths(p)
            need = [not ok(path, kind) for kind, path in
                    enumerate((rgb_path, feat_path, depth_path))]
            if not any(need):
                continue
            for path, needed in zip((rgb_path, feat_path, depth_path), need):
                if needed and path.exists():
                    print(f"warning: cache {path} has unexpected size "
                          f"{path.stat().st_size} B — recomputing at this "
                          f"dataset's shapes (old file overwritten)",
                          file=sys.stderr)
            img = _load_image(p, self.image_size)
            if need[0]:
                img.astype(np.float32).tofile(rgb_path)
            if not (need[1] or need[2]):
                continue
            timg = torch.from_numpy(img).to(self.device)
            with torch.no_grad():
                if need[1]:
                    feats = self._get_extractor()(timg).float().cpu().numpy()
                    feats.astype(np.float32).tofile(feat_path)
                if need[2]:
                    if self._depth_estimator is None:
                        from fresnel_tpu_torch.models.encoders import (
                            create_depth_estimator)
                        self._depth_estimator = create_depth_estimator(
                            "auto", device=self.device)
                    depth = self._depth_estimator(
                        timg, DEPTH_SIDE).float().cpu().numpy()
                    depth.astype(np.float32).tofile(depth_path)

    # -- batch streaming ------------------------------------------------

    def __len__(self) -> int:
        return len(self._image_files)

    def _read(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        """One batch's caches as they are on disk: "image" (B, S, S, 3),
        "features" (B, g, g, C), "depth" (B, 256, 256), read into pinned
        host tensors when the device is the card; "vlm_density" (B, 1,
        gh, gw) only when every sample has one (the ImageDataset.batches
        contract).  Touches no generator."""
        S, g, c = self.image_size, self.feature_size, self.feature_dim
        B = len(idx)
        pin = self.device.type == "cuda"
        out = {}
        for kind, (key, shape) in enumerate((
                ("image", (S, S, 3)), ("features", (g, g, c)),
                ("depth", (DEPTH_SIDE, DEPTH_SIDE)))):
            buf = torch.empty((B,) + shape, dtype=torch.float32,
                              pin_memory=pin).numpy()
            for b, j in enumerate(idx):
                path = self._cache_paths(self._image_files[j])[kind]
                with open(path, "rb") as f:
                    n = f.readinto(memoryview(buf[b]).cast("B"))
                if n != buf[b].nbytes:
                    raise IOError(f"cache {path} holds {n} B, expected "
                                  f"{buf[b].nbytes}")
            out[key] = buf
        maps = []
        for j in idx:
            vp = cache_paths(self._image_files[j], self.image_size,
                             self.feature_dim)[3]
            if not vp.exists():
                break
            maps.append(np.load(vp))
        else:
            out["vlm_density"] = np.stack(maps)[:, None]
        return out

    def _assemble(self, raw: Dict[str, np.ndarray],
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """The yielded batch: images jittered one by one in index order
        (one draw each from `rng`) and put channels-first."""
        imgs = raw["image"]
        if self.use_augmentation:
            imgs = np.stack([color_jitter(rng, im) for im in imgs])
        batch = {"image": np.ascontiguousarray(imgs.transpose(0, 3, 1, 2)),
                 "features": raw["features"], "depth": raw["depth"]}
        if "vlm_density" in raw:
            batch["vlm_density"] = raw["vlm_density"]
        return batch

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._image_files))
        if shuffle:
            rng.shuffle(order)
        groups = [order[i:i + batch_size] for i in
                  range(0, len(order) - batch_size + 1, batch_size)]
        if not groups:
            return
        if not self.prefetch:
            for idx in groups:
                yield self._assemble(self._read(idx), rng)
            return
        yield from self._prefetched(groups, rng)

    def _prefetched(self, groups, rng) -> Iterator[Dict[str, np.ndarray]]:
        """Batches read by one background thread: it holds at most one
        read batch in the queue and reads the next meanwhile.  Closing
        the generator (or an error on either side) stops the thread."""
        q: queue.Queue = queue.Queue(maxsize=1)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def reader():
            for idx in groups:
                if stop.is_set():
                    return
                try:
                    item = (True, self._read(idx))
                except Exception as e:               # raised in the consumer
                    put((False, e))
                    return
                if not put(item):
                    return

        def get():
            while True:
                try:
                    return q.get(timeout=0.05)
                except queue.Empty:
                    if not thread.is_alive() and q.empty():
                        raise RuntimeError("the prefetch thread ended "
                                           "without handing over a batch")

        thread = threading.Thread(target=reader, name="streaming-prefetch",
                                  daemon=True)
        thread.start()
        try:
            for _ in groups:
                ok, val = get()
                if not ok:
                    raise val
                yield self._assemble(val, rng)
        finally:
            stop.set()
            thread.join()
