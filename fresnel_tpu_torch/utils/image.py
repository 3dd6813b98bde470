"""Image / depth-map host utilities.

Counterpart of fresnel_tpu/utils/image.py (reference:
src/core/image.{hpp,cpp}): depth range / normalise, the depth colormap,
PPM export (the reference's bridge format), PNG save and a bilinear
resize.  Host-side numpy, as in the JAX package; the port keeps its own
copy.  `resize` computes what the JAX package's native C++ resize
computes (half-pixel centres, edge clamp, no antialiasing, float32 with
no fused multiply-add), in numpy.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

# 9-stop turbo-like colormap anchors (r, g, b).
_COLORMAP = np.array([
    [0.19, 0.07, 0.23], [0.28, 0.26, 0.71], [0.15, 0.55, 0.92],
    [0.06, 0.77, 0.72], [0.45, 0.90, 0.35], [0.83, 0.88, 0.22],
    [0.98, 0.68, 0.18], [0.91, 0.36, 0.13], [0.66, 0.10, 0.10],
], np.float32)


def depth_range(depth: np.ndarray) -> Tuple[float, float]:
    return float(depth.min()), float(depth.max())


def normalize_depth(depth: np.ndarray) -> np.ndarray:
    lo, hi = depth_range(depth)
    return (depth - lo) / max(hi - lo, 1e-8)


def depth_colormap(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) float color visualization."""
    d = normalize_depth(np.asarray(depth, np.float32))
    pos = d * (len(_COLORMAP) - 1)
    i0 = np.clip(pos.astype(np.int32), 0, len(_COLORMAP) - 2)
    t = (pos - i0)[..., None]
    return _COLORMAP[i0] * (1 - t) + _COLORMAP[i0 + 1] * t


def save_ppm(path, image: np.ndarray) -> None:
    """(H, W, 3) float [0,1] -> binary P6 PPM (the reference bridge format,
    src/core/image.cpp)."""
    img = np.clip(np.asarray(image), 0, 1)
    h, w = img.shape[:2]
    data = (img * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(data.tobytes())


def load_ppm(path) -> np.ndarray:
    raw = Path(path).read_bytes()
    # Parse "P6\nW H\n255\n" allowing arbitrary whitespace.
    parts = raw.split(maxsplit=4)
    if parts[0] != b"P6":
        raise ValueError(f"{path} is not a binary PPM")
    w, h, maxv = int(parts[1]), int(parts[2]), int(parts[3])
    pixels = np.frombuffer(parts[4][: w * h * 3], np.uint8)
    return pixels.reshape(h, w, 3).astype(np.float32) / maxv


def save_png(path, image: np.ndarray) -> None:
    from PIL import Image

    img = np.clip(np.asarray(image), 0, 1)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[0] < img.shape[-1]:
        img = img.transpose(1, 2, 0)  # CHW -> HWC
    if img.ndim == 2:
        img = depth_colormap(img)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def _taps(n_in: int, n_out: int):
    """(i0, i1, w) of one axis: the two clamped source indices of each
    output sample and the weight of the second, in float32."""
    s = np.float32(n_in) / np.float32(n_out)
    f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * s \
        - np.float32(0.5)
    i0 = np.floor(f).astype(np.int64)
    w = f - i0.astype(np.float32)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w)


def resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of (H, W) or (H, W, C) float32."""
    img = np.asarray(image, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    y0, y1, wy = _taps(img.shape[0], out_h)
    x0, x1, wx = _taps(img.shape[1], out_w)
    wx, wy = wx[None, :, None], wy[:, None, None]
    one = np.float32(1)
    top = img[y0][:, x0] * (one - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (one - wx) + img[y1][:, x1] * wx
    out = top * (one - wy) + bot * wy
    return out[..., 0] if squeeze else out
