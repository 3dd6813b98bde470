"""Procedural depth estimators, the patch feature extractor and their
factories.

Counterpart of fresnel_tpu/models/encoders.py: `gradient_depth_estimate`
(luminance Sobel magnitude, blurred, blended with a centre prior),
`center_depth_estimate` (radial prior), `FallbackDepthEstimator`,
`create_depth_estimator`, `PatchFeatureExtractor` (the deterministic
DINOv2 stand-in) and `create_feature_extractor`.  The real DINOv2 and
Depth-Anything extractors with weights from disk are not ported: when
"auto" (or "dinov2" / "depth_anything") finds weights, the factories raise
NotImplementedError rather than quietly using a fallback.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fresnel_tpu_torch.physics.fresnel_zones import sobel_gradients

_DEPTH_CANDIDATES = ("depth_anything_v2_small.pth",
                     "depth_anything_v2_small.pt",
                     "depth_anything_v2_small.safetensors",
                     "depth_anything_v2_small.bin",
                     "depth_anything.pth", "depth_anything.safetensors")
_LUMA = (0.299, 0.587, 0.114)


def _resize_weights(n_in: int, n_out: int, antialias: bool = True
                    ) -> np.ndarray:
    """(n_in, n_out) float32 weights of a linear resize along one axis,
    antialiased when downsampling (if `antialias`), computed in float32 in
    the order of jax.image.scale_and_translate's weight matrix."""
    f = np.float32
    inv = f(1.0 / (n_out / n_in))
    kscale = max(inv, f(1.0)) if antialias else f(1.0)
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * inv - f(0.0) * inv - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kscale
    w = np.maximum(f(0.0), f(1.0) - np.abs(x))
    tot = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, f(1.0)), f(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0.0)).astype(f)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W) -> (..., out_h, out_w) bilinear with half-pixel centres,
    antialiased when downsampling: what jax.image.resize(..., "linear")
    does to the last two axes, as two products with its weight matrices,
    the weights rounded as JAX rounds them (F.interpolate places samples
    up to ~1e-5 px apart, which moves an upsampled image by ~4e-6)."""
    H, W = x.shape[-2:]
    if H != out_h:
        wh = torch.from_numpy(_resize_weights(H, out_h)).to(x)
        x = torch.einsum("...hw,hH->...Hw", x, wh)
    if W != out_w:
        ww = torch.from_numpy(_resize_weights(W, out_w)).to(x)
        x = torch.einsum("...hw,wW->...hW", x, ww)
    return x


def _box_blur(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """(..., H, W) box blur: edge padding, then window means along H and
    then W."""
    pad = k // 2
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = F.pad(img.reshape(1, -1, H, W), (pad, pad, pad, pad),
              mode="replicate")
    x = x.unfold(2, k, 1).sum(-1) / k
    x = x.unfold(3, k, 1).sum(-1) / k
    return x.reshape(*lead, H, W)


def _center_prior(out_size: int, device) -> torch.Tensor:
    """1 - r / sqrt(2) over a [-1, 1]^2 grid: 1 at the centre."""
    ys = torch.linspace(-1.0, 1.0, out_size, device=device)
    YY, XX = torch.meshgrid(ys, ys, indexing="ij")
    return 1.0 - torch.sqrt(XX * XX + YY * YY) / math.sqrt(2.0)


def gradient_depth_estimate(image: torch.Tensor,
                            out_size: int = 256) -> torch.Tensor:
    """(H, W, 3) image in [0, 1] -> (out_size, out_size) depth in [0, 1]:
    strong edges read as closer, blended with a centre prior."""
    luma = torch.tensor(_LUMA, dtype=image.dtype, device=image.device)
    gray = (image * luma).sum(-1)
    gray = resize_linear(gray, out_size, out_size)
    gx, gy = sobel_gradients(gray)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-8)
    mag = _box_blur(mag, 7)
    mag = mag / torch.clamp(mag.max(), min=1e-6)
    depth = 0.6 * mag + 0.4 * _center_prior(out_size, image.device)
    lo, hi = depth.min(), depth.max()
    return (depth - lo) / torch.clamp(hi - lo, min=1e-6)


def center_depth_estimate(image: torch.Tensor,
                          out_size: int = 256) -> torch.Tensor:
    """Radial centre-prior depth (closer at the centre); ignores the
    image but for its device."""
    return _center_prior(out_size, image.device)


def _probe_weights(candidates) -> Optional[str]:
    """First existing candidate file under FRESNEL_TPU_MODELS (env),
    ./models or ~/models."""
    roots = [os.environ.get("FRESNEL_TPU_MODELS"), "models",
             os.path.join(os.path.expanduser("~"), "models")]
    for root in roots:
        if not root or not os.path.isdir(root):
            continue
        for name in candidates:
            path = os.path.join(root, name)
            if os.path.exists(path):
                return path
    return None


class FallbackDepthEstimator:
    """Procedural estimator: callable (image (H, W, 3), out_size=256) ->
    (out_size, out_size) depth, with `.kind` and `.weights_path`."""

    def __init__(self, kind: str):
        if kind not in ("gradient", "center"):
            raise ValueError(f"unknown fallback estimator: {kind}")
        self.kind = kind
        self.weights_path = None
        self._fn = (gradient_depth_estimate if kind == "gradient"
                    else center_depth_estimate)

    def __call__(self, image: torch.Tensor,
                 out_size: int = 256) -> torch.Tensor:
        return self._fn(image, out_size)


def create_depth_estimator(kind: str = "auto") -> FallbackDepthEstimator:
    """'auto' probes for Depth-Anything weights and falls back to the
    gradient estimator when there are none; 'gradient' and 'center' are
    the procedural estimators.  Found weights raise NotImplementedError:
    the weight-loaded Depth-Anything estimator is not ported."""
    if kind in ("auto", "depth_anything"):
        path = _probe_weights(_DEPTH_CANDIDATES)
        if path is not None:
            raise NotImplementedError(
                f"Depth-Anything weights found at {path}, but loading them "
                "is not ported (ROADMAP Queue 1, item 2); pass "
                "depth_estimator='gradient' to use the procedural estimator")
        if kind == "depth_anything":
            raise FileNotFoundError(
                "no Depth-Anything weights found (set FRESNEL_TPU_MODELS or "
                f"place one of {_DEPTH_CANDIDATES} under ./models)")
        return FallbackDepthEstimator("gradient")
    if kind in ("gradient", "center"):
        return FallbackDepthEstimator(kind)
    raise ValueError(f"unknown depth estimator: {kind}")


# ----------------------------------------------------------------------
# PatchFeatureExtractor: its fixed projection is jax.random.normal's draw
# ----------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al.), as JAX's PRNG runs it,
    on uint32 arrays."""
    def rotl(v, r):
        return (v << np.uint32(r)) | (v >> np.uint32(32 - r))

    ks = (np.uint32(k0), np.uint32(k1),
          np.uint32(k0 ^ k1 ^ 0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _xla_erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function (Giles' polynomials), evaluated
    in float32 in the same order."""
    small = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
             -4.39150654e-06, 0.00021858087, -0.00125372503,
             -0.00417768164, 0.246640727, 1.50140941)
    large = (-0.000200214257, 0.000100950558, 0.00134934322,
             -0.00367342844, 0.00573950773, -0.0076224613,
             0.00943887047, 1.00167406, 2.83297682)
    f = np.float32
    x = x.astype(f)
    w = -np.log1p(-x * x)
    lt = w < f(5.0)
    ws = w - f(2.5)
    wl = np.sqrt(w) - f(3.0)
    ps = np.full_like(x, f(small[0]))
    pl = np.full_like(x, f(large[0]))
    for a, b in zip(small[1:], large[1:]):
        ps = f(a) + ps * ws
        pl = f(b) + pl * wl
    p = np.where(lt, ps, pl)
    return np.where(np.abs(x) == f(1.0), x * f(np.inf), p * x)


def jax_normal(seed: int, shape) -> np.ndarray:
    """What `jax.random.normal(jax.random.PRNGKey(seed), shape)` gives in
    float32, drawn with numpy: threefry bits of the flat index (split into
    high and low words, JAX's partitionable scheme) xored, mapped to
    [-1, 1) and through sqrt(2) * erfinv."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k0, k1 = (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF
    with np.errstate(over="ignore"):
        b0, b1 = _threefry2x32(k0, k1, hi, lo)
    bits = b0 ^ b1
    f = np.float32
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(f) - f(1.0)
    lo_v = np.nextafter(f(-1.0), f(np.inf))
    u = np.maximum(lo_v, floats * (f(1.0) - lo_v) + lo_v)
    return (f(np.sqrt(2.0)) * _xla_erfinv(u)).astype(f).reshape(shape)


class PatchFeatureExtractor:
    """Deterministic DINOv2 stand-in: (H, W, 3) -> (grid, grid, dim).

    Per 14x14-equivalent patch: mean and std colour, Sobel energy and a 5x5
    thumbnail, standardised and projected to `dim` by the JAX package's
    seeded random matrix (`jax_normal(seed, (82, dim)) / sqrt(82)`)."""

    kind = "patch"
    weights_path = None
    RAW_DIM = 82       # 3 mean + 3 std + 1 grad + 75 thumbnail

    def __init__(self, grid: int = 37, dim: int = 384, seed: int = 0):
        self.grid = grid
        self.dim = dim
        self.proj = torch.from_numpy(
            jax_normal(seed, (self.RAW_DIM, dim))
            / np.float32(np.sqrt(self.RAW_DIM)))

    def __call__(self, image) -> torch.Tensor:
        img = torch.as_tensor(image, dtype=torch.float32)
        g = self.grid
        size = g * 14
        chw = resize_linear(img.permute(2, 0, 1), size, size)
        hwc = chw.permute(1, 2, 0)
        patches = hwc.reshape(g, 14, g, 14, 3).permute(0, 2, 1, 3, 4)
        mean = patches.mean(dim=(2, 3))
        std = patches.std(dim=(2, 3), correction=0)
        luma = torch.tensor(_LUMA, dtype=hwc.dtype, device=hwc.device)
        gray = (hwc * luma).sum(-1)
        gx, gy = sobel_gradients(gray)
        mag = torch.sqrt(gx * gx + gy * gy + 1e-8)
        grad = mag.reshape(g, 14, g, 14).permute(0, 2, 1, 3).mean(
            dim=(2, 3))[..., None]
        small = resize_linear(chw, g * 5, g * 5).permute(1, 2, 0)
        thumb = small.reshape(g, 5, g, 5, 3).permute(0, 2, 1, 3, 4)
        thumb = thumb.reshape(g, g, 75)
        raw = torch.cat([mean, std, grad, thumb], dim=-1)            # (g, g, 82)
        raw = (raw - raw.mean()) / torch.clamp(raw.std(correction=0),
                                               min=1e-6)
        return raw @ self.proj.to(raw.device)


_DINOV2_CANDIDATES = {
    384: ("dinov2_small.pth", "dinov2_small.pt", "dinov2_small.bin",
          "dinov2_small.safetensors", "dinov2.pth",
          "dinov2_vits14_pretrain.pth"),
    768: ("dinov2_base.pth", "dinov2_base.safetensors",
          "dinov2_vitb14_pretrain.pth"),
    1024: ("dinov2_large.pth", "dinov2_large.safetensors",
           "dinov2_vitl14_pretrain.pth"),
}


def create_feature_extractor(kind: str = "auto", grid: int = 37,
                             dim: int = 384) -> PatchFeatureExtractor:
    """'auto' probes for DINOv2 weights of width `dim` and falls back to
    the patch extractor when there are none; 'patch' / 'fallback' is the
    patch extractor.  Found weights raise NotImplementedError: the
    weight-loaded DINOv2 extractor is not ported."""
    if kind in ("auto", "dinov2"):
        cands = _DINOV2_CANDIDATES.get(dim)
        path = _probe_weights(cands) if cands else None
        if path is not None:
            raise NotImplementedError(
                f"DINOv2 weights found at {path}, but loading them is not "
                "ported (ROADMAP Queue 1, item 2); pass kind='patch' to use "
                "the patch extractor")
        if kind == "dinov2":
            raise FileNotFoundError(
                f"no DINOv2 weights found for dim={dim} (set "
                "FRESNEL_TPU_MODELS or place a checkpoint under ./models)")
    elif kind not in ("patch", "fallback"):
        raise ValueError(f"unknown feature extractor: {kind}")
    return PatchFeatureExtractor(grid=grid, dim=dim)
