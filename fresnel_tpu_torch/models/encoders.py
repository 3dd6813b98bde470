"""Image -> features and depth: the weight-loaded DINOv2 and
Depth-Anything, their fused dual trunk, the procedural fallbacks and the
factories.

Counterpart of fresnel_tpu/models/encoders.py: `gradient_depth_estimate`
(luminance Sobel magnitude, blurred, blended with a centre prior),
`center_depth_estimate` (radial prior), `FallbackDepthEstimator`,
`PatchFeatureExtractor` (the deterministic DINOv2 stand-in),
`DINOv2FeatureExtractor` and `DepthAnythingEstimator` (the ViTs of
models/vit.py with a checkpoint's weights, loaded strictly, computing in
bf16 by default), `FusedDinoDepthEncoder` (both trunks in one vmapped
forward) and the factories.  "auto" (or "dinov2" / "depth_anything")
loads weights found under $FRESNEL_TPU_MODELS, ./models or ~/models, and
falls back to the procedural estimators only when there are none: a file
that is found but does not load raises.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int, antialias: bool,
                   device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`_resize_weights` on `device` in `dtype`, made once: a fresh copy
    from the host each call would wait for the stream on the card."""
    return torch.from_numpy(_resize_weights(n_in, n_out, antialias)).to(
        device=device, dtype=dtype)


def resize_linear(x: torch.Tensor, out_h: int, out_w: int,
                  antialias: bool = True) -> torch.Tensor:
    """(..., H, W) -> (..., out_h, out_w) bilinear with half-pixel centres,
    antialiased when downsampling (unless `antialias` is False): what
    jax.image.resize(..., "linear") does to the last two axes, as two
    products with its weight matrices, rows first, the weights rounded as
    JAX rounds them and cast to x's dtype (in bf16 each product rounds to
    bf16, as XLA:CPU's does; F.interpolate places samples up to ~1e-5 px
    apart, which moves an upsampled image by ~4e-6)."""
    H, W = x.shape[-2:]
    if H != out_h:
        wh = _resize_matrix(H, out_h, antialias, x.device, x.dtype)
        x = torch.einsum("...hw,hH->...Hw", x, wh)
    if W != out_w:
        ww = _resize_matrix(W, out_w, antialias, x.device, x.dtype)
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


def create_depth_estimator(kind: str = "auto", device=None,
                           compute_dtype: Optional[torch.dtype] = None):
    """'auto' loads Depth-Anything weights found under the standard roots
    (FRESNEL_TPU_MODELS, ./models, ~/models) onto `device` (CUDA when
    None) and falls back to the gradient estimator when there are none;
    'depth_anything' needs the weights; 'gradient' and 'center' are the
    procedural estimators, which run on their image's device.  Returns a
    callable (image (H, W, 3), out_size=256) -> (out_size, out_size) depth
    with `.kind` and `.weights_path`."""
    if kind in ("auto", "depth_anything"):
        path = _probe_weights(_DEPTH_CANDIDATES)
        if path is not None:
            return DepthAnythingEstimator(path, compute_dtype=compute_dtype,
                                          device=device)
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
                             dim: int = 384, device=None,
                             compute_dtype: Optional[torch.dtype] = None):
    """'auto' loads DINOv2 weights of width `dim` found under the standard
    roots onto `device` (CUDA when None) and falls back to the patch
    extractor when there are none; 'dinov2' needs the weights; 'patch' /
    'fallback' is the patch extractor.  Returns a callable (image (H, W,
    3)) -> (grid, grid, dim) with `.kind` and `.weights_path`."""
    if kind in ("auto", "dinov2"):
        cands = _DINOV2_CANDIDATES.get(dim)
        path = _probe_weights(cands) if cands else None
        if path is not None:
            return DINOv2FeatureExtractor(path, grid=grid, dim=dim,
                                          compute_dtype=compute_dtype,
                                          device=device)
        if kind == "dinov2":
            raise FileNotFoundError(
                f"no DINOv2 weights found for dim={dim} (set "
                "FRESNEL_TPU_MODELS or place a checkpoint under ./models)")
    elif kind not in ("patch", "fallback"):
        raise ValueError(f"unknown feature extractor: {kind}")
    return PatchFeatureExtractor(grid=grid, dim=dim)


# ----------------------------------------------------------------------
# The weight-loaded backbones
# ----------------------------------------------------------------------

_DIM_TO_SIZE = {384: "small", 768: "base", 1024: "large"}
DEPTH_IMAGE_SIZE = 518


def _hwc_to_model(image, size: int, device) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> (1, size, size, 3) float32 on `device`, by
    jax.image.resize's linear weights (antialiased when downsampling)."""
    img = torch.as_tensor(image, dtype=torch.float32).to(device)
    return resize_linear(img.permute(2, 0, 1), size, size).permute(
        1, 2, 0)[None]


class DINOv2FeatureExtractor:
    """DINOv2 features: (H, W, 3) in [0, 1] -> (grid, grid, dim) float32.

    The checkpoint at `weights_path` is loaded strictly at construction
    (models/vit.py's converters, either naming, .pth or .safetensors);
    the image is resized to grid * 14 (518^2 for grid 37), normalised
    with ImageNet's statistics, and the final-norm patch tokens come out.
    `compute_dtype` is bf16 by default, as in the JAX package (float32
    parameters, float32 softmax and outputs)."""

    kind = "dinov2"

    def __init__(self, weights_path: str, grid: int = 37, dim: int = 384,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        from fresnel_tpu_torch.device import resolve_device
        from fresnel_tpu_torch.models.vit import (
            DINOv2, VIT_CONFIGS, convert_dinov2_torch, load_state_dict_strict)
        from fresnel_tpu_torch.weights import dinov2_state_dict

        size = _DIM_TO_SIZE.get(dim)
        if size is None:
            raise ValueError(f"no DINOv2 size with width {dim}")
        self.grid, self.dim = grid, dim
        self.weights_path = weights_path
        self.image_size = grid * 14
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
        model = DINOv2(image_size=self.image_size, dtype=dtype,
                       **VIT_CONFIGS[size])
        try:
            flat = convert_dinov2_torch(weights_path, size, self.image_size)
            self.n_loaded = load_state_dict_strict(model,
                                                   dinov2_state_dict(flat))
        except (ValueError, KeyError) as e:
            raise ValueError(f"DINOv2 weights at {weights_path} do not "
                             f"load: {e}") from e
        self.model = model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, image) -> torch.Tensor:
        return self.model(_hwc_to_model(image, self.image_size,
                                        self.device))[0]


class DepthAnythingEstimator:
    """Depth-Anything-V2 relative depth: (H, W, 3) in [0, 1] ->
    (out_size, out_size) in [0, 1].

    The whole checkpoint (backbone, DPT neck, head) is loaded strictly at
    construction; the model taps the default out_indices (3, 6, 9, 12),
    as the JAX package's estimator does (only `load_depth_anything` reads
    a config.json).  The image is resized to 518^2, the head's output
    min-max normalised and resized to `out_size` (jax.image.resize's
    linear weights, antialiased).  bf16 compute by default."""

    kind = "depth_anything"

    def __init__(self, weights_path: str, size: str = "small",
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        from fresnel_tpu_torch.device import resolve_device
        from fresnel_tpu_torch.models.vit import (
            VIT_CONFIGS, DepthAnything, convert_depth_anything_torch,
            load_state_dict_strict)
        from fresnel_tpu_torch.weights import depth_anything_state_dict

        self.weights_path = weights_path
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if compute_dtype is None else compute_dtype
        model = DepthAnything(out_size=DEPTH_IMAGE_SIZE,
                              image_size=DEPTH_IMAGE_SIZE, dtype=dtype,
                              **VIT_CONFIGS[size])
        try:
            flat = convert_depth_anything_torch(weights_path, size)
            self.n_loaded = load_state_dict_strict(
                model, depth_anything_state_dict(flat))
        except (ValueError, KeyError) as e:
            raise ValueError(f"Depth-Anything weights at {weights_path} do "
                             f"not load: {e}") from e
        self.model = model.to(self.device).eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, image, out_size: int = 256) -> torch.Tensor:
        rel = self.model(_hwc_to_model(image, DEPTH_IMAGE_SIZE,
                                       self.device))[0]
        return resize_linear(rel, out_size, out_size)


def _trunk_key(trunk) -> tuple:
    return (trunk.width, trunk.depth, trunk.heads, trunk.patch_size,
            trunk.image_size, trunk.dtype)


class FusedDinoDepthEncoder:
    """Both weight-loaded backbones in one trunk forward: image ->
    (features, depth).

    DINOv2 and Depth-Anything share the ViT-S/14 trunk; the two weight
    sets are stacked and one vmapped forward (models/vit.py
    `fused_features_and_depth`) taps both, so each trunk product runs
    once over both weight sets.  The outputs are those of the extractor
    and the estimator run apart.  The trunks must match in architecture,
    image size and compute dtype (ValueError otherwise: the fused trunk
    runs at the estimator's dtype)."""

    kind = "fused_dinov2_depth_anything"

    def __init__(self, extractor: DINOv2FeatureExtractor,
                 estimator: DepthAnythingEstimator):
        from fresnel_tpu_torch.models.vit import stack_trunk_params

        fm, dm = extractor.model, estimator.model.backbone
        if _trunk_key(fm) != _trunk_key(dm):
            raise ValueError(
                "the fused encoder needs matching trunks; got features "
                f"{_trunk_key(fm)} and depth backbone {_trunk_key(dm)}")
        if extractor.device != estimator.device:
            raise ValueError("the two backbones are on different devices: "
                             f"{extractor.device}, {estimator.device}")
        self.extractor, self.estimator = extractor, estimator
        self.grid = extractor.grid
        self.device = estimator.device
        self.weights_path = (extractor.weights_path, estimator.weights_path)
        self._stacked = stack_trunk_params(fm, estimator.model)

    @torch.no_grad()
    def __call__(self, image, out_size: int = 256):
        """(H, W, 3) in [0, 1] -> ((grid, grid, dim) float32, (out_size,
        out_size) depth)."""
        from fresnel_tpu_torch.models.vit import fused_features_and_depth

        model = self.estimator.model
        x = _hwc_to_model(image, model.backbone.image_size, self.device)
        feats, rel = fused_features_and_depth(model, self._stacked, x)
        return feats[0], resize_linear(rel[0], out_size, out_size)


def create_fused_encoder(extractor, estimator
                         ) -> Optional[FusedDinoDepthEncoder]:
    """A FusedDinoDepthEncoder when both are the weight-loaded models with
    matching trunks, else None (the caller runs them apart)."""
    if getattr(extractor, "kind", None) == "dinov2" and \
            getattr(estimator, "kind", None) == "depth_anything":
        try:
            return FusedDinoDepthEncoder(extractor, estimator)
        except ValueError:
            return None
    return None
