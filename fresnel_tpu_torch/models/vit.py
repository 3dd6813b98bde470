"""DINOv2 ViT and Depth-Anything-V2 (DPT neck + head).

Counterpart of fresnel_tpu/models/vit.py.  Public layouts match the JAX
package: images (B, H, W, 3) in [0, 1], features (B, g, g, width), depth
(B, out, out).  Inside, convolutions run NCHW.

`dtype` is the compute dtype: parameters stay float32 and are cast at each
layer, the softmax runs in float32, and the outputs are float32, as in the
Flax modules.  LayerNorms use epsilon 1e-6 and GELU is the exact erf form.
Submodules carry the Flax modules' names, so converted weights map one to
one (see fresnel_tpu_torch/weights.py).
"""

from __future__ import annotations

import math
import pickle
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fresnel_tpu_torch.models.blocks import Conv2d, LayerNorm, Linear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

VIT_CONFIGS = {
    "small": dict(width=384, depth=12, heads=6),
    "base": dict(width=768, depth=12, heads=12),
    "large": dict(width=1024, depth=24, heads=16),
}

DA_OUT_INDICES = (3, 6, 9, 12)
DA_NECK_CHANNELS = (48, 96, 192, 384)
DA_FUSION = 64
DA_HEAD_HIDDEN = 32


# ----------------------------------------------------------------------
# Resize helpers
# ----------------------------------------------------------------------

def _linear_ac_taps(in_size: int, out_size: int):
    """align_corners=True bilinear taps: (idx0, idx1, weight1) numpy arrays."""
    if out_size == 1:
        return (np.zeros(1, np.int64), np.zeros(1, np.int64),
                np.zeros(1, np.float32))
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


def _resize_ac_axis(x: torch.Tensor, out: int, axis: int) -> torch.Tensor:
    i0, i1, w1 = _linear_ac_taps(x.shape[axis], out)
    shape = [1] * x.dim()
    shape[axis] = out
    w1 = torch.from_numpy(w1).to(device=x.device, dtype=x.dtype).reshape(shape)
    i0 = torch.from_numpy(i0).to(x.device)
    i1 = torch.from_numpy(i1).to(x.device)
    return (x.index_select(axis, i0) * (1.0 - w1)
            + x.index_select(axis, i1) * w1)


def _resize_ac(x: torch.Tensor, out_h: int, out_w: int,
               h_axis: int) -> torch.Tensor:
    if x.shape[h_axis] != out_h:
        x = _resize_ac_axis(x, out_h, h_axis)
    if x.shape[h_axis + 1] != out_w:
        x = _resize_ac_axis(x, out_w, h_axis + 1)
    return x


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int
                       ) -> torch.Tensor:
    """(B, H, W, C) bilinear resize with align_corners=True, by the same
    two-tap gathers (rows, then columns) as the JAX package."""
    return _resize_ac(x, out_h, out_w, h_axis=1)


def _cubic_weights(t: np.ndarray, A: float = -0.75) -> np.ndarray:
    """Cubic-convolution weights of the 4 taps at fractional offset t
    (torch upsample_bicubic2d, A = -0.75)."""
    def w1(x):
        return ((A + 2) * x - (A + 3)) * x * x + 1

    def w2(x):
        return ((A * x - 5 * A) * x + 8 * A) * x - 4 * A
    return np.stack([w2(t + 1.0), w1(t), w1(1.0 - t), w2(2.0 - t)], -1)


def _torch_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of torch bicubic interpolation with
    align_corners=False and border-clamped taps."""
    M = np.zeros((out_size, in_size), np.float64)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src)
    w = _cubic_weights(src - base)
    for tap in range(4):
        idx = np.clip(base + tap - 1, 0, in_size - 1).astype(np.int64)
        np.add.at(M, (np.arange(out_size), idx), w[:, tap])
    return M


def interpolate_pos_embed(pos: np.ndarray, new_grid: int) -> np.ndarray:
    """(1, old_grid^2 + 1, D) -> (1, new_grid^2 + 1, D), CLS passed through,
    by torch-exact bicubic interpolation of the patch grid."""
    pos = np.asarray(pos, np.float32)
    n = pos.shape[1] - 1
    old_grid = int(round(math.sqrt(n)))
    if old_grid * old_grid != n:
        raise ValueError(f"pos_embed token count {n} is not a square grid")
    if old_grid == new_grid:
        return pos
    cls, patch = pos[:, :1], pos[:, 1:]
    D = pos.shape[-1]
    grid = patch.reshape(old_grid, old_grid, D).astype(np.float64)
    M = _torch_bicubic_matrix(old_grid, new_grid)
    grid = np.einsum("oi,ijd->ojd", M, grid)
    grid = np.einsum("oj,ijd->iod", M, grid)
    out = np.concatenate(
        [cls, grid.reshape(1, new_grid * new_grid, D).astype(np.float32)], 1)
    return out.astype(np.float32)


# ----------------------------------------------------------------------
# DINOv2 backbone
# ----------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(width, 3 * width)
        self.proj = Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        hd = D // self.heads
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, hd)
        q = qkv[:, :, 0].transpose(1, 2)                      # (B, h, N, hd)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        logits = (q @ k.transpose(-1, -2)) * hd ** -0.5
        # Softmax in float32 whatever the compute dtype.
        attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, D)
        return self.proj(out)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ls1 = LayerScale(width)
        self.norm2 = LayerNorm(width)
        self.mlp_fc1 = Linear(width, 4 * width)
        self.mlp_fc2 = Linear(4 * width, width)
        self.ls2 = LayerScale(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        h = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.ls2(self.mlp_fc2(h))


class DINOv2(nn.Module):
    """DINOv2 ViT backbone.

    forward(images) returns the (B, g, g, width) final-norm patch-token
    grid in float32.  With `out_indices` it returns the tapped token
    sequences (B, N + 1, width) after the 1-based layers named, each passed
    through the final LayerNorm with CLS kept."""

    def __init__(self, width: int = 384, depth: int = 12, heads: int = 6,
                 patch_size: int = 14, image_size: int = 518,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.depth, self.heads = width, depth, heads
        self.patch_size, self.image_size = patch_size, image_size
        self.dtype = dtype
        g = image_size // patch_size
        self.patch_embed = Conv2d(3, width, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, width))
        self.blocks = nn.ModuleList(Block(width, heads) for _ in range(depth))
        self.norm = LayerNorm(width)
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD),
                             persistent=False)

    def forward(self, images: torch.Tensor,
                out_indices: Optional[Tuple[int, ...]] = None):
        B = images.shape[0]
        g = self.image_size // self.patch_size
        x = ((images - self.mean) / self.std).to(self.dtype)
        x = self.patch_embed(x.permute(0, 3, 1, 2))           # (B, W, g, g)
        x = x.flatten(2).transpose(1, 2)                      # (B, g*g, W)
        cls = self.cls_token.to(self.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)

        if out_indices is not None and \
                tuple(out_indices) != tuple(sorted(set(out_indices))):
            raise ValueError("out_indices must be strictly ascending")
        want = set(out_indices or ())
        taps: List[torch.Tensor] = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if (i + 1) in want:
                taps.append(self.norm(x))
        if out_indices is not None:
            return taps
        x = self.norm(x)
        return x[:, 1:].reshape(B, g, g, self.width).float()


# ----------------------------------------------------------------------
# Depth-Anything DPT neck + head (NCHW inside)
# ----------------------------------------------------------------------

class PatchUpsample(nn.Module):
    """Transpose convolution with kernel == stride == factor: a learned
    non-overlapping upsample.  `weight` has torch's ConvTranspose2d layout
    (in, out, k, k)."""

    def __init__(self, in_channels: int, channels: int, factor: int):
        super().__init__()
        self.factor = factor
        self.weight = nn.Parameter(
            torch.zeros(in_channels, channels, factor, factor))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), stride=self.factor)


class PreActResidual(nn.Module):
    """x + conv(relu(conv(relu(x))))."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.conv2 = Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusion(nn.Module):
    """Optional residual merge, residual unit, align_corners=True bilinear
    upsample, 1x1 projection."""

    def __init__(self, features: int, has_residual: bool):
        super().__init__()
        if has_residual:
            self.res1 = PreActResidual(features)
        self.res2 = PreActResidual(features)
        self.proj = Conv2d(features, features, 1)

    def forward(self, x, residual=None, out_size=None):
        if residual is not None:
            x = x + self.res1(residual)
        x = self.res2(x)
        if out_size is None:
            out_size = (x.shape[2] * 2, x.shape[3] * 2)
        x = _resize_ac(x, out_size[0], out_size[1], h_axis=2)
        return self.proj(x)


class DPTNeckHead(nn.Module):
    """Reassembles the 4 tapped token sequences at strides x4 / x2 / x1 /
    x0.5 of the patch grid, fuses them coarsest to finest, and regresses
    ReLU relative depth at patch_size * grid resolution."""

    def __init__(self, in_width: int,
                 neck_channels: Sequence[int] = DA_NECK_CHANNELS,
                 fusion: int = DA_FUSION, head_hidden: int = DA_HEAD_HIDDEN,
                 patch_size: int = 14):
        super().__init__()
        self.n_levels = len(neck_channels)
        self.patch_size = patch_size
        for i, ch in enumerate(neck_channels):
            self.add_module(f"reassemble_{i}_proj", Conv2d(in_width, ch, 1))
            if i == 0:
                self.add_module(f"reassemble_{i}_resize",
                                PatchUpsample(ch, ch, 4))
            elif i == 1:
                self.add_module(f"reassemble_{i}_resize",
                                PatchUpsample(ch, ch, 2))
            elif i == 3:
                self.add_module(f"reassemble_{i}_resize",
                                Conv2d(ch, ch, 3, stride=2, padding=1))
            self.add_module(f"neck_conv_{i}",
                            Conv2d(ch, fusion, 3, padding=1, bias=False))
        for i in range(self.n_levels):
            self.add_module(f"fusion_{i}", FeatureFusion(fusion, i > 0))
        self.head_conv1 = Conv2d(fusion, fusion // 2, 3, padding=1)
        self.head_conv2 = Conv2d(fusion // 2, head_hidden, 3, padding=1)
        self.head_conv3 = Conv2d(head_hidden, 1, 1)

    def forward(self, taps: Sequence[torch.Tensor], grid: int) -> torch.Tensor:
        if len(taps) != self.n_levels:
            raise ValueError(f"expected {self.n_levels} taps, got {len(taps)}")
        feats = []
        for i, tokens in enumerate(taps):
            B, _, C = tokens.shape
            h = tokens[:, 1:].reshape(B, grid, grid, C).permute(0, 3, 1, 2)
            h = getattr(self, f"reassemble_{i}_proj")(h)
            if i != 2:
                h = getattr(self, f"reassemble_{i}_resize")(h)
            feats.append(getattr(self, f"neck_conv_{i}")(h))

        rev = feats[::-1]
        fused = None
        for i, f in enumerate(rev):
            size = tuple(rev[i + 1].shape[2:]) if i + 1 < len(rev) else None
            layer = getattr(self, f"fusion_{i}")
            fused = layer(f, None, size) if fused is None \
                else layer(fused, f, size)

        x = self.head_conv1(fused)
        out = grid * self.patch_size
        x = _resize_ac(x, out, out, h_axis=2)
        x = F.relu(self.head_conv2(x))
        x = self.head_conv3(x)
        return F.relu(x[:, 0]).float()


class DepthAnything(nn.Module):
    """DINOv2 backbone + DPT neck/head -> relative depth.

    forward(images) min-max normalises the raw head output to [0, 1] and
    resizes it to `out_size` with an antialiased bilinear resize, which is
    what jax.image.resize(..., "linear") does when it downsamples.
    `raw=True` returns the unnormalised (B, 518, 518) head output."""

    def __init__(self, width: int = 384, depth: int = 12, heads: int = 6,
                 out_size: int = 256, image_size: int = 518,
                 patch_size: int = 14,
                 out_indices: Tuple[int, ...] = DA_OUT_INDICES,
                 neck_channels: Tuple[int, ...] = DA_NECK_CHANNELS,
                 fusion: int = DA_FUSION, head_hidden: int = DA_HEAD_HIDDEN,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_size = out_size
        self.grid = image_size // patch_size
        self.out_indices = tuple(out_indices)
        self.backbone = DINOv2(width, depth, heads, patch_size, image_size,
                               dtype=dtype)
        self.dpt = DPTNeckHead(width, neck_channels, fusion, head_hidden,
                               patch_size)

    def forward(self, images: torch.Tensor, raw: bool = False) -> torch.Tensor:
        taps = self.backbone(images, out_indices=self.out_indices)
        depth = self.dpt(taps, self.grid)
        return depth if raw else self.normalize(depth)

    def normalize(self, depth: torch.Tensor) -> torch.Tensor:
        """The raw head output min-max normalised per image, resized to
        `out_size`."""
        lo = depth.amin(dim=(1, 2), keepdim=True)
        hi = depth.amax(dim=(1, 2), keepdim=True)
        rel = (depth - lo) / torch.clamp(hi - lo, min=1e-6)
        if self.out_size != rel.shape[1]:
            rel = F.interpolate(rel[:, None], size=(self.out_size,) * 2,
                                mode="bilinear", align_corners=False,
                                antialias=True)[:, 0]
        return rel


# ----------------------------------------------------------------------
# Torch checkpoints -> the JAX package's flat layout -> the port's modules
# ----------------------------------------------------------------------

def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU copy as numpy; bfloat16 (which numpy lacks) widened to
    float32, exactly."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch .pth / .pt / .bin file (a state dict, a module, or a dict
    holding one under "state_dict", "model" or "model_state") or a
    .safetensors file -> {name: np.ndarray}.  An unreadable file raises
    ValueError naming it."""
    if path.endswith(".safetensors"):
        from fresnel_tpu_torch.train.safetensors_file import read_safetensors
        return {k: _to_numpy(v) for k, v in read_safetensors(path).items()}
    try:
        # weights_only=False as the JAX loader reads these files: torch
        # newer than 2.6 would default to True and refuse a pickled module.
        sd = torch.load(path, map_location="cpu", weights_only=False)
    except (EOFError, RuntimeError, pickle.UnpicklingError) as e:
        raise ValueError(f"cannot read the weights file {path}: {e}") from e
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if isinstance(sd, dict):
        for key in ("state_dict", "model", "model_state"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds no state dict ({type(sd).__name__})")
    return {k: _to_numpy(v) for k, v in sd.items() if hasattr(v, "detach")}


def strip_prefix(sd: Dict[str, np.ndarray],
                 prefixes=("module.", "dinov2.", "model.")
                 ) -> Dict[str, np.ndarray]:
    """Drop each of `prefixes` in turn, only when every key has it."""
    for pre in prefixes:
        if sd and all(k.startswith(pre) for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items()}
    return sd


# Per block: (Flax path, HF key, facebook key, transpose).
_BLOCK_KEYS = (
    ("norm1/scale", "norm1.weight", "norm1.weight", False),
    ("norm1/bias", "norm1.bias", "norm1.bias", False),
    ("attn/proj/kernel", "attention.output.dense.weight", "attn.proj.weight",
     True),
    ("attn/proj/bias", "attention.output.dense.bias", "attn.proj.bias",
     False),
    ("ls1/gamma", "layer_scale1.lambda1", "ls1.gamma", False),
    ("norm2/scale", "norm2.weight", "norm2.weight", False),
    ("norm2/bias", "norm2.bias", "norm2.bias", False),
    ("mlp_fc1/kernel", "mlp.fc1.weight", "mlp.fc1.weight", True),
    ("mlp_fc1/bias", "mlp.fc1.bias", "mlp.fc1.bias", False),
    ("mlp_fc2/kernel", "mlp.fc2.weight", "mlp.fc2.weight", True),
    ("mlp_fc2/bias", "mlp.fc2.bias", "mlp.fc2.bias", False),
    ("ls2/gamma", "layer_scale2.lambda1", "ls2.gamma", False),
)


# Keys of a checkpoint that inference does not read: DINOv2's mask token
# (masked-image pretraining only), and Depth-Anything's fusion level 0
# `residual_layer1`, dead in the torch module (the first fusion has no
# residual input).
_UNUSED = re.compile(r"(^|\.)mask_token$|"
                     r"^neck\.fusion_stage\.layers\.0\.residual_layer1\.")


def _check_consumed(path: str, sd: Dict[str, np.ndarray], used: set) -> None:
    """Raise ValueError for a key of the file that no parameter takes
    (another architecture's, or a typo), so nothing is silently
    dropped."""
    extra = sorted(k for k in set(sd) - used if not _UNUSED.search(k))
    if extra:
        raise ValueError(f"{path}: {len(extra)} keys no parameter takes: "
                         f"{extra[:8]}{'...' if len(extra) > 8 else ''}")


def convert_dinov2_sd(sd: Dict[str, np.ndarray], depth: int,
                      target_grid: int, prefix: str = "",
                      used: Optional[set] = None) -> Dict[str, np.ndarray]:
    """A DINOv2 state dict in HF-transformers naming (`embeddings.*`,
    `encoder.layer.*`, q / k / v apart) or facebook-research naming
    (`blocks.*`, fused `qkv`) -> the JAX package's flat {flax_path:
    array}, `pos_embed` resized to `target_grid`.  A missing key raises
    ValueError; the keys read are added to `used`."""
    hf = any("embeddings.patch_embeddings" in k for k in sd)
    out: Dict[str, np.ndarray] = {}
    used = set() if used is None else used

    def get(key):
        if key not in sd:
            raise ValueError(f"not a DINOv2 state dict of depth {depth}: "
                             f"no {key!r}")
        used.add(key)
        return sd[key]

    def put(name, val):
        out[prefix + name] = np.asarray(val)

    if hf:
        put("patch_embed/kernel",
            get("embeddings.patch_embeddings.projection.weight")
            .transpose(2, 3, 1, 0))
        put("patch_embed/bias", get("embeddings.patch_embeddings.projection.bias"))
        put("cls_token", get("embeddings.cls_token"))
        pos = get("embeddings.position_embeddings")
    else:
        put("patch_embed/kernel",
            get("patch_embed.proj.weight").transpose(2, 3, 1, 0))
        put("patch_embed/bias", get("patch_embed.proj.bias"))
        put("cls_token", get("cls_token"))
        pos = get("pos_embed")
    for i in range(depth):
        p = f"encoder.layer.{i}." if hf else f"blocks.{i}."
        f = f"block_{i}/"
        if hf:
            a = p + "attention.attention."
            put(f + "attn/qkv/kernel", np.concatenate(
                [get(a + "query.weight").T, get(a + "key.weight").T,
                 get(a + "value.weight").T], axis=1))
            put(f + "attn/qkv/bias", np.concatenate(
                [get(a + "query.bias"), get(a + "key.bias"),
                 get(a + "value.bias")]))
        else:
            put(f + "attn/qkv/kernel", get(p + "attn.qkv.weight").T)
            put(f + "attn/qkv/bias", get(p + "attn.qkv.bias"))
        for name, hf_key, fb_key, transpose in _BLOCK_KEYS:
            val = get(p + (hf_key if hf else fb_key))
            put(f + name, val.T if transpose else val)
    put("norm/scale", get("layernorm.weight" if hf else "norm.weight"))
    put("norm/bias", get("layernorm.bias" if hf else "norm.bias"))
    put("pos_embed", interpolate_pos_embed(pos, target_grid))
    return out


def convert_dinov2_torch(path: str, size: str = "small",
                         image_size: int = 518, patch_size: int = 14
                         ) -> Dict[str, np.ndarray]:
    """A DINOv2 checkpoint file in either naming -> flat {flax_path:
    array}, its pos_embed grid (the 224^2-trained 16^2) bicubically
    resized to image_size / patch_size (37^2 at 518^2)."""
    sd = strip_prefix(load_torch_state_dict(path))
    used: set = set()
    out = convert_dinov2_sd(sd, VIT_CONFIGS[size]["depth"],
                            image_size // patch_size, used=used)
    _check_consumed(path, sd, used)
    return out


def convert_depth_anything_torch(path: str, size: str = "small",
                                 image_size: int = 518,
                                 patch_size: int = 14, num_levels: int = 4
                                 ) -> Dict[str, np.ndarray]:
    """An HF `DepthAnythingForDepthEstimation` checkpoint file (backbone,
    DPT neck and head) -> flat {flax_path: array}.  A file with no
    `neck.*` key (a bare backbone) raises ValueError: a half-random model
    never loads.  Fusion level 0's `residual_layer1` is dead in the torch
    module (the first fusion has no residual input) and is dropped; any
    other key no parameter takes raises ValueError."""
    sd = strip_prefix(load_torch_state_dict(path))
    if not any(k.startswith("neck.") for k in sd):
        raise ValueError(
            f"{path} has no DPT neck ('neck.*' keys): a plain DINOv2 "
            "backbone, not a Depth-Anything model; refusing a partial load")
    back = {k[len("backbone."):]: v for k, v in sd.items()
            if k.startswith("backbone.")}
    used_back: set = set()
    out = convert_dinov2_sd(back, VIT_CONFIGS[size]["depth"],
                            image_size // patch_size, prefix="backbone/",
                            used=used_back)
    used = {"backbone." + k for k in used_back}

    def get(key):
        if key not in sd:
            raise ValueError(f"not a Depth-Anything state dict: no {key!r}")
        used.add(key)
        return sd[key]

    def conv(name, key, bias=True):
        out[name + "/kernel"] = get(key + ".weight").transpose(2, 3, 1, 0)
        if bias:
            out[name + "/bias"] = get(key + ".bias")

    for i in range(num_levels):
        conv(f"dpt/reassemble_{i}_proj",
             f"neck.reassemble_stage.layers.{i}.projection")
        rk = f"neck.reassemble_stage.layers.{i}.resize"
        if f"{rk}.weight" in sd:
            w = get(rk + ".weight")
            # Levels 0 and 1 are ConvTranspose2d: (in, out, kH, kW).
            out[f"dpt/reassemble_{i}_resize/kernel"] = (
                w.transpose(2, 3, 0, 1) if i in (0, 1)
                else w.transpose(2, 3, 1, 0))
            out[f"dpt/reassemble_{i}_resize/bias"] = get(rk + ".bias")
        out[f"dpt/neck_conv_{i}/kernel"] = \
            get(f"neck.convs.{i}.weight").transpose(2, 3, 1, 0)
        fp = f"neck.fusion_stage.layers.{i}."
        conv(f"dpt/fusion_{i}/proj", fp + "projection")
        if i > 0:
            conv(f"dpt/fusion_{i}/res1/conv1",
                 fp + "residual_layer1.convolution1")
            conv(f"dpt/fusion_{i}/res1/conv2",
                 fp + "residual_layer1.convolution2")
        conv(f"dpt/fusion_{i}/res2/conv1", fp + "residual_layer2.convolution1")
        conv(f"dpt/fusion_{i}/res2/conv2", fp + "residual_layer2.convolution2")
    for j in (1, 2, 3):
        conv(f"dpt/head_conv{j}", f"head.conv{j}")
    _check_consumed(path, sd, used)
    return out


def load_state_dict_strict(module: nn.Module,
                           state: Dict[str, torch.Tensor]) -> int:
    """Load `state` into `module` with every parameter filled and nothing
    left over; on any unexpected key, missing parameter or shape mismatch,
    raise ValueError listing them (up to 8 of each).  Returns the number
    of tensors loaded."""
    own = module.state_dict()
    unexpected = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    bad = sorted(k for k in set(state) & set(own)
                 if tuple(state[k].shape) != tuple(own[k].shape))
    if unexpected or missing or bad:
        def few(keys):
            return f"{keys[:8]}{'...' if len(keys) > 8 else ''}"
        raise ValueError(
            "strict weight load failed:\n"
            f"  checkpoint keys with no parameter ({len(unexpected)}): "
            f"{few(unexpected)}\n"
            f"  parameters not in checkpoint ({len(missing)}): "
            f"{few(missing)}\n"
            f"  shape mismatches ({len(bad)}): "
            + str([(k, tuple(state[k].shape), tuple(own[k].shape))
                   for k in bad[:8]]))
    module.load_state_dict(state, strict=True)
    return len(state)


def _loaded(model: nn.Module, state: Dict[str, torch.Tensor],
            device) -> nn.Module:
    load_state_dict_strict(model, state)
    return model.to(device).eval().requires_grad_(False)


def load_dinov2(size: str = "small", weights_path: Optional[str] = None,
                image_size: int = 518, dtype: torch.dtype = torch.float32,
                device=None) -> Optional[DINOv2]:
    """The DINOv2 of `size` with the file's weights, in eval mode on
    `device` (CUDA when None), or None when there is no file."""
    import os

    from fresnel_tpu_torch.device import resolve_device
    from fresnel_tpu_torch.weights import dinov2_state_dict

    if weights_path is None or not os.path.exists(weights_path):
        return None
    dev = resolve_device(device)
    model = DINOv2(image_size=image_size, dtype=dtype, **VIT_CONFIGS[size])
    flat = convert_dinov2_torch(weights_path, size, image_size)
    return _loaded(model, dinov2_state_dict(flat), dev)


def checkpoint_out_indices(weights_path: str) -> Optional[Tuple[int, ...]]:
    """`backbone_config.out_indices` of a config.json beside the weights
    (HF checkpoints ship one; V2-Small's is [3, 6, 9, 12], which differs
    from the bare DepthAnythingConfig default), or None when there is no
    such file or it does not parse."""
    import json
    import os

    cfg_path = os.path.join(os.path.dirname(weights_path) or ".",
                            "config.json")
    if not os.path.exists(cfg_path):
        return None
    try:
        with open(cfg_path) as f:
            cfg = json.load(f)
        idx = cfg.get("backbone_config", {}).get("out_indices")
        return tuple(int(i) for i in idx) if idx else None
    except (ValueError, OSError, AttributeError):
        return None


def load_depth_anything(size: str = "small",
                        weights_path: Optional[str] = None,
                        out_size: int = 256,
                        dtype: torch.dtype = torch.float32,
                        device=None) -> Optional[DepthAnything]:
    """The whole Depth-Anything (backbone, neck, head) with the file's
    weights, tapping the out_indices of a config.json beside it (else
    DA_OUT_INDICES), in eval mode on `device` (CUDA when None); None when
    there is no file.  A backbone-only or partial file raises."""
    import os

    from fresnel_tpu_torch.device import resolve_device
    from fresnel_tpu_torch.weights import depth_anything_state_dict

    if weights_path is None or not os.path.exists(weights_path):
        return None
    dev = resolve_device(device)
    out_indices = checkpoint_out_indices(weights_path) or DA_OUT_INDICES
    model = DepthAnything(out_size=out_size, out_indices=out_indices,
                          dtype=dtype, **VIT_CONFIGS[size])
    flat = convert_depth_anything_torch(weights_path, size)
    return _loaded(model, depth_anything_state_dict(flat), dev)


# ----------------------------------------------------------------------
# Fused dual-trunk inference
# ----------------------------------------------------------------------
#
# DINOv2 and Depth-Anything's backbone are the same ViT-S/14 on the same
# 518^2 image.  Stacking the two weight sets on a leading axis and running
# one vmapped trunk forward turns each of the trunk's products into one
# batched product over both weight sets: the same work in about half the
# launches.  DINOv2's features (final-norm patch tokens) are the tap at
# layer `depth`, so one tapped forward serves both.

def stack_trunk_params(dino: DINOv2, depth_model: DepthAnything
                       ) -> Dict[str, torch.Tensor]:
    """{name: (2, ...) tensor}: DINOv2's parameters at index 0, the
    Depth-Anything backbone's at 1.  The two trunks must have the same
    parameter names and shapes (ValueError otherwise)."""
    a = dict(dino.named_parameters())
    b = dict(depth_model.backbone.named_parameters())
    if a.keys() != b.keys() or any(a[k].shape != b[k].shape for k in a):
        raise ValueError("the two trunks' parameters differ in names or "
                         "shapes")
    params, _ = torch.func.stack_module_state([dino, depth_model.backbone])
    return {k: v.detach() for k, v in params.items()}


def fused_features_and_depth(depth_model: DepthAnything,
                             stacked: Dict[str, torch.Tensor],
                             images: torch.Tensor, raw: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One vmapped trunk forward over both weight sets -> (DINOv2 features
    (B, g, g, width) float32, Depth-Anything depth (B, out, out) in [0, 1];
    the unnormalised (B, 518, 518) head output with `raw`), the outputs of
    DINOv2.forward and DepthAnything.forward run apart.  `images` (B, S,
    S, 3) in [0, 1] at the trunk's image size; `stacked` from
    stack_trunk_params.  It taps the union of the out_indices and the last
    layer."""
    from torch.func import functional_call

    m = depth_model
    trunk = m.backbone
    g = trunk.image_size // trunk.patch_size
    fused_idx = tuple(sorted(set(m.out_indices) | {trunk.depth}))
    taps = torch.vmap(lambda p: tuple(functional_call(
        trunk, p, (images,), {"out_indices": fused_idx})))(stacked)
    B = images.shape[0]
    feat_tokens = taps[fused_idx.index(trunk.depth)][0]
    feats = feat_tokens[:, 1:].reshape(B, g, g, trunk.width).float()
    depth = m.dpt([taps[fused_idx.index(i)][1] for i in m.out_indices], g)
    if raw:
        return feats, depth
    return feats, m.normalize(depth)
