"""Weight carry-over from the JAX package, and Flax-like random init.

The converters take the JAX package's params as a flat {path: np.ndarray}
dict, with "/" between path parts (as `flax.traverse_util.flatten_dict(
params["params"], sep="/")` gives them), and return the port's state dicts.
They import nothing of the JAX package: the layouts are rules on arrays.
  * Dense `kernel` (in, out)            -> Linear.weight (out, in)
  * Conv `kernel` (kh, kw, in, out)     -> Conv2d.weight (out, in, kh, kw)
  * PatchUpsample `kernel` (k, k, C, O) -> ConvTranspose2d layout (C, O, k, k)
  * LayerNorm / GroupNorm `scale`       -> weight
  * attention DenseGeneral kernels (C, heads, head_dim) and (heads,
    head_dim, C), biases (heads, head_dim) -> Linear(C, C)
  * biases, LayerScale `gamma`, cls / pos tokens and the decoder's scalar
    `depth_offset` carry over as they are.
`trainer_params` carries a whole JAX `Trainer`'s params (decoder, image
encoder, `wavelengths_raw`, `boundary_emphasis`) into the port's
`train.harness.Trainer` params, and `trainer_opt_state` its optax state
(`clip_by_global_norm` then `adamw` with a schedule) into the port's
`train.optim.AdamWClip` state.  `cvs_params` carries a
ConsistencyViewSynthesizer's (or the CVS trainer's perceptual stack's)
params, whose port modules carry the Flax names, and `cvs_state` a whole
JAX `CVSTrainer` checkpoint (params, EMA params, the perceptual stack,
`clip_by_global_norm` + constant-rate `adamw` moments and count, step).
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from fresnel_tpu_torch.models.blocks import (
    Conv2d, LayerNorm, Linear, ZeroInitLinear)
from fresnel_tpu_torch.models.cvs import (
    FresnelWaveAttention, ImageFeatureAdapter, PluckerPoseEncoder)
from fresnel_tpu_torch.models.decoders import (
    DirectPatchDecoder, PhysicsDirectPatchDecoder, ZeroInitConv2d)
from fresnel_tpu_torch.models.fibonacci import FibonacciPatchDecoder
from fresnel_tpu_torch.models.image_encoder import GroupNorm, ImageEncoder
from fresnel_tpu_torch.models.vit import (
    DINOv2,
    LayerScale,
    PatchUpsample,
)

_UPSAMPLE = re.compile(r"reassemble_[01]_resize/kernel$")


def _convert(flat: Mapping[str, np.ndarray], renames=()) -> Dict[str, torch.Tensor]:
    out = {}
    for path, val in flat.items():
        arr = np.array(val, dtype=np.float32)   # a writable copy
        parts = path.split("/")
        leaf = parts[-1]
        if leaf == "kernel":
            if _UPSAMPLE.search(path):
                arr = arr.transpose(2, 3, 0, 1)       # (k,k,C,O) -> (C,O,k,k)
            elif arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank at {path}")
            parts[-1] = "weight"
        elif leaf == "scale":
            parts[-1] = "weight"
        key = ".".join(parts)
        for pattern, repl in renames:
            key = re.sub(pattern, repl, key)
        out[key] = torch.from_numpy(np.array(arr, order="C"))   # keeps 0-d
    return out


_BLOCKS = (r"(^|\.)block_(\d+)\.", r"\1blocks.\2.")


def diffractive_state_dict(flat: Mapping[str, np.ndarray]
                           ) -> Dict[str, torch.Tensor]:
    """Flat params of a DiffractiveLayer (`amplitude_raw`, `phase`) or a
    MultiscaleDiffractiveLayer (`scale_s/amplitude_raw`, `scale_s/phase`)
    -> state dict of physics.diffraction's module of the same name (the
    (C, H, W) arrays as they are)."""
    return _convert(flat)


def lpips_state_dict(flat: Mapping[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
    """Flat LPIPS params (`trunk/conv{i}/kernel` (kH, kW, I, O),
    `trunk/conv{i}/bias`, `lin{i}`) -> state dict of losses.lpips.LPIPS
    (`trunk.conv{i}.weight` (O, I, kH, kW), `trunk.conv{i}.bias`,
    `lin{i}`)."""
    return _convert(flat)


def depth_net_state_dict(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Flat params of train_depth's TinyDepthNet (`Conv_i/kernel`,
    `Conv_i/bias`, Flax's creation order) -> state dict of the port's
    `train.train_depth.TinyDepthNet` (`convs.i.weight`, `convs.i.bias`)."""
    return _convert(flat, renames=((r"^Conv_(\d+)\.", r"convs.\1."),))


def dinov2_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat DINOv2 params -> state dict of models.vit.DINOv2."""
    return _convert(flat, renames=(_BLOCKS,))


def depth_anything_state_dict(flat: Mapping[str, np.ndarray]
                              ) -> Dict[str, torch.Tensor]:
    """Flat DepthAnything params -> state dict of models.vit.DepthAnything."""
    return _convert(flat, renames=(_BLOCKS,))


_OPTION_RENAMES = (
    (r"^FresnelEdgeDetector_0\.Conv_(\d)\.", r"edge_detector.conv\1."),
    (r"^DepthEncoder_0\.Conv_(\d)\.", r"depth_encoder.conv\1."),
    (r"^PoseEncoder_0\.Dense_(\d)\.", r"pose_encoder.dense\1."),
)
# The pose-modulated opacity head, `nn.Dense(1)(relu(nn.Dense(128)(emb)))`:
# Flax names modules in the order they are built, and the outer Dense(1)
# is built first, so `Dense_0` is the output layer and `Dense_1` the
# hidden one.
_OPACITY_HEAD = ((r"^Dense_0\.", "opacity_out."),
                 (r"^Dense_1\.", "opacity_hidden."))


def decoder_state_dict(flat: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """Flat params of a decoder -> state dict of the port's module of the
    same name: DirectPatchDecoder (with feature_upsample, its
    `upsample_conv` and `upsample_refine` kernels HWIO -> OIHW; its
    options' `FresnelEdgeDetector_0`, `DepthEncoder_0` and `PoseEncoder_0`
    -> `edge_detector`, `depth_encoder`, `pose_encoder`, and with a pose
    encoder the opacity head's `Dense_0` / `Dense_1` -> `opacity_out` /
    `opacity_hidden`), PhysicsDirectPatchDecoder (`MLP_0`, the scalars
    `depth_offset` and `wavelength_raw` as they are),
    FibonacciPatchDecoder (the same pose names),
    SAAGRefinementNet and FeatureGuidedSAAG (`MLP_0` -> `mlp`, `Dense_i`
    and the scalars as they are) and NCAGaussianDecoder (a Flax
    Sequential's `layers_i` -> torch's `i`)."""
    pose = any(k.startswith("PoseEncoder_0/") for k in flat)
    return _convert(flat, renames=(
        (r"^MLP_0\.Dense_(\d+)\.", r"mlp.layers.\1."),
        (r"\.layers_(\d+)\.", r".\1."), *_OPTION_RENAMES,
        *(_OPACITY_HEAD if pose else ())))


_ENCODER_RENAMES = (
    (r"^Conv_(\d)\.", lambda m: f"conv{int(m.group(1)) + 1}."),
    (r"^_ResBlock_(\d)\.", r"res.\1."),
    (r"^_AttnBlock_(\d)\.", r"blocks.\1."),
    (r"^Dense_0\.", "proj."),
    (r"(^|\.)GroupNorm_(\d)\.", lambda m: f"{m.group(1)}norm{int(m.group(2)) + 1}."),
    (r"(res\.\d\.)Conv_(\d)\.", lambda m: f"{m.group(1)}conv{int(m.group(2)) + 1}."),
    (r"(blocks\.\d\.)LayerNorm_(\d)\.", lambda m: f"{m.group(1)}norm{int(m.group(2)) + 1}."),
    (r"(blocks\.\d\.)MultiHeadDotProductAttention_0\.(query|key|value|out)\.",
     lambda m: f"{m.group(1)}attn.{dict(query='q', key='k', value='v', out='out')[m.group(2)]}."),
    (r"(blocks\.\d\.)Dense_(\d)\.", lambda m: f"{m.group(1)}fc{int(m.group(2)) + 1}."),
)


def image_encoder_state_dict(flat: Mapping[str, np.ndarray],
                             attn_pool: int = 1) -> Dict[str, torch.Tensor]:
    """Flat ImageEncoder params -> state dict of
    models.image_encoder.ImageEncoder."""
    flat2 = {}
    for path, val in flat.items():
        arr = np.asarray(val, dtype=np.float32)
        if "MultiHeadDotProductAttention" in path:
            leaf = path.split("/")[-1]
            if path.split("/")[-2] == "out":
                if leaf == "kernel":                      # (h, d, C)
                    arr = arr.reshape(-1, arr.shape[-1])
            elif leaf == "kernel":                        # (C, h, d)
                arr = arr.reshape(arr.shape[0], -1)
            else:                                         # bias (h, d)
                arr = arr.reshape(-1)
        flat2[path] = arr
    # The top-level LayerNorms: the final one, and with attn_pool > 1 the
    # pooled tokens' one before it.
    tops = ["norm"] if attn_pool == 1 else ["pool_norm", "norm"]
    renames = _ENCODER_RENAMES + tuple(
        (rf"^LayerNorm_{i}\.", f"{name}.") for i, name in enumerate(tops))
    out = {}
    for key, t in _convert(flat2).items():
        for pattern, repl in renames:
            key = re.sub(pattern, repl, key)
        out[key] = t
    return out


def trainer_params(flat: Mapping[str, np.ndarray], attn_pool: int = 1
                   ) -> Dict[str, torch.Tensor]:
    """A JAX Trainer's params, flattened with "/" ("model/params/...",
    "encoder/params/...", "wavelengths_raw", "boundary_emphasis") ->
    the port Trainer's {name: tensor} ("model.<key>", "encoder.<key>",
    "wavelengths_raw", "boundary_emphasis")."""
    groups: Dict[str, Dict[str, np.ndarray]] = {"model": {}, "encoder": {}}
    out: Dict[str, torch.Tensor] = {}
    for path, val in flat.items():
        head, _, rest = path.partition("/")
        if head in groups:
            groups[head][rest.split("/", 1)[1]] = val       # drop "params/"
        else:
            out[path] = torch.from_numpy(np.array(val, dtype=np.float32))
    for k, v in decoder_state_dict(groups["model"]).items():
        out[f"model.{k}"] = v
    if groups["encoder"]:
        for k, v in image_encoder_state_dict(groups["encoder"],
                                             attn_pool).items():
            out[f"encoder.{k}"] = v
    return out


def trainer_opt_state(flat: Mapping[str, np.ndarray], attn_pool: int = 1
                      ) -> Dict:
    """A JAX Trainer's optax state, flattened with "/" as in its checkpoint
    ("0" the clip's empty state; "1/0" Adam's count, mu and nu; "1/1" the
    weight decay's empty state; "1/2" the schedule's count) -> the port's
    AdamWClip state {"count", "mu", "nu"}, the moments renamed and
    reshaped as `trainer_params` renames the params.  optax keeps two
    counts, Adam's and the schedule's; the port keeps one, so they must be
    equal."""
    adam = "1/0/"
    counts = {k: int(np.asarray(flat[k])) for k in (adam + "count",
                                                     "1/2/count")
              if k in flat}
    if adam + "count" not in counts:
        raise ValueError("no Adam count at opt_state/1/0/count")
    if len(set(counts.values())) != 1:
        raise ValueError(f"optax's counts differ: {counts}; the port's "
                         "optimizer keeps one count")
    moments = {}
    for m in ("mu", "nu"):
        pre = f"{adam}{m}/"
        moments[m] = trainer_params(
            {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)},
            attn_pool)
    return {"count": torch.tensor(counts[adam + "count"], dtype=torch.int32),
            **moments}


def _mha_reshape(path: str, arr: np.ndarray) -> np.ndarray:
    """A Flax MultiHeadDotProductAttention leaf in Dense layout: query /
    key / value kernels (C, heads, head_dim) -> (C, heads * head_dim), the
    out kernel (heads, head_dim, C) -> (heads * head_dim, C), biases
    (heads, head_dim) -> (heads * head_dim,)."""
    if "MultiHeadDotProductAttention" not in path:
        return arr
    leaf = path.split("/")[-1]
    if path.split("/")[-2] == "out":
        return arr.reshape(-1, arr.shape[-1]) if leaf == "kernel" else arr
    if leaf == "kernel":
        return arr.reshape(arr.shape[0], -1)
    return arr.reshape(-1)


def cvs_params(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat params of the JAX ConsistencyViewSynthesizer ("unet/Conv_0/
    kernel", ...; a leading "params/" is dropped), or of the CVS trainer's
    perceptual stack -> the state dict of the port's module of the same
    name (models.cvs, train.train_cvs.PerceptualNet): the paths with ".",
    the kernels and the attention's DenseGeneral leaves in torch layout."""
    flat2 = {}
    for path, val in flat.items():
        path = path[len("params/"):] if path.startswith("params/") else path
        flat2[path] = _mha_reshape(path, np.asarray(val, dtype=np.float32))
    return _convert(flat2)


CVS_GROUPS = ("params", "ema_params", "perc_params")


def cvs_state(flat: Mapping[str, np.ndarray]) -> Dict:
    """A JAX CVSTrainer checkpoint flat with "/" (`train.flax_msgpack.
    read_flat`: "params/params/unet/...", "ema_params/params/...",
    "perc_params/params/...", "opt_state/1/0/{count,mu,nu}/params/...",
    "step") -> the port's CVS state {"params", "ema_params",
    "perc_params", "opt_state": {"count", "mu", "nu"}, "step"}.  optax's
    chain is (clip: empty, (Adam's count, mu, nu; the weight decay: empty;
    the constant rate: empty)): one count."""
    out: Dict = {}
    for g in CVS_GROUPS:
        pre = f"{g}/"
        out[g] = cvs_params({k[len(pre):]: v for k, v in flat.items()
                             if k.startswith(pre)})
    adam = "opt_state/1/0/"
    if adam + "count" not in flat:
        raise ValueError(f"no Adam count at {adam}count")
    counts = [k for k in flat if k.startswith("opt_state/")
              and k.endswith("/count")]
    if counts != [adam + "count"]:
        raise ValueError(f"optax counts {counts}: the port's CVS optimizer "
                         "keeps Adam's alone")
    out["opt_state"] = {"count": torch.tensor(
        int(np.asarray(flat[adam + "count"])), dtype=torch.int32)}
    for m in ("mu", "nu"):
        pre = f"{adam}{m}/"
        out["opt_state"][m] = cvs_params(
            {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)})
    out["step"] = torch.tensor(int(np.asarray(flat["step"])),
                               dtype=torch.int32)
    return out


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # Flax's lecun_normal: variance 1 / fan_in, normal truncated at 2 sigma
    # (the 0.8796 factor restores the variance the truncation removes).
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


@torch.no_grad()
def init_flax_like_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `model` in place as the Flax modules initialise: Dense
    and Conv kernels lecun-normal, biases zero, LayerNorm and GroupNorm
    scale one, LayerScale 1e-5, cls / pos tokens and PatchUpsample kernels
    normal(0.02), the decoders' `depth_offset` -2, the physics decoder's
    `wavelength_raw` its wavelength, and the zero-initialised
    `upsample_refine` conv and output Dense layers (FeatureGuidedSAAG's,
    the NCA's update) 0; in CVS the adapter's `pos_embed` and
    `compress_queries` and the pose encoder's `pose_queries` normal(0.02),
    each `wavelength` 0.1.  Draws from `generator`, so it is
    reproducible."""
    for m in model.modules():
        if isinstance(m, (ZeroInitConv2d, ZeroInitLinear)):
            m.weight.zero_()
            m.bias.zero_()
        elif isinstance(m, (Linear, Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ImageEncoder):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, LayerScale):
            m.gamma.fill_(1e-5)
        elif isinstance(m, PatchUpsample):
            m.weight.normal_(0.0, 0.02, generator=generator)
            m.bias.zero_()
        elif isinstance(m, DINOv2):
            m.cls_token.normal_(0.0, 0.02, generator=generator)
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, (DirectPatchDecoder, FibonacciPatchDecoder)):
            m.depth_offset.fill_(-2.0)
        elif isinstance(m, PhysicsDirectPatchDecoder):
            m.depth_offset.fill_(-2.0)
            if m.learnable_wavelength:
                m.wavelength_raw.fill_(m.wavelength)
        elif isinstance(m, ImageFeatureAdapter):
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
            m.compress_queries.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, PluckerPoseEncoder):
            m.pose_queries.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, FresnelWaveAttention):
            m.wavelength.fill_(0.1)
    return model
