"""Weight carry-over from the JAX package, and Flax-like random init.

The converters take the JAX package's params as a flat {path: np.ndarray}
dict, with "/" between path parts (as `flax.traverse_util.flatten_dict(
params["params"], sep="/")` gives them), and return the port's state dicts.
They import nothing of the JAX package: the layouts are rules on arrays.
  * Dense `kernel` (in, out)            -> Linear.weight (out, in)
  * Conv `kernel` (kh, kw, in, out)     -> Conv2d.weight (out, in, kh, kw)
  * PatchUpsample `kernel` (k, k, C, O) -> ConvTranspose2d layout (C, O, k, k)
  * LayerNorm `scale`                   -> weight
  * biases, LayerScale `gamma`, cls / pos tokens and the decoder's scalar
    `depth_offset` carry over as they are.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from fresnel_tpu_torch.models.blocks import Conv2d, LayerNorm, Linear
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
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
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


_BLOCKS = (r"(^|\.)block_(\d+)\.", r"\1blocks.\2.")


def dinov2_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat DINOv2 params -> state dict of models.vit.DINOv2."""
    return _convert(flat, renames=(_BLOCKS,))


def depth_anything_state_dict(flat: Mapping[str, np.ndarray]
                              ) -> Dict[str, torch.Tensor]:
    """Flat DepthAnything params -> state dict of models.vit.DepthAnything."""
    return _convert(flat, renames=(_BLOCKS,))


def decoder_state_dict(flat: Mapping[str, np.ndarray]
                       ) -> Dict[str, torch.Tensor]:
    """Flat DirectPatchDecoder params -> state dict of
    models.decoders.DirectPatchDecoder."""
    return _convert(flat, renames=((r"^MLP_0\.Dense_(\d+)\.", r"mlp.layers.\1."),))


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    # Flax's lecun_normal: variance 1 / fan_in, normal truncated at 2 sigma
    # (the 0.8796 factor restores the variance the truncation removes).
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)


@torch.no_grad()
def init_flax_like_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise `model` in place as the Flax modules initialise: Dense
    and Conv kernels lecun-normal, biases zero, LayerNorm scale one,
    LayerScale 1e-5, cls / pos tokens and PatchUpsample kernels normal(0.02),
    `depth_offset` -2.  Draws from `generator`, so it is reproducible."""
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LayerScale):
            m.gamma.fill_(1e-5)
        elif isinstance(m, PatchUpsample):
            m.weight.normal_(0.0, 0.02, generator=generator)
            m.bias.zero_()
        elif isinstance(m, DINOv2):
            m.cls_token.normal_(0.0, 0.02, generator=generator)
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, DirectPatchDecoder):
            m.depth_offset.fill_(-2.0)
    return model
