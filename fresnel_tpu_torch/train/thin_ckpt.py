"""Thin checkpoints: bf16 params-only Flax msgpack files with a sidecar.

Counterpart of fresnel_tpu/train/thin_ckpt.py's reader,
`load_thin_params`: the params of a thin file (bf16 where floating, read
by `train.flax_msgpack`, which widens bf16 to float32 exactly) carried
into the port's names and cast to the template's dtypes.  The sidecar's
`"thin": true` and `step` are read by `Trainer.load_checkpoint`, which
pairs the params with a fresh optimizer state.  Writing thin files
(`to_thin`) is not ported (ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from fresnel_tpu_torch.train.flax_msgpack import read_flat
from fresnel_tpu_torch.weights import trainer_params


def cast_like(got: Mapping[str, torch.Tensor],
              template: Mapping[str, torch.Tensor], path
              ) -> Dict[str, torch.Tensor]:
    """`got` on the template's devices and dtypes; its names and shapes
    must be the template's."""
    if set(got) != set(template):
        raise ValueError(
            f"checkpoint {path} does not match this trainer: missing "
            f"{sorted(set(template) - set(got))[:5]}, unexpected "
            f"{sorted(set(got) - set(template))[:5]}")
    out = {}
    for k, t in template.items():
        if tuple(got[k].shape) != tuple(t.shape):
            raise ValueError(f"checkpoint {path} does not match this "
                             f"trainer at {k}: {tuple(got[k].shape)} against "
                             f"{tuple(t.shape)}")
        out[k] = got[k].to(device=t.device, dtype=t.dtype)
    return out


def params_of(flat: Mapping[str, np.ndarray], attn_pool: int = 1
              ) -> Dict[str, torch.Tensor]:
    """The "params/..." leaves of a checkpoint's flat dict in the port's
    names (float32)."""
    pre = "params/"
    return trainer_params({k[len(pre):]: v for k, v in flat.items()
                           if k.startswith(pre)}, attn_pool)


def load_thin_params(path, template_params: Mapping[str, torch.Tensor],
                     attn_pool: int = 1) -> Dict[str, torch.Tensor]:
    """Thin params cast back to the template's dtypes and devices."""
    return cast_like(params_of(read_flat(path), attn_pool),
                     template_params, path)
