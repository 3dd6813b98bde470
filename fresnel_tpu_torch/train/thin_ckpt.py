"""Thin checkpoints: bf16 params-only exports with a sidecar.

Counterpart of fresnel_tpu/train/thin_ckpt.py.  A full training
checkpoint (params and Adam's two moments, all float32) is ~6x the bf16
params; a thin export keeps only the parameters, cast to bfloat16 where
floating (round to nearest even, as `ml_dtypes` casts), and copies the
sidecar with `"thin": true` and the training `step` added, so
`Trainer.load_checkpoint` can resume from it: the params cast back to the
template's dtypes, a fresh optimizer state, the schedule's epoch from the
sidecar.

`to_thin` reads a port checkpoint (`.pt`, `Trainer.save_checkpoint`) or
a JAX package's Flax msgpack (full or thin, through `train.flax_msgpack`,
its names carried into the port's) and writes a `.pt` holding
{"params": {name: tensor}}.  Writing Flax files is not planned.
`load_thin_params` reads either kind of thin file.

CLI:  python -m fresnel_tpu_torch.train.thin_ckpt SRC DST.pt
"""

from __future__ import annotations

import json
import sys
import zipfile
from pathlib import Path
from typing import Dict, Mapping, Tuple

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


def _sidecar(path) -> dict:
    meta_path = Path(str(path) + ".json")
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}


def read_params(path, attn_pool: int = 1) -> Tuple[Dict[str, torch.Tensor],
                                                    int]:
    """(params in the port's names, step) of a port `.pt` or a Flax
    msgpack checkpoint, full or thin, on the CPU.  `torch.save` writes a
    zip archive; anything else is read as msgpack."""
    if zipfile.is_zipfile(path):
        payload = torch.load(str(path), map_location="cpu",
                             weights_only=True)
        return payload["params"], int(payload.get("step", 0))
    flat = read_flat(path)
    return params_of(flat, attn_pool), int(np.asarray(flat.get("step", 0)))


def _cast_leaf(x: torch.Tensor) -> torch.Tensor:
    # float32 -> bfloat16 rounds to nearest even (float64 goes through
    # float32 first: the JAX package's checkpoints hold no float64 leaf).
    if x.dtype in (torch.float32, torch.float64):
        return x.to(torch.float32).to(torch.bfloat16)
    return x


def to_thin(src, dst) -> dict:
    """Write a bf16 params-only copy of a checkpoint and its sidecar.

    Returns the thin sidecar dict: the source's (an empty one when it has
    none, as in the JAX tool) with `thin` and `step` added."""
    src, dst = Path(src), Path(dst)
    if dst.suffix == ".msgpack":
        raise ValueError(f"{dst}: the port writes thin checkpoints as .pt "
                         "files (torch.save), not Flax msgpack")
    meta = _sidecar(src)
    attn_pool = meta.get("config", {}).get("encoder_attn_pool", 1)
    params, step = read_params(src, attn_pool)
    torch.save({"params": {k: _cast_leaf(v) for k, v in params.items()}},
               str(dst))
    meta["thin"] = True
    meta["step"] = step
    Path(str(dst) + ".json").write_text(json.dumps(meta, indent=2))
    return meta


def load_thin_params(path, template_params: Mapping[str, torch.Tensor],
                     attn_pool: int = 1) -> Dict[str, torch.Tensor]:
    """Thin params (a port `.pt` or a Flax msgpack) cast back to the
    template's dtypes and devices."""
    return cast_like(read_params(path, attn_pool)[0], template_params, path)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m fresnel_tpu_torch.train.thin_ckpt SRC DST")
        return 1
    meta = to_thin(argv[0], argv[1])
    src_mb = Path(argv[0]).stat().st_size / 1e6
    dst_mb = Path(argv[1]).stat().st_size / 1e6
    print(f"{argv[0]} ({src_mb:.1f} MB) -> {argv[1]} ({dst_mb:.1f} MB) "
          f"epoch={meta.get('epoch')} step={meta.get('step')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
