"""Regenerate a checkpoint's `.json` config sidecar from training flags.

Counterpart of fresnel_tpu/train/reconstruct_sidecar.py.  The trainer
writes `<ckpt>` plus a `<ckpt>.json` sidecar (`Trainer.save_checkpoint`),
and every loader (`cli eval`, `--resume`, the viewer) needs the sidecar
to rebuild the model.  Given the flag string the run used (tracked in
`cloud/*.sh`), this rebuilds an equivalent sidecar through the training
CLI's own `build_parser` and `configs_from_args`, so the dataclass
fields cannot drift.  The checkpoint may be a `.pt` or a `.msgpack`; its
weights are not read.

Usage::

    python -m fresnel_tpu_torch.train.reconstruct_sidecar CKPT \
        [--epoch N] -- TRAINING_FLAGS...
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

from fresnel_tpu_torch.train.train_gaussian_decoder import (
    build_parser, configs_from_args)


def reconstruct(ckpt: str, flags: list, epoch: int = 0) -> Path:
    """Write `<ckpt>.json` rebuilt from the given training flag list."""
    args = build_parser().parse_args(flags)
    config, physics, hfgs, hfts = configs_from_args(args)
    meta = {
        "epoch": epoch,
        "config": dataclasses.asdict(config),
        "physics_config": dataclasses.asdict(physics),
        "hfgs_config": dataclasses.asdict(hfgs),
        "hfts_config": dataclasses.asdict(hfts),
    }
    out = Path(str(ckpt) + ".json")
    out.write_text(json.dumps(meta, indent=2))
    return out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print(__doc__)
        return 2
    split = argv.index("--")
    head, flags = argv[:split], argv[split + 1:]
    epoch = 0
    if "--epoch" in head:
        i = head.index("--epoch")
        epoch = int(head[i + 1])
        del head[i:i + 2]
    (ckpt,) = head
    out = reconstruct(ckpt, flags, epoch)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
