"""Binary-protocol bridge commands: the file and stdout contracts through
which the reference's C++ viewer calls this framework.

Counterpart of fresnel_tpu/inference/bridges.py, with the same arguments,
files and printed lines:

  dinov2:  IMAGE OUT.bin [small|base|large]
           writes raw float32 (37, 37, C) HWC features, prints "H W C"
  depth:   IMAGE OUT.bin [W] [H]
           writes a raw float32 W x W depth map (H is read by nobody, as
           in the JAX module)
  decoder: FEATURES.bin DEPTH.bin OUT.bin [checkpoint]
           reads (37, 37, C) features and a square depth map, writes
           N x 14 float32 Gaussians [pos3, scale3, quat_wxyz4, rgb3,
           opacity1], prints N
  test_novel_views: IMAGE OUT_DIR [checkpoint|-] [num_views] [size]
           decodes the image and renders `num_views` orbit views at
           `size`^2 (`render_views`: K1 on the card), prints one
           "az=... mean=... coverage=..." line per view and PASS or DARK,
           writes novel_view_az{deg:03d}.png; exits 1 on DARK

A checkpoint is the model its `.json` sidecar rebuilds (Flax msgpack or
the port's `.pt`, `train.harness.trainer_from_checkpoint`), decoded in
inference mode (`Trainer.decode`); an encoder-trained checkpoint's
`test_novel_views` features come from its own encoder.  Without one the
decoder is a DirectPatchDecoder (K 4) initialised from
`torch.Generator().manual_seed(0)`, as `cli infer` does (JAX's PRNGKey(0)
draws cannot be reproduced without JAX).  An experiment-1 or -3
checkpoint raises `Trainer.decode`'s ValueError, where the JAX module
fails with a TypeError (ROADMAP Queue 3, reference fault 1).

Each `cmd_*` takes `device=` (None means the card; the command line
always runs on the card).

Invoke: python -m fresnel_tpu_torch.inference.bridges
            {dinov2|depth|decoder|test_novel_views} ...
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from fresnel_tpu_torch.device import resolve_device

DIMS = {"small": 384, "base": 768, "large": 1024}


def _load_any_image(path: str, size: int, device) -> torch.Tensor:
    """(size, size, 3) float32 in [0, 1] on `device`, PIL-bilinear
    resized."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return torch.from_numpy(np.asarray(img, np.float32) / 255.0).to(device)


def _decode(ckpt, feats, depth, dev, image=None):
    """The Gaussian fields (batched) of a checkpoint's model, or of the
    seed-0 DirectPatchDecoder without one; with `image` (H, W, 3) an
    encoder-trained checkpoint decodes its own encoder's features of the
    image resized to its training size."""
    from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
    from fresnel_tpu_torch.models.encoders import resize_linear
    from fresnel_tpu_torch.train.harness import trainer_from_checkpoint
    from fresnel_tpu_torch.weights import init_flax_like_

    if ckpt and Path(ckpt).exists():
        trainer = trainer_from_checkpoint(ckpt, device=dev)
        state, _ = trainer.load_checkpoint(ckpt)
        if image is not None and trainer.config.train_encoder:
            S = trainer.config.image_size
            img_chw = resize_linear(image.permute(2, 0, 1), S, S)[None]
            feats = trainer.encode(state["params"], img_chw)
        return trainer.decode(state["params"], feats, depth)
    model = DirectPatchDecoder(feature_dim=feats.shape[-1],
                               gaussians_per_patch=4)
    init_flax_like_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        return model.to(dev)(feats, depth)


def cmd_dinov2(argv, device=None) -> int:
    if len(argv) < 2:
        print("usage: dinov2 IMAGE OUT.bin [small|base|large]",
              file=sys.stderr)
        return 1
    dim = DIMS[argv[2] if len(argv) > 2 else "small"]
    from fresnel_tpu_torch.models.encoders import create_feature_extractor

    dev = resolve_device(device)
    img = _load_any_image(argv[0], 518, dev)
    with torch.no_grad():
        feats = create_feature_extractor(dim=dim, device=dev)(img)
    feats = feats.float().cpu().numpy()
    feats.tofile(argv[1])
    h, w, c = feats.shape
    print(f"{h} {w} {c}")
    return 0


def cmd_depth(argv, device=None) -> int:
    if len(argv) < 2:
        print("usage: depth IMAGE OUT.bin [W] [H]", file=sys.stderr)
        return 1
    out_size = int(argv[2]) if len(argv) > 2 else 256
    from fresnel_tpu_torch.models.encoders import gradient_depth_estimate

    dev = resolve_device(device)
    img = _load_any_image(argv[0], 518, dev)
    depth = gradient_depth_estimate(img, out_size)
    depth.cpu().numpy().astype(np.float32).tofile(argv[1])
    return 0


def cmd_decoder(argv, device=None) -> int:
    if len(argv) < 3:
        print("usage: decoder FEATURES.bin DEPTH.bin OUT.bin [checkpoint]",
              file=sys.stderr)
        return 1
    dev = resolve_device(device)
    feats = np.fromfile(argv[0], np.float32)
    dim = feats.size // (37 * 37)
    feats = torch.from_numpy(feats.reshape(1, 37, 37, dim)).to(dev)
    d = np.fromfile(argv[1], np.float32)
    side = int(round(d.size ** 0.5))
    depth = torch.from_numpy(d.reshape(1, side, side)).to(dev)

    out = _decode(argv[3] if len(argv) > 3 else None, feats, depth, dev)
    n = out["positions"].shape[1]
    flat = torch.cat([out["positions"][0], out["scales"][0],
                      out["rotations"][0], out["colors"][0],
                      out["opacities"][0][:, None]], -1)
    flat.float().cpu().numpy().tofile(argv[2])
    print(n)
    return 0


def cmd_test_novel_views(argv, device=None) -> int:
    """Validation mode: image -> decode -> orbit renders, saved as PNGs: a
    checkpoint's check that its novel views are not dark."""
    if len(argv) < 2:
        print("usage: test_novel_views IMAGE OUT_DIR [checkpoint] "
              "[num_views] [size]", file=sys.stderr)
        return 1
    from PIL import Image

    from fresnel_tpu_torch.evaluation.novel_view_eval import render_views
    from fresnel_tpu_torch.models.encoders import (create_feature_extractor,
                                                   gradient_depth_estimate)

    dev = resolve_device(device)
    out_dir = Path(argv[1])
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = argv[2] if len(argv) > 2 and argv[2] != "-" else None
    num_views = int(argv[3]) if len(argv) > 3 else 8
    size = int(argv[4]) if len(argv) > 4 else 256

    img = _load_any_image(argv[0], 518, dev)
    with torch.no_grad():
        feats = create_feature_extractor(dim=384, device=dev)(img)[None]
        depth = gradient_depth_estimate(img, 256)[None]
        out = _decode(ckpt, feats, depth, dev, image=img)
        gaussians = {k: out[k][0] for k in ("positions", "scales",
                                            "rotations", "colors",
                                            "opacities")}
        azimuths = tuple(np.linspace(0.0, 360.0, num_views, endpoint=False))
        views = render_views(gaussians, render_size=size,
                             azimuths_deg=azimuths).cpu().numpy()

    dark = 0
    for az, v in zip(azimuths, views):
        mean = float(v.mean())
        coverage = float((v.max(axis=0) > 0.02).mean())
        print(f"az={az:.0f} mean={mean:.4f} coverage={coverage:.3f}")
        if mean < 0.01:
            dark += 1
        Image.fromarray(
            (np.clip(v.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        ).save(out_dir / f"novel_view_az{int(az):03d}.png")
    print("DARK" if dark else "PASS")
    return 1 if dark else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: bridges {dinov2|depth|decoder|test_novel_views} ...",
              file=sys.stderr)
        return 1
    return {"dinov2": cmd_dinov2, "depth": cmd_depth,
            "decoder": cmd_decoder,
            "test_novel_views": cmd_test_novel_views}[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
