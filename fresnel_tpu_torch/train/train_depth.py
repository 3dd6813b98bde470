"""Tiny monocular-depth model training (the reference's depth side quest).

Counterpart of fresnel_tpu/train/train_depth.py.  The reference collected
NYUv2 / folder / synthetic depth datasets (scripts/utils/depth_dataset.py)
to train a small depth model as a Depth-Anything replacement.  This is
that training loop on the card: a small encoder-decoder conv net on
(image, depth) pairs with the scale-invariant L1 + gradient-matching
losses, trained by Adam as optax's `adam` (eps 1e-8, no decay).  Writes
`depth_model.pt` (the module's state dict), `config.json` and
`loss_history.json`.  Flax params of the JAX net carry over through
`weights.depth_net_state_dict`.  `--dataset nyuv2` needs a network and
raises (data/depth_dataset.py).

Run:  python -m fresnel_tpu_torch.train.train_depth --synthetic --epochs 10
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from fresnel_tpu_torch.core.ops import resize_linear
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.losses.physics import normalized_depth_l1
from fresnel_tpu_torch.models.image_encoder import SameConv2d


@dataclasses.dataclass
class DepthTrainConfig:
    data_dir: str = "depth_data"
    output_dir: str = "checkpoints_depth"
    epochs: int = 50
    batch_size: int = 8
    lr: float = 3e-4
    image_size: int = 128
    base_channels: int = 32
    save_interval: int = 10
    seed: int = 0


class TinyDepthNet(nn.Module):
    """U-ish encoder-decoder: (B, 3, H, W) image -> (B, H, W) relative
    depth in [0, 1].  `convs[i]` is Flax's `Conv_i` (creation order): three
    encoder stages of two 3x3 convs and a stride-2 conv ("SAME": padding
    (0, 1) at even sizes), a middle conv, three decoder convs after a 2x
    nearest upsample and a skip concat, and the output conv; H and W
    multiples of 8."""

    def __init__(self, base: int = 32):
        super().__init__()
        self.base = base
        convs, cin, ch, skips = [], 3, base, []
        for _ in range(3):
            convs += [SameConv2d(cin, ch, 3), SameConv2d(ch, ch, 3),
                      SameConv2d(ch, ch, 3, stride=2)]
            skips.append(ch)
            cin, ch = ch, ch * 2
        convs.append(SameConv2d(cin, ch, 3))
        cin = ch
        for _ in range(3):
            ch //= 2
            convs.append(SameConv2d(cin + skips.pop(), ch, 3))
            cin = ch
        convs.append(SameConv2d(cin, 1, 3))
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = iter(self.convs)
        skips = []
        for _ in range(3):
            x = torch.relu(next(c)(x))
            x = torch.relu(next(c)(x))
            skips.append(x)
            x = next(c)(x)
        x = torch.relu(next(c)(x))
        for _ in range(3):
            # jax.image.resize "nearest" at exactly 2x repeats each pixel.
            x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            x = torch.relu(next(c)(torch.cat([x, skips.pop()], dim=1)))
        x = next(c)(x)[:, 0]
        # amin / amax split a tie's gradient evenly, as jnp.min / max do.
        lo = torch.amin(x, dim=(1, 2), keepdim=True)
        hi = torch.amax(x, dim=(1, 2), keepdim=True)
        return (x - lo) / torch.clamp(hi - lo, min=1e-6)


def build_depth_net(base: int = 32, seed: int = 0) -> TinyDepthNet:
    """A TinyDepthNet initialised as Flax initialises one (lecun-normal
    kernels, zero biases) from a CPU generator seeded with `seed`, so the
    card and the CPU start from the same bits."""
    from fresnel_tpu_torch.weights import init_flax_like_

    return init_flax_like_(TinyDepthNet(base),
                           torch.Generator().manual_seed(seed))


def depth_losses(pred: torch.Tensor, target: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scale-invariant L1 + gradient matching."""
    si = normalized_depth_l1(pred, target)
    gx_p = pred[:, :, 1:] - pred[:, :, :-1]
    gy_p = pred[:, 1:, :] - pred[:, :-1, :]
    gx_t = target[:, :, 1:] - target[:, :, :-1]
    gy_t = target[:, 1:, :] - target[:, :-1, :]
    grad = (gx_p - gx_t).abs().mean() + (gy_p - gy_t).abs().mean()
    return si + 0.5 * grad, {"si": si, "grad": grad}


def make_optimizer(model: nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    no weight decay."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               image: torch.Tensor, target: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One Adam step on a (B, 3, H, W) image and (B, h, w) depth batch;
    the depth is resized to the prediction's size with the antialiased
    linear resize when the sizes differ.  Returns the step's losses,
    detached, on the device."""
    optimizer.zero_grad(set_to_none=True)
    pred = model(image)
    if target.shape[-1] != pred.shape[-1]:
        target = resize_linear(target, pred.shape[-2], pred.shape[-1])
    loss, parts = depth_losses(pred, target)
    loss.backward()
    optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in parts.items()}


def build_dataset(args, cfg: DepthTrainConfig):
    from fresnel_tpu_torch.data import depth_dataset as dd

    if args.synthetic or args.dataset == "synthetic":
        return dd.SyntheticDepthDataset(n_samples=64,
                                        image_size=cfg.image_size,
                                        seed=cfg.seed)
    if args.dataset == "nyuv2":
        return dd.NYUDepthV2Dataset(image_size=cfg.image_size,
                                    max_samples=args.max_samples)
    return dd.FolderDepthDataset(cfg.data_dir, image_size=cfg.image_size)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a tiny depth model")
    p.add_argument("--data_dir", default="depth_data")
    p.add_argument("--output_dir", default="checkpoints_depth")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--base_channels", type=int, default=32)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--dataset", default="folder",
                   choices=["folder", "nyuv2", "synthetic"],
                   help="'nyuv2' streams NYU Depth V2 from HuggingFace "
                        "(needs a network: not ported, raises)")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = DepthTrainConfig(
        data_dir=args.data_dir, output_dir=args.output_dir,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        image_size=args.image_size, base_channels=args.base_channels,
        seed=args.seed)
    dev = resolve_device(args.device)
    dataset = build_dataset(args, cfg)
    print(f"dataset: {len(dataset)} pairs")

    nprng = np.random.default_rng(cfg.seed)
    # The JAX trainer draws one batch for its init: draw it too, so the
    # epochs see the same shuffles.
    next(iter(dataset.batches(cfg.batch_size, nprng)))
    model = build_depth_net(cfg.base_channels, cfg.seed).to(dev)
    optimizer = make_optimizer(model, cfg.lr)

    out = Path(cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    history: Dict[str, list] = {"total": []}
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses = []
        for batch in dataset.batches(cfg.batch_size, nprng):
            loss, _ = train_step(
                model, optimizer,
                torch.as_tensor(batch["image"], device=dev),
                torch.as_tensor(batch["depth"], device=dev))
            losses.append(loss)
        mean = float(torch.stack(losses).mean())
        history["total"].append(mean)
        print(f"epoch {epoch + 1}/{cfg.epochs} loss={mean:.4f} "
              f"({time.perf_counter() - t0:.1f}s)")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               str(out / "depth_model.pt"))
    (out / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    (out / "loss_history.json").write_text(json.dumps(history))
    print("depth training complete")
    return model, history


if __name__ == "__main__":
    main()
