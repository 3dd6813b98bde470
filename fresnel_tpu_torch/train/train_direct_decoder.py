"""Fresnel v2 distillation trainer: DirectSLatDecoder from TRELLIS outputs.

Counterpart of fresnel_tpu/train/train_direct_decoder.py:
  * the loss: the bidirectional Chamfer `gaussian_matching_loss` (the
    predictions masked by their voxels' `coord_mask`) + `occupancy_weight`
    x the occupancy BCE, and with `use_render_loss` L1 + 0.5 x (1 - SSIM)
    of the predicted and teacher clouds rendered at `render_size` from the
    frontal training camera (M 256; masked Gaussians get opacity 0 and are
    culled).  Both renders go through `render_tiled_batched`: one K1 launch
    for the B predicted clouds (K2 on the backward) and one for the B
    teacher clouds, with no gradient;
  * `clip_by_global_norm(1.0)` + AdamW (`weight_decay`) at a constant rate
    (the JAX module's docstring says cosine; its optimizer is constant);
  * the non-finite guard of the JAX step: on a non-finite loss or gradient
    the gradients are zeroed and the optimizer still steps (the moments
    decay, the count advances), then the parameters are kept;
  * `training_mode` is accepted and, as in the JAX trainer, inert: the
    step always feeds the batch's teacher coords;
  * `fit` draws one batch for `init_state` before the first epoch (one
    shuffle of the numpy generator), and rewrites `best_v2` at every
    `save_interval` as well as at each new best, as the JAX trainer does.

Differences from the JAX trainer: dropout draws from a `torch.Generator`
seeded `seed + 1` (the JAX trainer splits `PRNGKey(seed + 1)`), so runs
with dropout part from JAX's; `use_amp` sets the transformer's compute
dtype to bfloat16 (models/slat.py).  Checkpoints are `.pt` (`best_v2.pt`,
`final_v2.pt`) with the JAX package's `.json` sidecar ({"epoch",
"config"}); `load_checkpoint` also reads the JAX package's `.msgpack`
(train/flax_msgpack.py).

Run:  python -m fresnel_tpu_torch.train.train_direct_decoder --synthetic \\
          --epochs 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.losses.matching import (
    gaussian_matching_loss, occupancy_bce_loss)
from fresnel_tpu_torch.losses.ssim import ssim
from fresnel_tpu_torch.models.slat import DirectSLatDecoder, MLPSLatDecoder
from fresnel_tpu_torch.render.tile import (
    TileRendererConfig, render_tiled_batched)
from fresnel_tpu_torch.train.flax_msgpack import read_flat
from fresnel_tpu_torch.train.optim import AdamWClip
from fresnel_tpu_torch.weights import init_flax_like_, v2_state

RENDER_MAX_PER_TILE = 256


@dataclasses.dataclass
class V2Config:
    data_dir: str = "trellis_data"
    output_dir: str = "checkpoints_v2"
    epochs: int = 50
    batch_size: int = 2
    lr: float = 1e-4
    weight_decay: float = 1e-5
    decoder_type: str = "transformer"      # transformer | mlp
    feature_dim: int = 1024
    hidden_dim: int = 512
    num_layers: int = 6
    num_heads: int = 8
    num_gaussians_per_voxel: int = 8
    max_coords: int = 4096
    max_gaussians: int = 16384
    occupancy_weight: float = 2.0
    use_render_loss: bool = False
    render_size: int = 128
    training_mode: str = "structure_supervised"  # | end_to_end (inert)
    use_checkpoint: bool = False
    use_amp: bool = False                  # bf16 transformer compute
    max_match_points: int = 4096
    save_interval: int = 10
    seed: int = 0


def build_model(cfg: V2Config) -> torch.nn.Module:
    """The decoder of `cfg.decoder_type`, on the CPU (dropout at the
    decoder's default, 0.1, as the JAX trainer builds it)."""
    if cfg.decoder_type == "transformer":
        return DirectSLatDecoder(
            feature_dim=cfg.feature_dim, hidden_dim=cfg.hidden_dim,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            num_gaussians_per_voxel=cfg.num_gaussians_per_voxel,
            use_checkpoint=cfg.use_checkpoint,
            dtype=torch.bfloat16 if cfg.use_amp else None)
    return MLPSLatDecoder(
        feature_dim=cfg.feature_dim, hidden_dim=cfg.hidden_dim,
        num_gaussians_per_voxel=cfg.num_gaussians_per_voxel)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


class V2Trainer:
    """State: {"params" (flat {name: tensor}, Flax names), "opt_state":
    {"count", "mu", "nu"}, "step"}."""

    def __init__(self, cfg: V2Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg).to(self.device)
        self.optimizer = AdamWClip(cfg.lr, 1, cfg.weight_decay,
                                   schedule="constant")
        self.camera = Camera.default_training(cfg.render_size).to(
            self.device)
        self.render_config = TileRendererConfig(
            max_per_tile=RENDER_MAX_PER_TILE)
        self.history: Dict[str, list] = {}

    # ------------------------------------------------------------------
    def init_state(self, batch=None) -> Dict:
        """Flax-like init from a CPU generator seeded `cfg.seed`, moved to
        the device.  `batch` is accepted for the JAX signature."""
        self.model.to("cpu")
        init_flax_like_(self.model, torch.Generator().manual_seed(
            self.cfg.seed))
        self.model.to(self.device)
        params = {k: v.detach().clone()
                  for k, v in self.model.named_parameters()}
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def device_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    def render(self, gaussians: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
        """(B, N, 14) clouds -> (B, 3, S, S) images, masked Gaussians at
        opacity 0: one K1 launch for the batch on the card."""
        g = gaussians
        op = torch.where(mask, g[..., 13], torch.zeros_like(g[..., 13]))
        return render_tiled_batched(
            g[..., 0:3], g[..., 3:6], g[..., 6:10], g[..., 10:13], op,
            self.camera, config=self.render_config)[0]

    def loss(self, params: Dict[str, torch.Tensor],
             batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, loss dict) of one batch of device tensors, dropout on
        (its masks from `generator`)."""
        cfg = self.cfg
        out = functional_call(
            self.model, params, (batch["features"], batch["coords"]),
            dict(coord_mask=batch["coord_mask"], deterministic=False,
                 generator=generator))
        pred_mask = torch.repeat_interleave(
            batch["coord_mask"], cfg.num_gaussians_per_voxel, dim=1)
        ld = gaussian_matching_loss(
            out["gaussians"], batch["gaussians"], pred_mask=pred_mask,
            target_mask=batch["gaussian_mask"],
            max_match_points=cfg.max_match_points)
        total = ld["total"]
        if "occupancy_logits" in out:
            occ_l = occupancy_bce_loss(out["occupancy_logits"],
                                       batch["occupancy"],
                                       mask=batch["coord_mask"])
            ld["occupancy"] = occ_l
            total = total + cfg.occupancy_weight * occ_l
        if cfg.use_render_loss:
            pred_img = self.render(out["gaussians"], pred_mask)
            with torch.no_grad():
                tgt_img = self.render(batch["gaussians"],
                                      batch["gaussian_mask"])
            rgb = torch.mean(torch.abs(pred_img - tgt_img))
            ssim_l = 1.0 - ssim(pred_img, tgt_img)
            ld["render_rgb"] = rgb
            ld["render_ssim"] = ssim_l
            total = total + rgb + 0.5 * ssim_l
        ld["total"] = total
        return total, ld

    def train_step(self, state: Dict, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """One step of the JAX trainer's: a non-finite loss or gradient
        zeroes the gradients, the optimizer steps on them (moments decay,
        the count advances), and the parameters are kept."""
        names = list(state["params"])
        params = {k: v.detach().requires_grad_()
                  for k, v in state["params"].items()}
        with torch.enable_grad():
            total, ld = self.loss(params, batch, generator)
            grads = torch.autograd.grad(total, [params[k] for k in names],
                                        allow_unused=True)
        with torch.no_grad():
            old = state["params"]
            g = [torch.zeros_like(old[k]) if x is None else x
                 for k, x in zip(names, grads)]
            finite = torch.isfinite(total.detach()) & torch.stack(
                [torch.isfinite(x).all() for x in g]).all()
            g = {k: torch.where(finite, x, torch.zeros_like(x))
                 for k, x in zip(names, g)}
            new, opt = self.optimizer.update(old, g, state["opt_state"])
            new = {k: torch.where(finite, new[k], old[k]) for k in names}
        return ({"params": new, "opt_state": opt,
                 "step": state["step"] + 1},
                {k: v.detach() for k, v in ld.items()})

    # ------------------------------------------------------------------
    def fit(self, dataset, epochs: Optional[int] = None,
            state: Optional[Dict] = None, log_fn: Callable = print) -> Dict:
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        nprng = np.random.default_rng(cfg.seed)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        # As the JAX trainer: one batch (one shuffle) for the init.
        first = next(iter(dataset.batches(cfg.batch_size, nprng)))
        if state is None:
            state = self.init_state(first)

        out_dir = Path(cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        best = float("inf")
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses: Dict[str, list] = {}
            for batch in dataset.batches(cfg.batch_size, nprng):
                state, ld = self.train_step(state, self.device_batch(batch),
                                            gen)
                for k, v in ld.items():
                    losses.setdefault(k, []).append(v)
            keys = list(losses)
            vals = torch.stack([torch.stack(losses[k]).mean()
                                for k in keys]).cpu().tolist()
            means = dict(zip(keys, vals))
            for k, v in means.items():
                self.history.setdefault(k, []).append(v)
            log_fn(f"epoch {epoch + 1}/{epochs} "
                   f"total={means['total']:.4f} "
                   f"pos={means.get('position', 0):.4f} "
                   f"cov={means.get('coverage', 0):.4f} "
                   f"occ={means.get('occupancy', 0):.4f} "
                   f"({time.perf_counter() - t0:.1f}s)")
            if (epoch + 1) % cfg.save_interval == 0 or means["total"] < best:
                best = min(best, means["total"])
                self.save_checkpoint(out_dir / "best_v2.pt", state, epoch)
        self.save_checkpoint(out_dir / "final_v2.pt", state, epochs - 1)
        (out_dir / "loss_history.json").write_text(json.dumps(self.history))
        return state

    def save_checkpoint(self, path, state: Dict, epoch: int) -> None:
        torch.save(_to(state, "cpu"), str(path))
        Path(str(path) + ".json").write_text(json.dumps(
            {"epoch": epoch, "config": dataclasses.asdict(self.cfg)}))

    def load_checkpoint(self, path, batch=None) -> Tuple[Dict, int]:
        """(state, epoch) from a `.pt` of `save_checkpoint` or the JAX
        package's `.msgpack` (params, Adam's moments and count, step); the
        epoch from the `.json` sidecar (-1 without one).  Names and shapes
        must be this trainer's model's."""
        if str(path).endswith(".msgpack"):
            state = v2_state(read_flat(path))
        else:
            state = torch.load(str(path), map_location="cpu",
                               weights_only=True)
        want = {k: tuple(v.shape) for k, v in self.model.named_parameters()}
        for group, tree in (("params", state["params"]),
                            ("mu", state["opt_state"]["mu"]),
                            ("nu", state["opt_state"]["nu"])):
            got = {k: tuple(v.shape) for k, v in tree.items()}
            if want != got:
                bad = sorted(set(want.items()) ^ set(got.items()))[:6]
                raise ValueError(f"{path}: {group} do not fit this model "
                                 f"({bad} ...)")
        meta_path = Path(str(path) + ".json")
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        return _to(state, self.device), meta.get("epoch", -1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fresnel v2 distillation")
    p.add_argument("--data_dir", default="trellis_data")
    p.add_argument("--output_dir", default="checkpoints_v2")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--decoder_type", choices=["transformer", "mlp"],
                   default="transformer")
    p.add_argument("--feature_dim", type=int, default=1024)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--num_layers", type=int, default=6)
    p.add_argument("--num_gaussians_per_voxel", type=int, default=8)
    p.add_argument("--max_coords", type=int, default=4096)
    p.add_argument("--max_gaussians", type=int, default=16384)
    p.add_argument("--occupancy_weight", type=float, default=2.0)
    p.add_argument("--use_render_loss", action="store_true")
    p.add_argument("--training_mode", default="structure_supervised",
                   choices=["structure_supervised", "end_to_end"])
    p.add_argument("--use_checkpoint", action="store_true")
    p.add_argument("--use_amp", action="store_true",
                   help="bf16 transformer compute (float32 parameters)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_samples", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None) -> Tuple[V2Trainer, Dict]:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = V2Config(
        data_dir=args.data_dir, output_dir=args.output_dir,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        decoder_type=args.decoder_type, feature_dim=args.feature_dim,
        hidden_dim=args.hidden_dim, num_layers=args.num_layers,
        num_gaussians_per_voxel=args.num_gaussians_per_voxel,
        max_coords=args.max_coords, max_gaussians=args.max_gaussians,
        occupancy_weight=args.occupancy_weight,
        use_render_loss=args.use_render_loss,
        training_mode=args.training_mode,
        use_checkpoint=args.use_checkpoint, use_amp=args.use_amp,
        seed=args.seed)

    from fresnel_tpu_torch.data.trellis import (
        SyntheticTrellisDataset, TrellisDistillationDataset)
    if args.synthetic:
        cfg.max_coords, cfg.max_gaussians = 512, 1024
        dataset = SyntheticTrellisDataset(
            n_samples=args.synthetic_samples, seed=args.seed,
            feature_dim=cfg.feature_dim)
    else:
        dataset = TrellisDistillationDataset(
            cfg.data_dir, max_coords=cfg.max_coords,
            max_gaussians=cfg.max_gaussians)
    print(f"dataset: {len(dataset)} samples")

    trainer = V2Trainer(cfg, device=dev)
    state = trainer.fit(dataset)
    print("v2 training complete")
    return trainer, state


if __name__ == "__main__":
    main()
