"""Decoder training harness: the train step, HFTS scheduling, checkpoints.

Counterpart of fresnel_tpu/train/harness.py::Trainer.  One step: the
image encoder (`train_encoder`) or the cached features -> the decoder
(dropout on) -> optional stochastic-K subsample -> one batched render of
the B clouds (one (B * T, M, 12) pack: one K1 launch forward and one K2
launch backward on the card) -> `compute_losses` -> overflow telemetry ->
with `view_weight` > 0 and GT orbit views in the batch (corpus_v2), the
same B clouds rendered from one non-frontal GT azimuth each (a second
pack, one more K1 and K2 launch) and scored L1 + ssim_weight * (1 - SSIM)
-> optional tensegrity term -> with `distill_weight` > 0, the raw-head
distillation term against the batch's teacher sidecars
(`train/fit_teacher.py`) -> clip + AdamW + cosine schedule, with the NaN
guard on the device (train/optim.py).  `fit` runs HFTS progressive K,
reads the losses from the device once per epoch, and writes periodic,
best and final checkpoints and `loss_history.json`.

Parameters live in the state as a flat {name: tensor} dict ("model.<key>",
"encoder.<key>", "wavelengths_raw", "boundary_emphasis"); the modules are
templates run with `torch.func.functional_call`.  A checkpoint is
`torch.save` of {params, opt_state, step} (`.pt`) with the JAX package's
JSON sidecar keys beside it.  `load_checkpoint` also reads thin files
(bf16 params, `train.thin_ckpt`: a port `.pt` or a Flax msgpack; a fresh
optimizer state) and the JAX package's full Flax msgpack checkpoints
(params, Adam moments, count and step), through `train.flax_msgpack`,
which needs neither msgpack nor ml_dtypes.

Experiments 1 (SAAGRefinementNet on a SAAG prior), 2
(DirectPatchDecoder, or PhysicsDirectPatchDecoder under wave rendering
without phase output), 3 (FeatureGuidedSAAG: the patch-mean modulations
scale the SAAG prior), 4 (FibonacciPatchDecoder) and 5
(NCAGaussianDecoder, its update masks drawn from the step's generator or
handed in); the decoders' options (Fresnel zones, edge-aware, phase
output, pose encoding with the frontal pose when none is drawn, depth
fusion).  The renderer is the JAX package's choice
(`render.factory.select_training_renderer`): tiled (K1 / K2, or K1-phi /
K2-phi when phase blending gets the decoder's phases), wave field or
Fourier (K5 / K6); only the tiled renderer bins, so only it logs overflow
telemetry.  The SAAG prior of experiments 1 and 3 is the base block of
`geometry.to_surface_gaussians` over the batch's depth subsampled by 8,
one batched call.  With `use_amp` the encoder and the decoder run in
bf16 inside the loss (`utils.precision.amp_apply`: bf16 copies of their
float32 parameters and positional inputs, float32 outputs), as the JAX
package's loss_fn runs them; the SAAG prior, the render, the losses,
`encode` and `decode` stay float32.  With an LPIPS module
(`Trainer(lpips=losses.lpips.load_lpips(...))`) and `lpips_weight` > 0
the step adds the LPIPS term of the 128^2 render and target; the module
moves to the trainer's device, stays float32 under `use_amp`, and is
neither a parameter nor a checkpoint leaf.

`fit(..., mesh=parallel.get_mesh())` trains data-parallel, one process per
device: every rank draws the whole host batch, its colour jitter, view
indices and poses from identically seeded generators and keeps its rows
(`parallel.shard_batch`); the step runs under `parallel.data_parallel_step`,
where the decoders' dropout masks and experiment 5's update masks are
drawn at the global shape and sliced, the batch-coupled reductions
(normalised depth L1's mean and std, stochastic K's importance, the
overflow statistics) are global, and one all-reduce averages the
gradients and the loss terms, so the step equals world 1's on the same
global batch and every rank applies the same update.  Rank 0 writes the
checkpoints, the history and the plots.  `config.num_devices` is read by
the CLI only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.device import resolve_device
from fresnel_tpu_torch.geometry import (
    AdaptiveDensityParams, SilhouetteWrapParams, SurfaceGaussianParams,
    VolumetricShellParams, pointcloud_from_depth, to_surface_gaussians)
from fresnel_tpu_torch.losses.aggregate import compute_losses
from fresnel_tpu_torch.losses.lpips import LPIPS
from fresnel_tpu_torch.losses.physics import init_learnable_wavelengths
from fresnel_tpu_torch.losses.ssim import ssim
from fresnel_tpu_torch.models.blocks import tensegrity_loss
from fresnel_tpu_torch.models.decoders import (
    DirectPatchDecoder, PhysicsDirectPatchDecoder)
from fresnel_tpu_torch.models.fibonacci import FibonacciPatchDecoder
from fresnel_tpu_torch.models.encoders import resize_linear
from fresnel_tpu_torch.models.image_encoder import ImageEncoder
from fresnel_tpu_torch.models.nca import NCAGaussianDecoder
from fresnel_tpu_torch.models.saag_refine import (
    FeatureGuidedSAAG, SAAGRefinementNet)
from fresnel_tpu_torch.parallel.mesh import (
    RowGenerator, batch_mean, data_parallel_step, global_max, global_sum,
    pmean_gradients, replicate, shard_batch, step_shard)
from fresnel_tpu_torch.physics.fresnel_zones import FresnelZones
from fresnel_tpu_torch.render.factory import select_training_renderer
from fresnel_tpu_torch.train.config import (
    HFGSConfig, HFTSConfig, PhysicsConfig, TrainingConfig)
from fresnel_tpu_torch.train.flax_msgpack import read_flat
from fresnel_tpu_torch.train.optim import AdamWClip
from fresnel_tpu_torch.train.thin_ckpt import (
    cast_like, load_thin_params, params_of)
from fresnel_tpu_torch.utils.precision import amp_apply
from fresnel_tpu_torch.weights import init_flax_like_, trainer_opt_state


def physics_route(config: TrainingConfig,
                  physics_config: Optional[PhysicsConfig]) -> bool:
    """Wave rendering without phase output: experiment 2's decoder is then
    PhysicsDirectPatchDecoder, whose head differs, and no experiment
    distils (the JAX trainer's test, which does not read the
    experiment)."""
    return (physics_config is not None and physics_config.use_wave_rendering
            and not config.use_phase_output)


def build_decoder(config: TrainingConfig, physics_config: PhysicsConfig,
                  dropout: float = 0.1):
    """The decoder of an experiment: 1 SAAGRefinementNet, 2
    DirectPatchDecoder (with its Fresnel-zone, edge-aware, phase-output,
    pose-encoding and depth-fusion options), or PhysicsDirectPatchDecoder
    under wave rendering without phase output, 3 FeatureGuidedSAAG, 4
    FibonacciPatchDecoder (its zones, phases and pose encoding), 5
    NCAGaussianDecoder."""
    if config.experiment == 5:
        return NCAGaussianDecoder(
            feature_dim=config.feature_dim, n_points=config.n_spiral_points,
            n_steps=config.nca_steps, k_neighbors=config.nca_neighbors,
            step_size=config.nca_step_size)
    if config.experiment == 1:
        return SAAGRefinementNet(feature_dim=config.feature_dim,
                                 dropout=dropout)
    if config.experiment == 3:
        return FeatureGuidedSAAG(feature_dim=config.feature_dim)
    if config.experiment == 4:
        # As in the JAX package, the sidecar's gaussians_per_patch is not
        # passed: one Gaussian per spiral point.
        return FibonacciPatchDecoder(
            feature_dim=config.feature_dim,
            n_points=config.n_spiral_points, dropout=dropout,
            use_fresnel_zones=config.use_fresnel_zones,
            num_fresnel_zones=config.num_fresnel_zones,
            use_phase_output=config.use_phase_output,
            use_pose_encoding=config.use_pose_encoding,
            scale_bias=config.scale_bias, opacity_bias=config.opacity_bias)
    if config.experiment != 2:
        raise ValueError(f"unknown experiment {config.experiment}")
    if physics_route(config, physics_config):
        return PhysicsDirectPatchDecoder(
            feature_dim=config.feature_dim,
            gaussians_per_patch=config.gaussians_per_patch, dropout=dropout,
            wavelength=physics_config.wavelength,
            learnable_wavelength=physics_config.learnable_wavelength,
            focal_depth=physics_config.focal_depth,
            use_diffraction_placement=(
                physics_config.use_diffraction_placement),
            scale_bias=config.scale_bias, opacity_bias=config.opacity_bias)
    return DirectPatchDecoder(
        feature_dim=config.feature_dim,
        gaussians_per_patch=config.gaussians_per_patch,
        scale_bias=config.scale_bias, opacity_bias=config.opacity_bias,
        depth_z_scale=config.depth_z_scale, dropout=dropout,
        use_fresnel_zones=config.use_fresnel_zones,
        num_fresnel_zones=config.num_fresnel_zones,
        use_edge_aware=config.use_edge_aware,
        edge_scale_factor=config.edge_scale_factor,
        edge_opacity_boost=config.edge_opacity_boost,
        use_phase_output=config.use_phase_output,
        use_pose_encoding=config.use_pose_encoding,
        use_depth_fusion=config.use_depth_fusion,
        depth_feature_dim=config.depth_feature_dim,
        feature_upsample=config.feature_upsample,
        z_offset_scale=config.z_offset_scale)


SAAG_SUBSAMPLE = 8  # the depth subsample of the SAAG prior (experiments 1, 3)


def saag_prior_from_depth(depth: torch.Tensor,
                          subsample: int = SAAG_SUBSAMPLE
                          ) -> Dict[str, torch.Tensor]:
    """(B, H, W) depth -> the batch's base-only SAAG clouds, (B, N, ...)
    fields under the keys of SAAGRefinementNet's arguments: depth scale
    2, normalised to extent 3, base size 0.05, shell, wrap and density
    off; the subsampled points read the full-resolution surface maps.
    One batched call."""
    pc = pointcloud_from_depth(depth, depth_scale=2.0,
                               subsample=subsample).normalize(3.0)
    g = to_surface_gaussians(
        pc, depth, params=SurfaceGaussianParams(base_size=0.05),
        wrap_params=SilhouetteWrapParams(enabled=False),
        shell_params=VolumetricShellParams(enabled=False),
        density_params=AdaptiveDensityParams(enabled=False))
    return {"saag_positions": g.positions, "saag_scales": g.scales,
            "saag_rotations": g.rotations, "saag_colors": g.colors,
            "saag_opacities": g.opacities}


def save_loss_plots(history: Dict[str, list], path) -> bool:
    """4-panel loss plots; no-op without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    keys = [k for k in ("total", "rgb", "ssim", "depth") if k in history]
    if not keys:
        return False
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    for ax, k in zip(axes.ravel(), keys):
        ax.plot(history[k])
        ax.set_title(k)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=90)
    plt.close(fig)
    return True


def gumbel_topk_indices(generator: torch.Generator, weights: torch.Tensor,
                        k: int) -> torch.Tensor:
    """k indices without replacement, probability proportional to
    `weights` (Gumbel top-k), the noise drawn from `generator`."""
    logp = torch.log(torch.clamp(weights, min=1e-12))
    u = torch.rand(weights.shape, generator=generator,
                   device=weights.device) * (1.0 - 1e-9) + 1e-9
    return torch.topk(logp - torch.log(-torch.log(u)), k).indices


# Raw channel groups of the distillation loss: XY offsets (and the unused
# z), scales, the 6D rotation, colour logits, the opacity logit.
DISTILL_WEIGHTS = (1.0,) * 3 + (0.5,) * 3 + (0.3,) * 6 + (0.25,) * 3 + (0.5,)


def distill_loss(raw: torch.Tensor, teacher_raw: torch.Tensor,
                 teacher_do: torch.Tensor, depth_offset: torch.Tensor,
                 K: int, config: TrainingConfig) -> torch.Tensor:
    """The raw-head distillation term: the Huber loss (delta 1) of the
    decoder's raw outputs, first 16 channels, against the teachers' first
    K Gaussians (axis -2 covers both layouts, (B, g, g, Kt, 16) and
    (B, N, Kt, 16)), shifted by the head biases the teachers were fit
    without, weighted by channel group; plus the squared error of the
    depth offset against each teacher's."""
    adj = torch.zeros(16, dtype=raw.dtype, device=raw.device)
    adj[3:6] = -config.scale_bias
    adj[15] = -config.opacity_bias
    diff = raw[..., :16] - (teacher_raw[..., :K, :] + adj)
    a = torch.abs(diff)
    huber = torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5)
    gw = torch.tensor(DISTILL_WEIGHTS, dtype=raw.dtype, device=raw.device)
    return (torch.mean(huber * gw)
            + torch.mean((depth_offset - teacher_do) ** 2))


# Loss-dict terms a data-parallel step computes from global sums already
# (`loss`), so they are not averaged over ranks with the others.
GLOBAL_LOSS_KEYS = ("overflow_dropped_frac", "overflow_tiles_frac",
                    "overflow_max_tile_hits", "view_overflow_dropped_frac")


def _split(params: Dict[str, torch.Tensor], prefix: str
           ) -> Dict[str, torch.Tensor]:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _quiet(*args, **kwargs):
    pass


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclasses.dataclass
class Trainer:
    config: TrainingConfig
    physics_config: PhysicsConfig = dataclasses.field(
        default_factory=PhysicsConfig)
    hfgs_config: HFGSConfig = dataclasses.field(default_factory=HFGSConfig)
    hfts_config: HFTSConfig = dataclasses.field(default_factory=HFTSConfig)
    lpips: Optional[LPIPS] = None
    device: Any = None

    def __post_init__(self):
        cfg = self.config
        self.device = resolve_device(self.device)
        if self.lpips is not None:
            self.lpips = self.lpips.to(self.device)
        self.model = build_decoder(cfg, self.physics_config)
        self.encoder = None
        if cfg.train_encoder:
            self.encoder = ImageEncoder(
                feature_dim=cfg.feature_dim, grid=cfg.feature_size,
                width=cfg.encoder_width, attn_pool=cfg.encoder_attn_pool)
        self.renderer = select_training_renderer(
            cfg, self.physics_config, self.hfgs_config)
        self.train_res = self.hfts_config.get_effective_train_resolution(
            cfg.image_size)
        self.camera = Camera.default_training(self.train_res).to(self.device)
        self.fresnel_zones = (FresnelZones(num_zones=cfg.num_fresnel_zones)
                              if cfg.boundary_weight > 0 else None)
        self.history: Dict[str, list] = {}
        self._make_optimizer(max(cfg.epochs, 1) * 100)

    def _make_optimizer(self, total_steps: int):
        cfg = self.config
        self.optimizer = AdamWClip(cfg.lr, total_steps, cfg.weight_decay,
                                   schedule=cfg.lr_schedule)

    # ------------------------------------------------------------------
    def init_state(self, sample_batch: Optional[Dict] = None
                   ) -> Dict[str, Any]:
        """Flax-like init of every parameter from a CPU generator seeded
        with config.seed, so the card and the CPU start from the same bits;
        then moved to the trainer's device.  `sample_batch` is accepted for
        the JAX trainer's signature; no shape depends on it here."""
        g = torch.Generator().manual_seed(self.config.seed)
        params: Dict[str, torch.Tensor] = {}
        for prefix, module in (("model", self.model),
                               ("encoder", self.encoder)):
            if module is None:
                continue
            module.to("cpu")
            init_flax_like_(module, g)
            module.to(self.device)
            for k, v in module.named_parameters():
                params[f"{prefix}.{k}"] = v.detach().clone()
        if self.hfgs_config.learnable_wavelengths:
            params["wavelengths_raw"] = init_learnable_wavelengths(self.device)
        if (self.fresnel_zones is not None
                and self.config.learnable_boundary_emphasis):
            params["boundary_emphasis"] = torch.ones(
                self.config.num_fresnel_zones + 1, device=self.device)
        return {"params": params, "opt_state": self.optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    # ------------------------------------------------------------------
    def _features(self, params, image: torch.Tensor,
                  amp: bool = False) -> torch.Tensor:
        return amp_apply(self.encoder, _split(params, "encoder"), image,
                         use_amp=amp)

    def gaussians(self, params: Dict[str, torch.Tensor],
                  feats: torch.Tensor, depth: torch.Tensor, K: int,
                  generator: Optional[torch.Generator] = None,
                  poses: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                  nca_masks: Optional[torch.Tensor] = None,
                  return_raw: bool = False,
                  amp: bool = False) -> Dict[str, torch.Tensor]:
        """The training-mode decoder output for a batch: (B, N, ...)
        Gaussian fields (with "residuals" for experiment 1, "raw" with
        `return_raw`).  Experiment 1 refines the batch's SAAG prior,
        experiment 3 scales it by its patch-mean modulations.  With `amp`
        the decoder runs in bf16 on its positional inputs (the features,
        and the depth where it takes one); the SAAG prior and the poses
        are keyword inputs and stay float32, as in the JAX trainer."""
        mp = _split(params, "model")
        exp = self.config.experiment

        def apply(*args, **kwargs):
            return amp_apply(self.model, mp, *args, use_amp=amp, **kwargs)

        if exp == 1:
            saag = saag_prior_from_depth(depth)
            return apply(feats, **saag, deterministic=False,
                         generator=generator)
        if exp == 3:
            saag = saag_prior_from_depth(depth)
            mods = apply(feats)
            size_m = mods["base_size_mult"].mean(dim=(1, 2))
            op_m = mods["opacity_mult"].mean(dim=(1, 2))
            return {"positions": saag["saag_positions"],
                    "scales": saag["saag_scales"] * size_m[:, None, None],
                    "rotations": saag["saag_rotations"],
                    "colors": saag["saag_colors"],
                    "opacities": torch.clamp(
                        saag["saag_opacities"] * op_m[:, None], 0.0, 1.0)}
        kwargs: Dict[str, Any] = dict(num_gaussians=K, deterministic=False,
                                      generator=generator)
        if exp == 5:
            kwargs["masks"] = nca_masks
        elif return_raw:
            kwargs["return_raw"] = True
        if poses is not None:
            el, az = (torch.as_tensor(a, dtype=torch.float32,
                                      device=feats.device) for a in poses)
            kwargs.update(elevation=el, azimuth=az)
        elif self.config.use_pose_encoding:
            # As the JAX trainer: the pose encoder sees the frontal pose
            # when no pose is drawn (the grid's rotation by it is exact).
            zero = torch.zeros(feats.shape[0], device=feats.device)
            kwargs.update(elevation=zero, azimuth=zero)
        return apply(feats, depth, **kwargs)

    def loss(self, params: Dict[str, torch.Tensor], batch: Dict,
             K: int, stochastic_k: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             poses: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             nca_masks: Optional[torch.Tensor] = None,
             topk_indices: Optional[torch.Tensor] = None):
        """(total, loss dict) of one batch of device tensors.  `poses` are
        the multi-pose (elevation, azimuth) draws in radians, (B,) each;
        `nca_masks` experiment 5's update masks (steps, B, N, 1), drawn
        from `generator` when None; `topk_indices` the (stochastic_k,)
        Gaussians of the stochastic-K subsample, drawn from `generator`
        (Gumbel top-k of the batch's mean opacity) when None.  The
        decoder's "phases" go to the renderer (the wave field's, or phase
        blending's), and the same stochastic-K subsample as the
        Gaussians.  Under a data-parallel step the batch holds the rank's
        rows and the batch-coupled terms are global (module docstring)."""
        cfg = self.config
        res = self.train_res
        depth, target = batch["depth"], batch["image"]
        feats = (self._features(params, target, cfg.use_amp)
                 if self.encoder is not None else batch["features"])
        B = feats.shape[0]
        # Under a data-parallel step the batch holds this rank's B rows:
        # the decoder's batch draws come from the global draw, and the
        # batch-coupled reductions run over the step's ranks.
        shard = step_shard()
        dgen = (generator if shard is None
                else RowGenerator(generator, shard, B))
        if target.shape[-1] != res:
            target = resize_linear(target, res, res)
        target_depth = resize_linear(depth, res, res)

        distill = (cfg.distill_weight > 0 and "teacher_raw" in batch
                   and cfg.experiment in (2, 4)
                   and not physics_route(cfg, self.physics_config))
        out = self.gaussians(params, feats, depth, K, dgen, poses,
                             nca_masks, return_raw=distill,
                             amp=cfg.use_amp)
        pos, sc, rot = out["positions"], out["scales"], out["rotations"]
        col, op = out["colors"], out["opacities"]
        phases = out.get("phases")

        if stochastic_k is not None and stochastic_k < pos.shape[1]:
            idx = topk_indices
            if idx is None:
                importance = batch_mean(op.detach(), shard) + 1e-6
                idx = gumbel_topk_indices(
                    generator, importance / importance.sum(), stochastic_k)
            pos, sc, rot = pos[:, idx], sc[:, idx], rot[:, idx]
            col, op = col[:, idx], op[:, idx]
            if phases is not None:
                phases = phases[:, idx]

        cams = self.camera
        if poses is not None:
            cams = [Camera.from_pose(float(e), float(a), res).to(pos.device)
                    for e, a in zip(*poses)]
        imgs, rdepth, ovf = self.renderer.batch(pos, sc, rot, col, op, cams,
                                                phases=phases)

        total, ld = compute_losses(
            imgs, target, rendered_depth=rdepth, target_depth=target_depth,
            residuals=out.get("residuals"), config=cfg,
            lpips_fn=self.lpips, vlm_density=batch.get("vlm_density"),
            physics_config=self.physics_config, hfgs_config=self.hfgs_config,
            learnable_wavelengths_raw=params.get("wavelengths_raw"),
            fresnel_zones=self.fresnel_zones,
            boundary_emphasis=params.get("boundary_emphasis"), shard=shard)

        if ovf is not None:
            # (B, 4) [dropped, total_pairs, overflow_tiles, max] per image;
            # only the tiled renderer bins.
            n_tiles = (-(-res // 16)) ** 2
            ovf_sum = global_sum(ovf.sum(dim=0), shard).to(torch.float32)
            ld["overflow_dropped_frac"] = ovf_sum[0] / torch.clamp(
                ovf_sum[1], min=1.0)
            world = 1 if shard is None else shard.world
            ld["overflow_tiles_frac"] = ovf_sum[2] / (B * world * n_tiles)
            ld["overflow_max_tile_hits"] = global_max(
                ovf[:, 3].max(), shard).to(torch.float32)

        if cfg.view_weight > 0 and "view_gt" in batch:
            # One non-frontal GT orbit view per sample (drawn on the host
            # by device_batch): the same clouds from that azimuth against
            # the raytraced ground truth.
            gt = batch["view_gt"]                             # (B, 3, S, S)
            if gt.shape[-1] != res:
                gt = resize_linear(gt, res, res)
            cams_v = [Camera.from_pose(0.0, a, res).to(pos.device)
                      for a in batch["view_az_rad"]]
            imgs_v, _, ovf_v = self.renderer.batch(pos, sc, rot, col, op,
                                                   cams_v)
            v_l1 = torch.mean(torch.abs(imgs_v - gt))
            v_ssim = 1.0 - ssim(torch.clamp(imgs_v, 0.0, 1.0), gt,
                                data_range=1.0)
            v_loss = v_l1 + cfg.ssim_weight * v_ssim
            ld["view"] = v_loss
            total = total + cfg.view_weight * v_loss
            ld["total"] = total
            if ovf_v is not None:
                ovf_v_sum = global_sum(ovf_v.sum(dim=0), shard).to(
                    torch.float32)
                ld["view_overflow_dropped_frac"] = (
                    ovf_v_sum[0] / torch.clamp(ovf_v_sum[1], min=1.0))

        if distill:
            d_total = distill_loss(out["raw"], batch["teacher_raw"],
                                   batch["teacher_do"],
                                   params["model.depth_offset"], K, cfg)
            ld["distill"] = d_total
            scale = batch.get("distill_scale", 1.0)
            total = total + cfg.distill_weight * scale * d_total
            ld["total"] = total

        if cfg.use_tensegrity_loss:
            # Bound the O(N^2) kNN to a fixed 512-point subsample.
            n = pos.shape[1]
            t_l = tensegrity_loss(pos[:, ::max(1, n // 512)][:, :512])
            ld["tensegrity"] = t_l
            total = total + cfg.tensegrity_weight * t_l
            ld["total"] = total
        return total, ld

    def gradients(self, params: Dict[str, torch.Tensor], batch: Dict,
                  K: int, stochastic_k: Optional[int] = None,
                  generator: Optional[torch.Generator] = None,
                  poses=None, nca_masks: Optional[torch.Tensor] = None,
                  topk_indices: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """(gradient dict, loss dict on the device) of one batch at
        `params` (None for a parameter the loss does not reach).  Under a
        data-parallel step (`parallel.data_parallel_step`) one all-reduce
        averages the gradients and this rank's loss terms over the ranks,
        so both are the global batch's on every rank."""
        names = list(params)
        params = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.enable_grad():
            total, ld = self.loss(params, batch, K, stochastic_k, generator,
                                  poses, nca_masks, topk_indices)
            grads = torch.autograd.grad(total, [params[k] for k in names],
                                        allow_unused=True)
        ld = {k: v.detach() for k, v in ld.items()}
        own = {f"loss/{k}": v for k, v in ld.items()
               if k not in GLOBAL_LOSS_KEYS}
        avg = pmean_gradients({**dict(zip(names, grads)), **own})
        ld.update({k[len("loss/"):]: avg[k] for k in own})
        return {k: avg[k] for k in names}, ld

    def train_step(self, state: Dict, batch: Dict, K: int,
                   stochastic_k: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   poses=None, nca_masks: Optional[torch.Tensor] = None,
                   topk_indices: Optional[torch.Tensor] = None
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        """One optimizer step; returns (new state, loss dict on the
        device).  A non-finite loss or gradient leaves params, moments and
        the schedule's count as they were (the step counter still
        advances, as in the JAX trainer).  Under a data-parallel step the
        gradients, the guard and the loss dict are the global batch's on
        every rank (`gradients`), so every rank applies the same update
        and a non-finite gradient on one rank skips the step on all."""
        grads, ld = self.gradients(state["params"], batch, K, stochastic_k,
                                   generator, poses, nca_masks, topk_indices)
        new_params, new_opt = self.optimizer.update(
            state["params"], grads, state["opt_state"], loss=ld["total"])
        return ({"params": new_params, "opt_state": new_opt,
                 "step": state["step"] + 1}, ld)

    # ------------------------------------------------------------------
    def device_batch(self, batch: Dict[str, np.ndarray],
                     nprng: Optional[np.random.Generator] = None
                     ) -> Dict:
        """A host batch on the device.  The GT orbit views stay on the
        host: with `view_weight` > 0, one non-frontal view per sample is
        drawn from `nprng` (the generator `batches` shuffles with, right
        after the batch is drawn, as the JAX trainer does) and only that
        view goes to the device as "view_gt", its azimuth as "view_az_rad"
        (float32 radians, on the host)."""
        out: Dict = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in batch.items()
                     if k not in ("views", "view_azimuths_deg")}
        if self.config.view_weight > 0 and "views" in batch:
            if nprng is None:
                raise ValueError("view-aware training draws its GT view "
                                 "from the batches' generator: pass nprng")
            v = batch["views"]                          # (B, V, 3, S, S)
            B, V = v.shape[:2]
            vidx = nprng.integers(1, V, size=B)         # skip frontal (0)
            out["view_gt"] = torch.as_tensor(
                np.ascontiguousarray(v[np.arange(B), vidx]),
                device=self.device)
            az = np.asarray(batch["view_azimuths_deg"], np.float32)[vidx]
            out["view_az_rad"] = az * np.float32(np.pi / 180)
        return out

    def draw_poses(self, rng: np.random.Generator, B: int):
        """Multi-pose (elevation, azimuth) in radians, frontal with
        probability frontal_prob; None without multi-pose augmentation."""
        cfg = self.config
        if not cfg.multi_pose_augmentation:
            return None
        el_lo, el_hi = np.radians(cfg.pose_range_elevation)
        az_lo, az_hi = np.radians(cfg.pose_range_azimuth)
        el = rng.uniform(el_lo, el_hi, B)
        az = rng.uniform(az_lo, az_hi, B)
        frontal = rng.uniform(size=B) < cfg.frontal_prob
        return (np.where(frontal, 0.0, el).astype(np.float32),
                np.where(frontal, 0.0, az).astype(np.float32))

    def fit(self, dataset, epochs: Optional[int] = None,
            state: Optional[Dict] = None, log_fn: Callable = print,
            mesh=None, start_epoch: int = 0,
            stop_epoch: Optional[int] = None) -> Dict:
        """Train over `dataset`.  start_epoch / stop_epoch run a segment of
        the full schedule (progressive K, the cosine span and checkpoint
        numbering follow the full `epochs`).  With a `mesh`
        (`parallel.get_mesh()`, every rank calling `fit` alike) the steps
        are data-parallel over its "data" axis: the state is broadcast
        from rank 0, each rank steps on its rows of every global batch,
        and rank 0 alone logs and writes the files."""
        cfg = self.config
        rank0 = mesh is None or dist.get_rank() == 0
        if not rank0:
            log_fn = _quiet
        step_fn = (self.train_step if mesh is None
                   else data_parallel_step(self.train_step, mesh))
        epochs = cfg.epochs if epochs is None else epochs
        nprng = np.random.default_rng(cfg.seed)
        pose_rng = np.random.default_rng(cfg.seed + 2)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

        steps_per_epoch = max(1, len(dataset) // cfg.batch_size)
        self._make_optimizer(epochs * steps_per_epoch)

        first = next(iter(dataset.batches(cfg.batch_size, nprng)))
        if cfg.distill_weight > 0 and "teacher_raw" not in first:
            raise ValueError(
                "distill_weight > 0 but the dataset has no teacher "
                "sidecars - generate them first: python -m "
                "fresnel_tpu_torch.train.fit_teacher --data_dir <data_dir>")
        self._depth_side = int(first["depth"].shape[-1])
        if state is None:
            state = self.init_state(first)
            if cfg.depth_offset_init is not None:
                if "model.depth_offset" not in state["params"]:
                    raise ValueError(
                        f"depth_offset_init: experiment {cfg.experiment}'s "
                        "decoder has no depth offset")
                state["params"]["model.depth_offset"] = torch.tensor(
                    float(cfg.depth_offset_init), device=self.device)
                log_fn(f"depth_offset initialized at "
                       f"{cfg.depth_offset_init:.3f}")
            elif cfg.distill_weight > 0:
                # Adam moves a lone scalar ~lr per step: start the depth
                # offset at the teachers' mean, the regression target.
                do0 = float(np.mean(first["teacher_do"]))
                state["params"]["model.depth_offset"] = torch.tensor(
                    do0, device=self.device)
                log_fn(f"distill: depth_offset initialized at teacher "
                       f"mean {do0:.3f}")
        if mesh is not None:
            state = replicate(state, mesh)

        out_dir = Path(cfg.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        best_loss = float("inf")

        last_epoch = epochs if stop_epoch is None else min(stop_epoch, epochs)
        for epoch in range(start_epoch, last_epoch):
            K = self.hfts_config.get_gaussians_per_patch(
                epoch, epochs, cfg.gaussians_per_patch)
            n_total = self._total_gaussians(K)
            sk = self.hfts_config.get_stochastic_k(n_total)
            sk = None if sk >= n_total else sk

            t0 = time.perf_counter()
            epoch_losses: Dict[str, list] = {}
            for batch in dataset.batches(cfg.batch_size, nprng):
                jb = self.device_batch(batch, nprng)
                if cfg.distill_weight > 0:
                    dec = cfg.distill_decay_epochs
                    jb["distill_scale"] = (1.0 if dec <= 0 else
                                           max(0.0, 1.0 - epoch / dec))
                poses = self.draw_poses(pose_rng, cfg.batch_size)
                if mesh is not None:
                    jb, poses = shard_batch(jb, mesh), shard_batch(poses,
                                                                   mesh)
                state, ld = step_fn(state, jb, K, sk, gen, poses)
                for k, v in ld.items():
                    epoch_losses.setdefault(k, []).append(v)

            # One host read per epoch.
            keys = list(epoch_losses)
            vals = torch.stack([torch.stack(epoch_losses[k]).mean()
                                for k in keys]).cpu().tolist()
            means = dict(zip(keys, vals))
            dt = time.perf_counter() - t0
            for k, v in means.items():
                self.history.setdefault(k, []).append(v)
            ovf_str = ""
            if "overflow_dropped_frac" in means:
                ovf_str = (f" ovf={means['overflow_dropped_frac']:.3f}"
                           f"/{means['overflow_tiles_frac']:.3f}"
                           f" max={means['overflow_max_tile_hits']:.0f}")
            log_fn(f"epoch {epoch + 1}/{epochs} K={K} sk={sk} "
                   f"loss={means.get('total', float('nan')):.4f} "
                   f"({dt:.1f}s, {steps_per_epoch / max(dt, 1e-9):.2f} it/s)"
                   + ovf_str)

            if rank0 and (epoch + 1) % cfg.save_interval == 0:
                self.save_checkpoint(
                    out_dir / f"checkpoint_epoch{epoch + 1}.pt", state, epoch)
            if means.get("total", float("inf")) < best_loss:
                best_loss = means["total"]
                if rank0:
                    self.save_checkpoint(out_dir / "best_model.pt", state,
                                         epoch)

        if rank0:
            if last_epoch >= epochs:
                self.save_checkpoint(out_dir / "final_model.pt", state,
                                     epochs - 1)
            else:   # segment boundary: guarantee a resume point
                self.save_checkpoint(
                    out_dir / f"checkpoint_epoch{last_epoch}.pt", state,
                    last_epoch - 1)
            with open(out_dir / "loss_history.json", "w") as f:
                json.dump(self.history, f, indent=2)
            save_loss_plots(self.history, out_dir / "loss_plots.png")
        if mesh is not None:
            dist.barrier()
        return state

    def _total_gaussians(self, K: int) -> int:
        if self.config.experiment in (4, 5):
            return self.config.n_spiral_points
        if self.config.experiment in (1, 3):
            side = getattr(self, "_depth_side", 256)
            return (side // SAAG_SUBSAMPLE) ** 2   # the SAAG prior's points
        return self.config.feature_size ** 2 * K

    # ------------------------------------------------------------------
    def encode(self, params: Dict[str, torch.Tensor], images) -> torch.Tensor:
        """The jointly trained encoder on (B, 3, H, W) images in [0, 1] ->
        (B, grid, grid, C) features."""
        if self.encoder is None:
            raise ValueError("this Trainer/checkpoint has no trained "
                             "encoder (config.train_encoder is False)")
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        with torch.no_grad():
            return self._features(params, images)

    def decode(self, params: Dict[str, torch.Tensor], features,
               depth) -> Dict[str, torch.Tensor]:
        """The decoder in inference mode (no dropout) on (B, g, g, C)
        features and (B, H, W) depth -> the B clouds' Gaussian fields.
        Experiments 1 and 3 refine a SAAG prior and take no depth
        argument: the JAX package's `infer` and `eval` call
        `model.apply(params, feats, depth)` on them, which fails with a
        TypeError, so here they raise a ValueError saying so."""
        if self.config.experiment in (1, 3):
            raise ValueError(
                f"experiment {self.config.experiment} refines a SAAG prior "
                "and has no (features, depth) decoder: infer / eval of its "
                "checkpoints is not defined (the JAX package's cli calls "
                "model.apply(params, feats, depth), which fails)")
        features = torch.as_tensor(features, dtype=torch.float32,
                                   device=self.device)
        depth = torch.as_tensor(depth, dtype=torch.float32,
                                device=self.device)
        with torch.no_grad():
            return functional_call(self.model, _split(params, "model"),
                                   (features, depth))

    # ------------------------------------------------------------------
    def save_checkpoint(self, path, state: Dict, epoch: int) -> None:
        torch.save({"params": _to_cpu(state["params"]),
                    "opt_state": _to_cpu(state["opt_state"]),
                    "step": _to_cpu(state["step"])}, str(path))
        meta = {
            "epoch": epoch,
            "config": dataclasses.asdict(self.config),
            "physics_config": dataclasses.asdict(self.physics_config),
            "hfgs_config": dataclasses.asdict(self.hfgs_config),
            "hfts_config": dataclasses.asdict(self.hfts_config),
        }
        Path(str(path) + ".json").write_text(json.dumps(meta, indent=2))

    def load_checkpoint(self, path, sample_batch=None) -> Tuple[Dict, int]:
        """(state, epoch) from a checkpoint: a `.pt` of `save_checkpoint`,
        the JAX package's full Flax msgpack (params, Adam moments, count
        and step carried over exactly), or a thin file, `.pt` or Flax
        msgpack (`"thin": true` in the sidecar: bf16 params cast to
        float32, a fresh optimizer state whose count is 0, so the cosine
        schedule restarts at its peak as in the JAX trainer, and `step`
        from the sidecar).  Its parameter
        names and shapes must be this trainer's."""
        meta_path = Path(str(path) + ".json")
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        template = self.init_state(sample_batch)
        attn_pool = self.config.encoder_attn_pool
        if meta.get("thin"):
            params = load_thin_params(path, template["params"], attn_pool)
            state = {"params": params, "opt_state": template["opt_state"],
                     "step": torch.tensor(meta.get("step", 0),
                                          dtype=torch.int32,
                                          device=self.device)}
            print(f"thin resume from {path}: params restored, optimizer "
                  f"state freshly initialized", flush=True)
            return state, meta.get("epoch", 0)
        if str(path).endswith(".msgpack"):
            flat = read_flat(path)
            opt = trainer_opt_state(
                {k[len("opt_state/"):]: v for k, v in flat.items()
                 if k.startswith("opt_state/")}, attn_pool)
            tp = template["params"]
            payload = {
                "params": cast_like(params_of(flat, attn_pool), tp, path),
                "opt_state": {
                    "count": opt["count"],
                    "mu": cast_like(opt["mu"], tp, path),
                    "nu": cast_like(opt["nu"], tp, path)},
                "step": torch.tensor(int(np.asarray(flat["step"])),
                                     dtype=torch.int32)}
        else:
            payload = torch.load(str(path), map_location=self.device,
                                 weights_only=True)
            payload["params"] = cast_like(payload["params"],
                                          template["params"], path)
        if not meta_path.exists():
            if not os.environ.get("FRESNEL_ALLOW_MISSING_SIDECAR"):
                raise FileNotFoundError(
                    f"no config sidecar at {meta_path} - resuming without it "
                    f"restarts the LR schedule at epoch 0 with converged "
                    f"weights; set FRESNEL_ALLOW_MISSING_SIDECAR=1 to resume "
                    f"at epoch 0 anyway.")
            print(f"WARNING: no config sidecar at {meta_path}; resuming at "
                  f"epoch 0 (LR schedule restarts)", flush=True)
        state = {"params": payload["params"],
                 "opt_state": payload["opt_state"], "step": payload["step"]}
        return _to_device(state, self.device), meta.get("epoch", 0)


def trainer_from_checkpoint(path, device=None) -> Trainer:
    """The Trainer a checkpoint was trained with, from its `.json` sidecar
    (the four configs; `num_devices` is inert here, as in the JAX
    package)."""
    meta_path = Path(str(path) + ".json")
    if not meta_path.exists():
        raise FileNotFoundError(f"no config sidecar at {meta_path}: the "
                                "model cannot be rebuilt")
    meta = json.loads(meta_path.read_text())
    return Trainer(TrainingConfig(**meta["config"]),
                   PhysicsConfig(**meta["physics_config"]),
                   HFGSConfig(**meta["hfgs_config"]),
                   HFTSConfig(**meta["hfts_config"]), device=device)
