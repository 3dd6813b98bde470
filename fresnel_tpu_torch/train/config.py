"""Training configuration dataclasses.

Counterpart of fresnel_tpu/train/config.py, field for field: the same
names, defaults and order, so `dataclasses.asdict` gives the same sidecar
JSON and checkpoints' sidecars interchange between the two packages.
`TrainingConfig` mirrors the reference's training flag surface;
`HFTSConfig` holds the multi-resolution / progressive-K / stochastic-K
schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainingConfig:
    experiment: int = 2
    data_dir: str = "images"
    output_dir: str = "checkpoints"
    batch_size: int = 4
    epochs: int = 100
    lr: float = 1e-4
    lr_schedule: str = "cosine"   # "cosine" (reference default) | "constant"
    # Start the global depth_offset scalar here (None = the reference's
    # -2.0 init).  Adam moves a lone scalar ~lr/step, so a badly placed
    # init is effectively frozen for a whole run (T-027); the teacher
    # consensus on the corpus is ~-0.13.
    depth_offset_init: "float | None" = None
    weight_decay: float = 1e-5
    image_size: int = 256
    feature_size: int = 37
    feature_dim: int = 384

    # Depth fusion
    use_depth_fusion: bool = False
    depth_feature_dim: int = 64

    # Loss weights
    rgb_weight: float = 1.0
    depth_weight: float = 0.1
    ssim_weight: float = 0.5
    lpips_weight: float = 0.1
    residual_weight: float = 0.01

    use_augmentation: bool = True

    gaussians_per_patch: int = 4
    max_images: Optional[int] = None

    # Fibonacci decoder (Experiment 4)
    n_spiral_points: int = 377
    use_tensegrity_loss: bool = False
    tensegrity_weight: float = 0.01

    # NCA decoder (Experiment 5)
    nca_steps: int = 16
    nca_neighbors: int = 6
    nca_step_size: float = 0.1

    # VLM semantic guidance
    use_vlm_guidance: bool = False
    vlm_weight: float = 0.5

    # Fresnel-inspired enhancements
    use_fresnel_zones: bool = False
    num_fresnel_zones: int = 8
    boundary_weight: float = 0.1
    # Learnable per-boundary emphasis on the boundary loss (reference
    # declares the parameter at fresnel_zones.py:94 but never consumes it;
    # here it trains — see FresnelZones.boundary_mask).
    learnable_boundary_emphasis: bool = False
    use_edge_aware: bool = False
    use_phase_blending: bool = False
    use_phase_output: bool = False
    edge_scale_factor: float = 0.5
    edge_opacity_boost: float = 0.2
    phase_amplitude: float = 0.25

    # Multi-pose training
    multi_pose_augmentation: bool = False
    pose_range_elevation: Tuple[float, float] = (-30.0, 45.0)
    pose_range_azimuth: Tuple[float, float] = (0.0, 360.0)
    frontal_prob: float = 0.3
    use_pose_encoding: bool = False

    # Logging
    log_interval: int = 10
    save_interval: int = 10

    # Additions with no reference equivalent:
    num_devices: Optional[int] = None  # data-parallel devices (None = all)
    seed: int = 0
    # bf16 mixed precision (the reference's torch.cuda.amp usage,
    # train_direct_decoder.py AMP+scaler): decoder forward in bfloat16,
    # render/loss/optimizer in float32.  Not ported: the Trainer raises.
    use_amp: bool = False
    # Static per-tile Gaussian capacity of the training rasterizer.  The
    # reference's per-pixel loop has NO cap (it walks every bbox-overlapping
    # Gaussian, differentiable_renderer.py:582-667); our tiled renderer bins
    # at most this many Gaussians per 16px tile in depth order and silently
    # drops the rest — which also severs their gradients.  256 is plenty once
    # a model has converged to sane scales, but early in training decoders
    # sit in a large-scale/low-opacity regime where >50% of tiles overflow
    # (measured: p90 1933 hits/tile on an exp-2 checkpoint), and the severed
    # gradients can lock that blur in.  Raise for training parity with the
    # reference (cost: composite time scales linearly with the cap).
    max_per_tile: int = 256
    # Distillation from per-scene decoder-space fits (train/fit_teacher.py
    # sidecars; the analogue of the reference's v2 distillation,
    # scripts/training/train_direct_decoder.py).  When > 0 and the dataset
    # provides `{scene}_teacher.npz`, adds raw-head regression + a
    # depth_offset term on top of the render loss.  Experiment 2 only.
    distill_weight: float = 0.0
    # Linearly decay the distill term to 0 over this many epochs so render
    # loss takes over (0 = constant weight).
    distill_decay_epochs: int = 0
    # End-to-end trainable image encoder (no reference equivalent).  The
    # reference conditions decoders on FROZEN pretrained DINOv2 features
    # (scripts/preprocessing/preprocess_training_data.py:214-232); with no
    # pretrained weights obtainable here, the fallback features carry no
    # semantic content and cap quality (T-015/T-030).  When True, a compact
    # conv+attention encoder (models/image_encoder.py) maps the batch image
    # to the same (37, 37, feature_dim) grid and trains jointly on the
    # render loss; checkpoints carry its params and eval/infer run it in
    # place of the cached/procedural extractor.
    train_encoder: bool = False
    encoder_width: int = 64
    # >1 = run the encoder's transformer blocks on a pooled token grid and
    # add the upsampled context back to the conv features — required for
    # HBM-feasible attention at feature_size > ~48 (T-045 finer-lattice
    # encoder arms).
    encoder_attn_pool: int = 1
    # Decoder head-init biases (0.0 = exact reference head behavior).
    # --surface_init sets (-2.6, 1.5): outputs START at surface-like params
    # (sigma ~= patch pitch, opacity ~0.8) — the basin the T-023 direct fit
    # converges from, instead of the blur equilibrium the reference init
    # falls into on render loss.
    scale_bias: float = 0.0
    opacity_bias: float = 0.0
    # View-aware training on corpus_v2 GT orbit views (novel-view
    # supervision; the reference's exp-011 analogue but with true GT):
    # weight for the (L1 + ssim_weight*(1-SSIM)) term on one randomly
    # sampled non-frontal GT view per sample per step.  0 = off.
    view_weight: float = 0.0
    # Depth-lock geometry (models/decoders.py:head_transform): -2.0 is
    # reference parity (gaussian_decoder_models.py:841) but inverts
    # parallax; +2.0 is physically correct for novel-view work.
    depth_z_scale: float = -2.0
    # >0 re-enables the raw z channel as tanh(raw)*scale residual on the
    # depth lock (identifiable only with multi-view supervision).
    z_offset_scale: float = 0.0
    # Decode on an f x finer patch lattice (models/decoders.py): bilinear
    # feature upsample + learned conv refinement before the per-patch MLP.
    # Attacks the 37x37-grid Nyquist texture cliff (T-038/T-040) directly;
    # 1 = off (reference parity).  Experiment 2 only.
    feature_upsample: int = 1


@dataclasses.dataclass
class PhysicsConfig:
    use_wave_rendering: bool = False
    wavelength: float = 0.05
    learnable_wavelength: bool = True
    use_physics_zones: bool = False
    num_zones: int = 8
    focal_depth: float = 0.5
    use_diffraction_placement: bool = False
    wave_equation_weight: float = 0.0
    use_multi_wavelength: bool = False
    compare_with_baseline: bool = False


@dataclasses.dataclass
class HFGSConfig:
    use_fourier_renderer: bool = False
    use_phase_retrieval_loss: bool = True
    phase_retrieval_weight: float = 0.1
    use_frequency_loss: bool = True
    frequency_loss_weight: float = 0.1
    high_freq_weight: float = 2.0
    frequency_cutoff: float = 0.1
    learnable_wavelengths: bool = True
    wavelength_r: float = 0.0635
    wavelength_g: float = 0.05
    wavelength_b: float = 0.041
    focal_depth: float = 0.5


@dataclasses.dataclass
class HFTSConfig:
    """Hybrid Fast Training System: multi-resolution + progressive growing +
    stochastic Gaussian sampling."""

    train_resolution: Optional[int] = None
    progressive_schedule: bool = False
    stochastic_k: Optional[int] = None
    fast_mode: bool = False

    def get_effective_train_resolution(self, image_size: int) -> int:
        if self.fast_mode:
            return 64
        return self.train_resolution if self.train_resolution is not None else image_size

    def get_gaussians_per_patch(self, epoch: int, total_epochs: int,
                                base_gpp: int = 4) -> int:
        """Progressive schedule: 1 -> 2 -> 4 -> base at the 25% marks."""
        if not self.progressive_schedule and not self.fast_mode:
            return base_gpp
        progress = epoch / max(total_epochs, 1)
        if progress < 0.25:
            return 1
        if progress < 0.50:
            return 2
        if progress < 0.75:
            return max(4, base_gpp)
        return base_gpp

    def get_stochastic_k(self, total_gaussians: int) -> int:
        if self.fast_mode and self.stochastic_k is None:
            return min(256, total_gaussians)
        if self.stochastic_k is not None:
            return min(self.stochastic_k, total_gaussians)
        return total_gaussians
