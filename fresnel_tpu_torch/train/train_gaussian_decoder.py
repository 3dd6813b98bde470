"""Gaussian-decoder training CLI, with the JAX package's flag surface.

Counterpart of fresnel_tpu/train/train_gaussian_decoder.py: the same
flags, defaults, choices and umbrella expansions (--use_qsr,
--surface_init, --fast_mode), so launch scripts port unchanged, plus
--device (the card by default, `cpu` on request).  Experiments 1-5
(`--experiment`; `--n_spiral_points` and `--nca_*` for 4 and 5), with
distillation from `fit_teacher` sidecars for 2 and 4 (`--distill_weight`,
`--distill_decay_epochs`; the dataset reads the sidecars of the
experiment trained), and bf16 decoder and encoder compute with float32
master weights (--use_amp, written to the sidecar; a --resume passes it
again, as in the JAX package), and the LPIPS term from --lpips_weights
or a file found under $FRESNEL_TPU_MODELS, ./models or ~/models
(`lpips_alex.pth` / `.pt` / `.npz`, `lpips.pth` / `.npz`; with none, the
term is dropped, as in the JAX package).  --streaming reads batches from
disk caches through `data.streaming.StreamingImageDataset` (after
--synthetic, which takes precedence, as in the JAX package).
--num_devices > 1 is not ported and raises NotImplementedError.
Checkpoints are `.pt` files with the JAX package's JSON sidecars; a
thin one (`train.thin_ckpt`) resumes with a fresh optimizer state.

Run:  python -m fresnel_tpu_torch.train.train_gaussian_decoder --synthetic \
          --epochs 1 --image_size 32 --feature_size 5 --feature_dim 384 \
          --device cpu --output_dir /tmp/ckpt
      python -m fresnel_tpu_torch.train.fit_teacher --data_dir DIR \
          --experiment 4 --grid 377 --device cpu
      python -m fresnel_tpu_torch.train.train_gaussian_decoder \
          --data_dir DIR --experiment 4 --distill_weight 1.0 \
          --distill_decay_epochs 2 --no_augmentation --device cpu
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train Gaussian decoder")
    p.add_argument("--experiment", type=int, default=2, choices=[1, 2, 3, 4, 5],
                   help="1=SAAG Refinement, 2=Direct, 3=FeatureGuided, "
                        "4=Fibonacci, 5=NCA")
    p.add_argument("--data_dir", type=str, default="images")
    p.add_argument("--output_dir", type=str, default="checkpoints")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_schedule", default="cosine",
                   choices=["cosine", "constant"])
    p.add_argument("--depth_offset_init", type=float, default=None,
                   help="Start the global depth_offset scalar here "
                        "(default: reference -2.0; T-027: Adam "
                        "cannot move a scalar far, so place it)")
    p.add_argument("--lpips_weight", type=float, default=0.1)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--feature_dim", type=int, default=384,
                   choices=[384, 768, 1024])
    p.add_argument("--use_depth_fusion", action="store_true")
    p.add_argument("--depth_feature_dim", type=int, default=64)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--stop_epoch", type=int, default=None,
                   help="Run only up to this epoch (exclusive) and save a\n                        resume checkpoint — segmented long runs")
    p.add_argument("--gaussians_per_patch", type=int, default=4)
    p.add_argument("--n_spiral_points", type=int, default=377)
    p.add_argument("--use_tensegrity_loss", action="store_true")
    p.add_argument("--tensegrity_weight", type=float, default=0.01)
    p.add_argument("--nca_steps", type=int, default=16)
    p.add_argument("--nca_neighbors", type=int, default=6)
    p.add_argument("--nca_step_size", type=float, default=0.1)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--use_vlm_guidance", action="store_true")
    p.add_argument("--vlm_weight", type=float, default=0.5)
    # Fresnel enhancements
    p.add_argument("--use_fresnel_zones", action="store_true")
    p.add_argument("--num_fresnel_zones", type=int, default=8)
    p.add_argument("--boundary_weight", type=float, default=0.1)
    p.add_argument("--learnable_boundary_emphasis", action="store_true",
                   help="Train a per-boundary emphasis vector through the "
                        "boundary loss (reference declares it at "
                        "fresnel_zones.py:94 but never consumes it)")
    p.add_argument("--use_edge_aware", action="store_true")
    p.add_argument("--use_phase_blending", action="store_true")
    p.add_argument("--use_phase_output", action="store_true")
    p.add_argument("--edge_scale_factor", type=float, default=0.5)
    p.add_argument("--edge_opacity_boost", type=float, default=0.2)
    p.add_argument("--phase_amplitude", type=float, default=0.25)
    # Physics
    p.add_argument("--use_wave_rendering", action="store_true")
    p.add_argument("--wavelength", type=float, default=0.05)
    p.add_argument("--learnable_wavelength", action="store_true")
    p.add_argument("--use_physics_zones", action="store_true")
    p.add_argument("--use_diffraction_placement", action="store_true")
    p.add_argument("--focal_depth", type=float, default=0.5)
    p.add_argument("--wave_equation_weight", type=float, default=0.0)
    p.add_argument("--use_multi_wavelength", action="store_true")
    # HFGS
    p.add_argument("--use_fourier_renderer", action="store_true")
    p.add_argument("--use_phase_retrieval_loss", action="store_true")
    p.add_argument("--phase_retrieval_weight", type=float, default=0.1)
    p.add_argument("--use_frequency_loss", action="store_true")
    p.add_argument("--frequency_loss_weight", type=float, default=0.1)
    p.add_argument("--high_freq_weight", type=float, default=2.0)
    p.add_argument("--frequency_cutoff", type=float, default=0.1)
    p.add_argument("--learnable_wavelengths", action="store_true")
    p.add_argument("--wavelength_r", type=float, default=0.0635)
    p.add_argument("--wavelength_g", type=float, default=0.05)
    p.add_argument("--wavelength_b", type=float, default=0.041)
    # QSR umbrella
    p.add_argument("--use_qsr", action="store_true",
                   help="Enable Quantum Scene Representation: per-channel "
                        "phases + wave rendering + phase retrieval")
    # HFTS
    p.add_argument("--train_resolution", type=int, default=None)
    p.add_argument("--progressive_schedule", action="store_true")
    p.add_argument("--stochastic_k", type=int, default=None)
    p.add_argument("--fast_mode", action="store_true")
    # Multi-pose
    p.add_argument("--multi_pose_augmentation", action="store_true")
    p.add_argument("--pose_range_elevation", type=float, nargs=2,
                   default=[-30, 45])
    p.add_argument("--pose_range_azimuth", type=float, nargs=2,
                   default=[0, 360])
    p.add_argument("--frontal_prob", type=float, default=0.3)
    p.add_argument("--use_pose_encoding", action="store_true")
    # Additions with no reference equivalent
    p.add_argument("--synthetic", action="store_true",
                   help="Train on procedurally generated scenes (no data dir)")
    p.add_argument("--synthetic_samples", type=int, default=16)
    p.add_argument("--num_devices", type=int, default=None,
                   help="Data-parallel devices (default: 1; >1 is not "
                        "ported)")
    p.add_argument("--streaming", action="store_true",
                   help="Stream batches from disk caches instead of "
                        "holding the dataset in memory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_amp", action="store_true",
                   help="bf16 decoder compute (fp32 master weights)")
    p.add_argument("--scale_bias", type=float, default=0.0,
                   help="Additive bias inside the scale head's softplus "
                        "(0 = reference behavior)")
    p.add_argument("--opacity_bias", type=float, default=0.0,
                   help="Additive bias inside the opacity sigmoid "
                        "(0 = reference behavior)")
    p.add_argument("--view_weight", type=float, default=0.0,
                   help="View-aware training: weight for the render loss "
                        "on one random GT orbit view per sample per step "
                        "(needs corpus_v2 {name}_views.npz sidecars)")
    p.add_argument("--depth_z_scale", type=float, default=-2.0,
                   help="Depth-lock slope: -2.0 = reference parity "
                        "(inverted parallax); +2.0 = physically correct "
                        "for novel-view supervision")
    p.add_argument("--z_offset_scale", type=float, default=0.0,
                   help=">0 re-enables the raw z channel as a bounded "
                        "per-Gaussian residual on the depth lock")
    p.add_argument("--feature_upsample", type=int, default=1,
                   help="RETIRED — do not use (kept for reproducibility). "
                        "Decodes on an f x finer patch lattice by bilinear "
                        "feature upsample + learned conv refinement; "
                        "adjudicated NEGATIVE twice: default residual init "
                        "scrambles the features (T-045, fixed by zero-init) "
                        "AND with the fix the arm still converges to the "
                        "structureless ~0.34-loss basin (T-045 closure) — "
                        "interpolation adds lattice sites, not information. "
                        "Use --feature_size 74 --encoder_attn_pool 2 for a "
                        "genuinely finer lattice (T-048)")
    p.add_argument("--surface_init", action="store_true",
                   help="Umbrella: start decoder heads at surface-like "
                        "outputs (scale_bias=-2.6, opacity_bias=1.5) — "
                        "the basin the T-023 direct fit succeeds from")
    p.add_argument("--max_per_tile", type=int, default=256,
                   help="Per-tile Gaussian capacity of the training "
                        "rasterizer (the reference's loop is uncapped; "
                        "raise when decoders are in the early large-"
                        "scale regime so occluded splats keep gradients)")
    p.add_argument("--no_augmentation", action="store_true",
                   help="Disable color-jitter augmentation (recommended "
                        "with --distill_weight: teacher color targets are "
                        "fit to the un-jittered images)")
    p.add_argument("--distill_weight", type=float, default=0.0,
                   help="Weight on raw-head regression against per-scene "
                        "fit_teacher.py sidecars (analogue of the "
                        "reference's v2 distillation); experiments 2 and 4")
    p.add_argument("--distill_decay_epochs", type=int, default=0,
                   help="Linearly decay the distill term to 0 over this "
                        "many epochs (0 = constant)")
    p.add_argument("--train_encoder", action="store_true",
                   help="Train a compact image encoder end-to-end with the "
                        "decoder instead of consuming frozen/cached "
                        "features (the no-pretrained-weights answer to "
                        "DINOv2; models/image_encoder.py)")
    p.add_argument("--feature_size", type=int, default=37,
                   help="Feature-grid side. With --train_encoder the "
                        "encoder emits this grid natively from the image — "
                        "a REAL higher-resolution lattice (unlike "
                        "--feature_upsample, which can only interpolate "
                        "the 37x37 information)")
    p.add_argument("--encoder_attn_pool", type=int, default=1,
                   help=">1: encoder attention on a pooled token grid "
                        "(HBM-feasible at feature_size > ~48); conv path "
                        "keeps full resolution")
    p.add_argument("--encoder_width", type=int, default=64,
                   help="Base conv width of the trainable encoder")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="Path to LPIPS weights (.npz or torch ckpt); absent "
                        "-> LPIPS term disabled like the reference's "
                        "availability gating")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p


def configs_from_args(args):
    from fresnel_tpu_torch.train.config import (
        HFGSConfig, HFTSConfig, PhysicsConfig, TrainingConfig)

    # QSR umbrella expansion (reference: 1549-1560).
    if args.use_qsr:
        args.use_phase_output = True
        args.use_wave_rendering = True
        args.use_phase_retrieval_loss = True
        print("=== QSR (Quantum Scene Representation) ENABLED ===")

    # Surface-init umbrella (T-023): start heads in the
    # direct-fit basin instead of the reference's blur-prone init.
    if args.surface_init:
        if args.scale_bias == 0.0:
            args.scale_bias = -2.6
        if args.opacity_bias == 0.0:
            args.opacity_bias = 1.5

    config = TrainingConfig(
        experiment=args.experiment,
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        lr_schedule=args.lr_schedule,
        depth_offset_init=args.depth_offset_init,
        lpips_weight=args.lpips_weight,
        image_size=args.image_size,
        feature_dim=args.feature_dim,
        use_depth_fusion=args.use_depth_fusion,
        depth_feature_dim=args.depth_feature_dim,
        gaussians_per_patch=args.gaussians_per_patch,
        n_spiral_points=args.n_spiral_points,
        use_tensegrity_loss=args.use_tensegrity_loss,
        tensegrity_weight=args.tensegrity_weight,
        nca_steps=args.nca_steps,
        nca_neighbors=args.nca_neighbors,
        nca_step_size=args.nca_step_size,
        max_images=args.max_images,
        use_vlm_guidance=args.use_vlm_guidance,
        vlm_weight=args.vlm_weight,
        use_fresnel_zones=args.use_fresnel_zones,
        num_fresnel_zones=args.num_fresnel_zones,
        boundary_weight=args.boundary_weight,
        learnable_boundary_emphasis=args.learnable_boundary_emphasis,
        use_edge_aware=args.use_edge_aware,
        use_phase_blending=args.use_phase_blending,
        use_phase_output=args.use_phase_output,
        edge_scale_factor=args.edge_scale_factor,
        edge_opacity_boost=args.edge_opacity_boost,
        phase_amplitude=args.phase_amplitude,
        multi_pose_augmentation=args.multi_pose_augmentation,
        use_augmentation=not args.no_augmentation,
        pose_range_elevation=tuple(args.pose_range_elevation),
        pose_range_azimuth=tuple(args.pose_range_azimuth),
        frontal_prob=args.frontal_prob,
        use_pose_encoding=args.use_pose_encoding,
        num_devices=args.num_devices,
        seed=args.seed,
        use_amp=args.use_amp,
        train_encoder=args.train_encoder,
        encoder_width=args.encoder_width,
        feature_size=args.feature_size,
        encoder_attn_pool=args.encoder_attn_pool,
        max_per_tile=args.max_per_tile,
        scale_bias=args.scale_bias,
        opacity_bias=args.opacity_bias,
        distill_weight=args.distill_weight,
        distill_decay_epochs=args.distill_decay_epochs,
        view_weight=args.view_weight,
        depth_z_scale=args.depth_z_scale,
        z_offset_scale=args.z_offset_scale,
        feature_upsample=args.feature_upsample,
    )
    physics = PhysicsConfig(
        use_wave_rendering=args.use_wave_rendering,
        wavelength=args.wavelength,
        learnable_wavelength=args.learnable_wavelength,
        use_physics_zones=args.use_physics_zones,
        focal_depth=args.focal_depth,
        use_diffraction_placement=args.use_diffraction_placement,
        wave_equation_weight=args.wave_equation_weight,
        use_multi_wavelength=args.use_multi_wavelength,
    )
    hfgs = HFGSConfig(
        use_fourier_renderer=args.use_fourier_renderer,
        use_phase_retrieval_loss=args.use_phase_retrieval_loss,
        phase_retrieval_weight=args.phase_retrieval_weight,
        use_frequency_loss=args.use_frequency_loss,
        frequency_loss_weight=args.frequency_loss_weight,
        high_freq_weight=args.high_freq_weight,
        frequency_cutoff=args.frequency_cutoff,
        learnable_wavelengths=args.learnable_wavelengths,
        wavelength_r=args.wavelength_r,
        wavelength_g=args.wavelength_g,
        wavelength_b=args.wavelength_b,
        focal_depth=args.focal_depth,
    )
    hfts = HFTSConfig(
        train_resolution=args.train_resolution,
        progressive_schedule=args.progressive_schedule or args.fast_mode,
        stochastic_k=args.stochastic_k,
        fast_mode=args.fast_mode,
    )
    return config, physics, hfgs, hfts


def main(argv=None):
    args = build_parser().parse_args(argv)
    config, physics, hfgs, hfts = configs_from_args(args)

    from fresnel_tpu_torch.device import resolve_device
    from fresnel_tpu_torch.losses.lpips import load_lpips
    from fresnel_tpu_torch.models.encoders import _probe_weights
    from fresnel_tpu_torch.train.harness import Trainer

    device = resolve_device(args.device)
    lpips_path = args.lpips_weights
    if lpips_path is None:
        lpips_path = _probe_weights(
            ("lpips_alex.pth", "lpips_alex.pt", "lpips_alex.npz",
             "lpips.pth", "lpips.npz"))
    lpips = load_lpips(lpips_path, device=device)
    if lpips is not None:
        print(f"LPIPS weights loaded from {lpips_path}")
    elif config.lpips_weight > 0:
        print("LPIPS weights unavailable -> LPIPS term disabled "
              "(pass --lpips_weights or place lpips_alex.pth under "
              "$FRESNEL_TPU_MODELS or ./models to enable)")
        config.lpips_weight = 0.0

    if args.synthetic:
        from fresnel_tpu_torch.data.dataset import SyntheticGaussianDataset
        dataset = SyntheticGaussianDataset(
            n_samples=args.synthetic_samples, image_size=config.image_size,
            feature_dim=config.feature_dim, seed=config.seed, device=device)
    elif args.streaming:
        from fresnel_tpu_torch.data.streaming import StreamingImageDataset
        dataset = StreamingImageDataset(
            config.data_dir, image_size=config.image_size,
            feature_dim=config.feature_dim,
            use_augmentation=config.use_augmentation,
            max_images=config.max_images, device=device)
    else:
        from fresnel_tpu_torch.data.dataset import ImageDataset
        dataset = ImageDataset(
            config.data_dir, image_size=config.image_size,
            feature_dim=config.feature_dim,
            use_augmentation=config.use_augmentation,
            max_images=config.max_images,
            teacher_experiment=config.experiment, device=device)
    print(f"dataset: {len(dataset)} samples")

    trainer = Trainer(config, physics, hfgs, hfts, lpips=lpips,
                      device=device)

    state = None
    start_epoch = 0
    if args.resume:
        import numpy as np
        first = next(iter(dataset.batches(
            config.batch_size, np.random.default_rng(0))))
        state, epoch = trainer.load_checkpoint(args.resume, first)
        start_epoch = epoch + 1
        print(f"resumed from {args.resume} (epoch {epoch}; "
              f"continuing at {start_epoch})")

    state = trainer.fit(dataset, state=state, start_epoch=start_epoch,
                        stop_epoch=args.stop_epoch)
    print("training complete")
    return trainer, state


if __name__ == "__main__":
    main()
