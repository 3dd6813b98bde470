#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab ROOT [ROOT ...]

The main paths run through the entry points a user calls:
`pipeline.image_to_3dgs` (image -> 3DGS, bench.py's path),
`train.fit_teacher.fit_scene` (`fresnel refine`: per-scene Adam fit through
the rasterizer), `render.tile.render_tiled` / `cli.render` / `cli.orbit`
on a cloud of a million Gaussians (`fresnel render` and `orbit`),
decoder training, `train.harness.Trainer` and its CLI
(`fresnel-torch train`), at the flagship trained model's config, and the
committed trained checkpoints (`results/*.msgpack`) through `cli infer`,
`cli eval` and `cli train --resume`, view-aware for v2combo, and
experiment 4 (the Fibonacci spiral decoder: its teacher fits through
`train.fit_teacher.main` and distilled training through `cli train`) with
the 74^2 decoders, and the CVS consistency view synthesizer (its three
datasets, training through `train.train_cvs.main` at the campaign's full
width in bf16, resume, generation and `inference.cvs_multiview.main` with
its 3DGS fit), the geometric SAAG path (`cli infer --saag` / `--no_model` /
`--html`), the live viewer server (`viewer.serve`: reprocess, /render,
/export.ply), decoder experiments 1, 3 and 5 (`cli train
--experiment`), and DINOv2 and Depth-Anything weights found on disk
(`cli infer`, separate and fused, `cli refine`, the overnight launcher's
training with its Fresnel-zone and edge-aware decoder, the viewer) with
the remaining decoder options, and the wave-optics training routes
(`cli train` with phase blending, the wave-field renderer, QSR, the
physics decoder and experiment 4's Fourier route), bf16 decoder
training (`use_amp`) on every decoder route, the remaining renderers,
the LPIPS term of decoder training (`cli train --lpips_weights`) with
ms_ssim and the matching loss, the overnight launcher's preprocessing,
streamed training, thin checkpoints, the tuners and depth training, and
Fresnel v2 distillation (`train.train_direct_decoder`: the sparse-voxel
decoders on TRELLIS-layout files, with the render loss), `fresnel-torch
smoke`, the binary-protocol bridges and decoder export, and tile sizes
other than 16 (`TileRendererConfig.tile_size` 8 and 32) on the image,
refine, phase-blended and large-cloud render paths.  Phases, each
printing one JSON line; any failure raises and the script exits
non-zero:
   1. device      the card, torch and CUDA versions (CUDA must be present);
   2. build       compile the ten kernels from fresnel_tpu_torch/csrc/
                  into build/ (one nvcc each, run together, sm_90a), with
                  ptxas's registers, shared memory and spills;
   3. kernel      K1 against its plain PyTorch version at the image->3DGS
                  path's shapes (the pack of a decoded 5 476-Gaussian cloud,
                  T = 1024 tiles, M = 256), max abs error <= 1e-5; K1's
                  device time (50 calls back to back behind a sleep that
                  hides the host's time) and its time per call (CUDA
                  events), the plain version's per call;
                  the pack's count distribution, the segment length the
                  kernels choose, the (tile, segment) units, the blocks
                  launched and the bytes of the segment scratch; the
                  bound from the pixel-slot pairs inside the slots' boxes
                  (the rest is exactly 0), the count over all pairs beside
                  it;
   4. main_path   image_to_3dgs at full width (ViT-S/14 x 2 at 518^2 in bf16,
                  decoder K = 4, 512^2 render) over 8 distinct images after
                  warmup, with the launch counts reset just before and read
                  just after;
   5. stages      the median ms of each stage of that path (CUDA events);
   6. reference   that path in float32 on the card and on the CPU, same
                  weights and image: positions within 1e-4, image within a
                  mean absolute error of 1e-4;
   7. profile     torch.profiler over 4 calls of that path;
   8. kernel_bwd  K2 against its plain version at the refine path's shapes
                  (the pack of the full-width refine init: grid 37, K 4,
                  5 476 Gaussians, 256^2, M = 1024) with cotangents from a
                  seed: per field, max abs error <= 1e-4 of that field's
                  largest plain value, bit for bit from run to run; K1 on
                  that pack too, max abs error <= 1e-5, timed as the
                  refine step launches it (leaving the segment prefixes);
                  K2 handed K1's prefixes (as the refine step launches it)
                  and called alone (it recomputes them), bit for bit
                  equal; median times; units; bound;
      kernel_small_m  K1 and K2 against their plain versions on the packs
                  render_tiled makes at M = 32 (N = 20) and M = 96 (N = 70,
                  the m_cap rounding), at the same tolerances, K2 bit for
                  bit run to run;
   9. refine_grad the refine loss and the gradient of {raw, depth_offset} at
                  that init on the card (K1 + K2) against the CPU (plain
                  versions), float32, and the card against itself;
  10. refine_path fit_scene at full width (grid 37, K 4, 256^2, M 1024,
                  lr 1e-2, depth_offset_init -0.13, gradient-fallback depth)
                  on a smooth image from a seed: a warmup call, then one
                  call of 100 timed steps with the launch counts reset just
                  before; K1 launches = steps + 1 and K2 launches = steps,
                  every loss finite, SSIM after the fit above SSIM at the
                  init;
  11. refine_reference  3 steps on the card and on the CPU from the same
                  init: losses within 1e-4 relative, raw within a mean abs
                  difference of 1e-4;
  12. cli         the function under `refine` (cli.refine) at full width for
                  20 steps, writing a PLY to a temporary directory that is
                  read back: 5 476 rows, all finite;
  13. refine_profile  torch.profiler over 5 refine steps;
  14. kernel_table  K3 (the rank table) against its plain version at the
                  render path's full width (a million depth-sorted
                  Gaussians of `test_cloud`, T = 1024 tiles): table and
                  cumulative totals bitwise equal, in one group and in 4
                  (y_offset); K3's device time (50 calls back to back
                  behind a sleep) and its time per call; median times of
                  its plain version and the mask + matmul build
                  (table_build="xla"); bound;
  15. kernel_stream K4 (streaming compaction) against its plain version and
                  against the search binning at the same width, M = 256:
                  tables bitwise equal, two launches equal; device time
                  and time per call of the wrapper (with the interval
                  preparation) and of the launch alone; median times of
                  the plain version and the search binning; the stream
                  positions at which tiles filled; K4's chunks, its open
                  (chunk, tile) pairs and the Gaussians their walks read;
                  bound (from
                  the inputs read once, the tables written and one count
                  per Gaussian and per kept hit, not from this kernel's
                  tile-major scan, whose test count is logged beside it);
  16. binnings_agree  at 200 000 Gaussians all five binnings (search with
                  both table builds and 1 and 4 groups) give the tables of
                  the pair binning, bit for bit;
  17. render_path render_tiled at full width (a million Gaussians, 512^2,
                  M = 256) over 4 distinct clouds after a warmup, under the
                  default config (search binning: K3 + K1) and under
                  binning="stream" (K4 + K1), launch counts reset just
                  before and read just after each; images of the two equal
                  bit for bit, finite, in [0, 1], not all background;
                  overflow telemetry; stage times; K1, and K2 with
                  cotangents from a seed, against their plain versions on
                  this path's pack (T = 1024, M = 256), K2 by both routes;
                  peak device memory;
  18. render_reference  the render at 120 000 Gaussians on the card and on
                  the CPU: tables identical on identical sorted inputs,
                  image within a mean absolute error of 1e-4;
  19. render_cli  cli.render at its defaults (512^2, M = 512) on a
                  million-Gaussian cloud written with core.io.save_binary
                  and read back, and cli.orbit with 8 views at 256^2,
                  launch counts reset just before and read just after;
                  then K3 and K1 against their plain versions at the
                  shapes these two gave them (the 512^2 pose at M = 512:
                  T = 1024; each of the 8 orbit poses at 256^2: T = 256, a
                  16 x 16 grid), K3 bit for bit and K1 within 1e-5, and
                  every image bit for bit against render_tiled with the
                  mask + matmul table build, which launches no K3;
  20. render_profile  torch.profiler over 2 full-width renders;
  21. train_reference  a small training config (64^2, grid 8, encoder width
                  16, K 4, batch 2, M 256, dropout 0) on the card and on the
                  CPU from the same init and batches, 3 steps: losses within
                  1e-4 relative, each parameter leaf's mean absolute
                  difference within 1e-5 (the leaves of zero gradient
                  only logged);
  22. train_path  the flagship config (results/exp2_k8_model.msgpack.json:
                  exp 2, K 8, scale_bias -2.6, opacity_bias 1.5,
                  depth_offset_init -0.128, ImageEncoder 384 / 37 / 64,
                  256^2, M 1024, batch 8, AdamW 2e-4 cosine, weight decay
                  1e-5, loss weights rgb 1 ssim 0.5 depth 0.1 boundary 0.1)
                  on a 16-scene synthetic_corpus (seed 0) with the port's
                  feature caches: 2 warmup steps, then 20 timed steps (CUDA
                  events) with the launch counts reset just before; K1 and
                  K2 once each per step, every loss finite, the mean loss of
                  the last 5 steps below the first 5's; ms per step,
                  images/s, peak memory, overflow telemetry;
      train_kernels  K1 and K2 against their plain versions at the training
                  pack (T = 8 x 256, M = 1024, one launch for the batch),
                  K2 bit for bit run to run and by both routes; times,
                  bounds; the batch's render + backward through the one
                  pack against 8 separate render_tiled calls;
  23. train_profile  torch.profiler over 4 training steps;
  24. train_cli   train_gaussian_decoder.main at the flagship flags on the
                  corpus, one epoch: checkpoint and sidecar written,
                  load_checkpoint bit for bit, encode (8, 37, 37, 384);
  25. ckpt_read   all seven committed Flax msgpack files decoded (leaves,
                  bytes, seconds); exp2, exp2_k8, v2combo and exp2_e74
                  loaded into Trainers on the card; exp2_g74zi
                  (feature_upsample) and exp4 / exp4_budget (experiment 4)
                  raise NotImplementedError naming what is missing;
  26. infer_path  cli infer on one 512^2 image with exp2_k8 and exp2 (host
                  ms per call after a warmup, Gaussians kept), the card's
                  PLY against the CPU's: the same kept count, positions,
                  colours and opacities within 1e-5 of each field's
                  largest value;
  27. eval_path   cli eval of exp2_k8 and exp2 over corpus_v1_eval (24
                  synthetic_corpus scenes, seed 1, 256^2) with the grid,
                  launch counts reset just before and read just after (8
                  K1 per scene and 8 for the grid); every metric and its
                  difference to results/eval_<name>_eval.json; the card
                  against the CPU on the first scene: frontal and
                  per-view SSIM within 1e-4, PSNR within 1e-3 dB, coverage
                  within 2 / S^2 per view;
  28. eval_v2     v2combo over corpus_v2_eval's first 4 scenes (seed 21,
                  raytraced by up to 8 parallel processes) with their GT
                  views: per-view, side-view and novel-view SSIM beside
                  results/eval_v2combo_eval.json; card against CPU as in
                  27;
      (K1 at the eval pack: exp2_k8's first scene from azimuth 90, T 256,
                  M 1024, against its plain version)
  29. resume_path cli train --resume results/exp2_model.msgpack (full:
                  moments and count 6 000) at its sidecar's flags on a
                  16-scene synthetic_corpus, epochs 301-303 (6 steps):
                  K1 and K2 once per step; the first batch's loss at the
                  resumed params below a random init's;
      resume_reference  the loaded full state stepped at a positive
                  learning rate (the Trainer's own 30 000-step cosine, at
                  count 6 000; the CLI's run above, past its 608-step
                  schedule, reads lr 0): exp2's sidecar config at 64^2,
                  batch 2, dropout 0, card against CPU, 3 steps: losses
                  within 1e-4 relative, each params leaf's mean absolute
                  difference within 1e-5, each mu and nu leaf's within
                  1e-2 of the leaf's mean absolute value, the count 6 003
                  on both, and the params moved;
  30. view_train  cli train --resume results/v2combo_model.msgpack (thin)
                  with view_weight 0.5 on the first 4 corpus_v2 scenes at
                  batch 4, 5 steps: K1 and K2 twice per step (the frontal pack
                  and the GT-view pack); then 5 steps timed by CUDA
                  events; every loss finite with a view term;
      kernel_eval_packs  K1 at the eval pack and K1 + K2 at the view pack
                  (4 clouds, each under its GT view's camera) against
                  their plain versions (1e-5; 1e-4 of each field's largest
                  value), with times and bounds;
  31. view_reference  a small view-aware config (64^2, grid 8, encoder
                  width 16, K 4, batch 2, view_weight 0.5, z_offset_scale
                  0.2) on a 2-scene corpus_v2, card against CPU from one
                  init, dropout 0, 3 steps: losses within 1e-4 relative,
                  each held leaf's mean within 1e-5.
      checkpoint_phases  the seconds of each of 25-31 and their total,
                  beside the 90 s they are meant to keep to.
  32. exp4_ckpt   cli infer of exp4 and exp4_budget (377 and 5 476
                  Gaussians decoded), the card's PLY against the CPU's as
                  in 26; cli eval of each over corpus_v1_eval (24 scenes,
                  256^2, M 1024; 8 K1 per scene), frontal SSIM within
                  1e-3 and PSNR within 0.05 dB of the committed
                  results/eval_<name>_eval.json, card against CPU on the
                  first scene as in 27;
  33. upsample_ckpt  the same for exp2_g74zi (feature_upsample 2: 74^2 x
                  K 2, 10 952 Gaussians), and cli eval of exp2_e74 (a
                  74^2 encoder grid);
  34. teacher_fit4  fit_teacher.main --experiment 4 --grid 5476 over the
                  first 8 scenes of the 16-scene training corpus (256^2,
                  M 1024, 50 Adam steps of 800), launch counts reset just
                  before and read just after (51 K1 and 50 K2 per scene):
                  SSIM / PSNR per scene, the depth offsets' spread, ms per
                  step; one scene's 2 steps on the card against the CPU:
                  losses within 1e-4 relative, raw within a mean absolute
                  difference of 1e-4;
  35. distill_train4  cli train --experiment 4 --n_spiral_points 5476
                  --distill_weight 1.0 --distill_decay_epochs 2 at
                  exp4_budget's sidecar config on those 8 scenes with
                  their sidecars (batch 8, 4 epochs: 4 steps, one K1 and
                  one K2 each), the distill term per epoch; 3 more steps
                  timed by CUDA events;
      distill_reference  that config at 64^2, batch 2, dropout 0, 2
                  steps, card against CPU: losses (the distill term
                  included) within 1e-4 relative, each parameter leaf's
                  mean absolute difference within 1e-6;
  36. kernel_exp4_packs  K1 and K2 against their plain versions at the
                  M 384 pack (exp4's first eval scene under the training
                  camera, T 256) and at exp4_budget's training pack (8
                  clouds of 5 476, T 2 048, M 1 024), times and bounds;
  37. exp4_resume_reference  exp4's full state (count 3 000) stepped 2
                  times as in resume_reference, card against CPU.
      exp4_phases  the seconds of each of 32-37 and their total, beside
                  the 60 s they are meant to keep to.
  38. cvs_data    the experiment-2 teachers of the 256^2 training corpus's
                  first 4 scenes (fit_teacher.main, 25 Adam steps of 800:
                  26 K1 and 25 K2 each), then the three CVS datasets at
                  256^2, 4 scenes each: bootstrap clouds (16 K1 at M 256),
                  the teacher clouds' orbit renders (16 K1 at M 1 024) and
                  corpus_v2_eval's raytraced views (no render); seconds
                  and K1 launches; against the same dataset built on the
                  CPU: each view's and target depth's mean absolute
                  difference within 1e-5 (the largest and the count
                  beyond 1e-5 logged: near-equal depths of the teacher
                  surfaces flip compositing order at a few pixels), poses
                  within 1e-6, features within 1e-4 of their largest
                  value;
  39. cvs_reference  the JAX trainer's defaults (64^2, base 64: attention at
                  16 and 8), fp32, quality-aware, concat_input_view, batch
                  2, card against CPU from one init, 2 steps with the same
                  draws: losses within 1e-4 relative, each params and EMA
                  leaf's mean absolute difference within 1e-6 (the
                  attention key bias, whose gradient is zero in exact
                  arithmetic, only logged), mu and nu within 1e-2 of each
                  leaf's mean absolute value; generate with 1 and 4 steps
                  within 1e-4 of the output's largest value;
  40. cvs_train   the campaign's config (256^2, base 128, batch 4,
                  --use_amp, --concat_input_view) on the teacher pairs: 2
                  warmup and 12 timed steps (CUDA events), peak memory,
                  torch.profiler over 3 steps (device ms, busy share,
                  kernels per step), every loss finite; then fp32, 3 timed
                  steps;
  41. cvs_resume  train_cvs.main at that config with --stop_epoch 1, then
                  --resume from its cvs.pt: epochs 2-3 follow with the
                  ramp's weights 0.2 and 0.3;
  42. cvs_generate  one- and 4-step generation at 256^2, batch 1, bf16 and
                  fp32, from the resumed state (median ms of 5); the
                  one-step SSIM / PSNR against the 12 teacher pairs'
                  targets (a sanity number, not a quality claim);
  43. cvs_multiview  cvs_multiview.main with the resumed state: 8 orbit
                  views, then the 3DGS fit of 2 000 Gaussians (50 of 300
                  steps; all 8 views in one pack: one K1 and one K2 per
                  step); the PLY read back (2 000 finite rows); the fit's
                  ms per step (host clock over the fit and the PLY write);
                  card against CPU over 1 step: losses within 1e-4
                  relative;
      kernel_cvs_packs  K1 at the teacher render pack (T 256, M 1 024) and
                  K1 + K2 at the 3DGS fit's pack (8 x 256 tiles, M 256)
                  against their plain versions, with times and bounds.
      cvs_phases  the seconds of each of 38-43 and their total, beside the
                  90 s they are meant to keep to.
  44. saag_reference  to_surface_gaussians at 256^2 (65 536 points x 12
                  static blocks) from the gradient depth of a seeded 512^2
                  image, on the card and on the CPU from the same depth
                  and colour: the point clouds bit for bit; the masks
                  (opacity > 0) compared, each entry active on one side
                  only within 4 ulp of a threshold it is tested against;
                  rotations within 2e-4, every other field within 1e-6;
  45. saag_infer  cli infer --saag --html at the CLI defaults on that PNG:
                  host ms (median of 3 after a warmup), the static
                  (786 432) and live counts, the PLY read back (rows = the
                  live count, all finite), the page's embedded count equal
                  to pack_cloud's, and --no_model (no checkpoint) writing
                  the same PLY bytes;
  46. viewer_serve  viewer.serve's session on the card at its defaults
                  (grid 256, subsample 2) behind make_server on port 0 in a
                  thread: GET / (200, the reprocess panel), POST
                  /reprocess at subsample 1 and 2 (status 200, no
                  "error", the expected counts), GET /render at 1 024^2
                  (200, a PNG not all background; its K3 and K1 launches,
                  host ms median of 3, and render_tiled alone by CUDA
                  events), GET /export.ply read back;
  47. exp135_train  for experiments 1, 3 and 5: cli train at the
                  TrainingConfig defaults (256^2, batch 4, 37^2 x 384
                  patch features, K 4, M 256; 377 points and 16 NCA steps)
                  on an 8-scene synthetic corpus for one epoch (2 steps),
                  then 5 steps timed by CUDA events after 2 warmup steps
                  and 3 under torch.profiler (device ms, busy share,
                  kernels per step): one K1 and one K2 per step, every
                  loss finite; the card
                  against the CPU over 2 steps at 64^2, batch 2, dropout 0
                  (the NCA's masks drawn once on the host): losses within
                  1e-4 relative;
  48. kernel_saag_packs  K1 at the /render pack (T 4 096, M 512) within
                  1e-5 of each field's largest plain value, K3 bit for bit
                  over that cloud's search groups, and K1 / K2 at each
                  experiment's training pack (4 clouds, T 1 024, M 256),
                  with times and bounds.
      saag_phases  the seconds of each of 44-48 and their total, beside
                  the 60 s they are meant to keep to.
  49. backbone_load  DINOv2 ViT-S/14 as an HF-named
                  dinov2_small.safetensors and a facebook-named
                  dinov2_vits14_pretrain.pth, Depth-Anything-V2-Small as an
                  HF-named depth_anything_v2_small.safetensors with a
                  config.json (out_indices [3, 6, 9, 12]), written at the
                  published shapes, random from a numpy seed
                  (models/backbone_files.py; the port's own safetensors
                  writer), each found under FRESNEL_TPU_MODELS and loaded
                  by the factories onto the card: seconds, tensors and
                  parameters per load (every parameter filled);
  50. backbone_reference  features (37^2 x 384) and depth (256^2) of a
                  512^2 image at 518^2, the card against the port on the
                  CPU: float32 within 1e-4 of the largest value; the card's
                  bf16 within twice the CPU's own bf16-vs-float32 gap of
                  the CPU's float32;
  51. infer_backbones  cli infer with both backbones found, separate and
                  --fused_encoder: host ms (median of 3 after a warmup;
                  each call loads both files), kernels and device ms per
                  call (torch.profiler), no K1-K4 launched; the encoders
                  alone on both routes (CUDA events; kernels per call, so
                  the trunk kernels the fused route saves); fused against
                  separate within 1e-5 of the largest value in float32;
  52. refine_backbones  cli refine at its defaults (grid 37, K 4, 256^2, M
                  1 024) with Depth-Anything found, 10 and 60 steps: ms per
                  step from the two calls' difference; K1 = steps + 1 and
                  K2 = steps launches;
  53. train_launcher  cloud/train_overnight.sh's training flags (exp 2,
                  batch 8, 256^2, Fresnel zones, edge-aware, progressive K,
                  100 epochs) through cli train over 8 seeded images,
                  stopped after 3 epochs (one step each, K 1): the caches
                  made by the loaded backbones (equal to their outputs), K1
                  + K2 once per step; 5 steps at K 1 and at K 4 timed by
                  CUDA events, 3 under torch.profiler; K1 / K2 at its pack
                  against their plain versions; the card against the CPU
                  at 64^2, batch 2, dropout 0, 2 steps: losses within 1e-4
                  relative;
  54. decoder_options  cli train for one epoch (2 steps, batch 4, 256^2)
                  with use_phase_output, use_pose_encoding (with
                  multi_pose_augmentation), use_depth_fusion, and
                  experiment 4 with Fresnel zones, phase output and pose
                  encoding: K1 + K2 per step; 3 steps timed; each card
                  against CPU (64^2, batch 2, one step, the same poses)
                  within 1e-4 relative; then /render at 1 024^2 of a viewer
                  session whose depth is Depth-Anything's (K3 + K1).
      backbone_phases  the seconds of each of 49-54 and their total, beside
                  the 90 s they are meant to keep to.
  55. kernel_phase  K1-phi / K2-phi (phase blending) against their plain
                  versions at the pack of --use_phase_blending
                  --use_phase_output (4 decoded clouds of 5 476 with their
                  radian phases, T 1 024, M 256): K1-phi within 1e-5 of
                  each field's largest plain value, K2-phi within 1e-4 per
                  field and bit for bit from run to run; K1 / K2 with the
                  box off (hard_cutoff=False) on that pack; device ms, call
                  ms, plain ms, the plain backward's peak memory, bounds;
                  the pack's largest and median count, the in-box pairs
                  and the share of warp-slots any pixel of the warp is
                  inside; both kernels' registers and blocks per SM from
                  the CUDA runtime; their cosf, sinf and division fast
                  paths bit for bit against the library over their ranges;
  56. kernel_dense  K5 / K6 (the dense splat) at each route's own launch,
                  the inputs its first training step hands dense_splat
                  (QSR: 4 clouds of 5 476 at 256^2, per-RGB phases, WAVE;
                  the physics decoder: 4 clouds, scalar phases, WAVE; exp4's
                  Fourier route: 8 spiral clouds, ISO), each image against
                  the plain versions on that image at the same tolerances,
                  K5 and K6 each bit for bit from run to run; the plain
                  backward's peak memory; kernels and plain versions timed
                  over the whole batch, with their bounds and the
                  Gaussians' reach.  Phases 59-61 repeat this check
                  (`dense_at_profile`) at the clouds of the state each
                  route's profile starts from, where the reach is widest;
  57. train_sh_full  cloud/train.sh full's flags (phase blending without
                  phase output renders plain: K1 + K2 per step);
  58. phase_train  --use_fourier_renderer --use_phase_output (amplitude
                  0.3) and --use_phase_blending --use_phase_output (0.25):
                  K1-phi + K2-phi per step;
  59. qsr_train   --use_qsr (per-RGB phases, the wave-field renderer):
                  K5 + K6 per step;
  60. physics_train  --use_wave_rendering --learnable_wavelength
                  --use_diffraction_placement (PhysicsDirectPatchDecoder):
                  K5 + K6 per step; its checkpoint through
                  trainer_from_checkpoint and cli infer;
  61. exp4_fourier  --experiment 4 --use_phase_blending at exp4_budget's
                  sidecar config (5 476 spiral points, batch 8): the
                  Fourier renderer's spatial mode, K5 + K6 per step.
                  Each of 57-61: cli train for one epoch over an 8-scene
                  corpus at the TrainingConfig defaults (256^2, batch 4,
                  37^2 x 384 features, K 4, M 256) unless a flag says
                  otherwise, then 3 steps timed by CUDA events after 2
                  warmup steps and 2 under torch.profiler; the expected
                  launches of all eight kernels per step, every loss
                  finite; the card against the CPU at 64^2, batch 2,
                  dropout 0, 2 steps: every loss term within 1e-4
                  relative, the physics decoder's wavelength_raw within
                  1e-5 relative;
  62. wave_phases  the seconds of each of 55-61 and their total, beside a
                  90 s cap.
  63. amp_reference  bf16 decoder training (`use_amp`): train_reference's
                  small config with use_amp, 3 steps from one init on the
                  card (cuBLAS's bf16 reduced-precision reduction at
                  torch's default, and off) and on the CPU, and on the
                  CPU in float32: the card's loss at each step within 2 x
                  the CPU's own bf16-against-float32 difference (floored
                  at 1e-4 of the loss; each term's ratio logged: the
                  encoder's bf16 roundings part the card's from the
                  CPU's as they part the CPU's from JAX's), the
                  parameters' mean absolute difference within 2 x the
                  CPU's own;
  64. amp_train   the flagship config (train_path's) in float32 and in bf16
                  on the same 8-scene corpus and batches: 2 warmup and 10
                  steps timed by CUDA events, 3 under torch.profiler
                  (device ms, busy share, kernels per step), peak memory,
                  K1 and K2 once each per step; the encoder's and the
                  decoder's forward and backward alone on one batch
                  (device ms and kernels by torch.profiler); the bf16
                  loss and gradient of one batch with cuBLAS's bf16
                  reduced-precision reduction on and off, beside the
                  float32 loss and gradient there;
  65. amp_routes  one bf16 step on the card of experiments 1, 3, 4 and 5,
                  the physics decoder (K5 + K6 WAVE) and phase blending
                  (K1-phi + K2-phi) at 64^2, batch 2, dropout 0, each
                  loss term against the CPU's bf16 step as 63 holds the
                  loss;
  66. amp_phases  the seconds of each of 63-65 and their total, beside a
                  60 s cap.
  67. kernel_dense_composite  K7 / K8 in DENSE and SIMPLE mode at the
                  image->3DGS path's decoded cloud (5 476 Gaussians) at
                  256^2 and 512^2 (the renderers' launch) against their
                  plain versions (K8's over bands of rows of at most
                  256^2 pixels, summed): errors, device ms, bounds, plain
                  ms and peak memory, the (tile, Gaussian) entries the
                  lists hold and the bytes of K7's checkpoints and
                  scratch, both kernels' registers, local (spill) bytes
                  and blocks per SM (ptxas's lines are in phase 2);
  68. renderers   make_renderer("dense" | "simplified" | "asm" |
                  "fourier_true") on that cloud at 512^2, forward and the
                  backward of a mean loss: finite outputs and gradients,
                  the K5-K8 launches each should make, ms per render,
                  device ms and peak memory; dense against
                  render_tiled(hard_cutoff=False);
  69. renderers_reference  each renderer and both diffractive layers on
                  the card against the CPU (300 Gaussians, 96^2);
  70. depth_sorts "counting" (10^6 Gaussians) and "packed" (2^20) on the
                  card against the CPU's permutation, bit for bit, and a
                  render_tiled with each; then the seconds of 67-70
                  beside a 60 s cap.
  71. lpips_module  lpips-alex files at the published shapes, random from
                  a seed (models/backbone_files.py), in the lpips
                  package's naming, torchvision's and as an .npz of Flax
                  names, each loaded by losses.lpips.load_lpips onto the
                  card (float32, frozen; the three equal); the distance
                  and its gradients with respect to both images at 128^2,
                  batch 8, against the CPU: within 1e-5 relative and 1e-4
                  of the largest gradient entry; ms forward and forward +
                  backward, device ms and kernels;
  72. lpips_train  cli train at the flagship flags over an 8-scene corpus
                  with --lpips_weights (weight 0.1), 2 epochs, in float32
                  and with --use_amp: the CLI's message, one K1 and one K2
                  per step, the term in the history and the sidecar;
                  train_reference's small config with the term, 2 steps
                  from one init, card against CPU: lpips and total within
                  1e-4 relative in float32 at both steps, and in bf16 at
                  step 1 within 2 x the CPU's own bf16 gap (step 2's
                  ratio logged); the flagship step with the term on
                  and off, float32 and bf16, in turns (off, on, on, off)
                  on the same batches: ms per step, host ms, device ms,
                  busy share, kernels per step and K1 / K2 launches per
                  step (one each, on and off);
  73. ms_ssim_matching  ms_ssim at 256^2 and 128^2 (batch 8) within 1e-5
                  of the CPU's, with its ms; gaussian_matching_loss at
                  its default max_match_points (batch 4, 5 476 predictions
                  and 16 384 targets, padded and masked, subsampled to
                  4 096 and 8 192), every output within 1e-5 relative of
                  the CPU's, its ms and peak memory;
  74. lpips_phases  the seconds of 71-73 beside a 75 s cap.
  75. overnight   cloud/train_overnight.sh's three steps on a seeded
                  folder of 16 images: data.preprocess with DINOv2 ViT-S/14
                  and Depth-Anything-V2-Small files at the published
                  shapes (random from a seed) at 518^2 on the card, the
                  caches' names and sizes, 2 images against the CPU
                  (card bf16 within 2 x the CPU's bf16 gap of its
                  float32); the launcher's training flags cut to 2 epochs,
                  with and without --streaming in turns (memory,
                  streaming, streaming, memory): first-epoch losses within
                  1e-6 relative, one K1 and one K2 per step; per turn one
                  profiled epoch: ms per step, device ms, busy share,
                  kernels per step and the host ms waiting for each batch;
                  cli eval --max_images 8 on the best checkpoint;
  76. thin_ckpt   train.thin_ckpt of the run's final_model.pt (its size
                  ratio), a resume of one epoch from the thin file (fresh
                  optimizer state, step from the sidecar); a committed
                  full Flax checkpoint thinned, loaded (bf16 roundings of
                  the full params) and decoded;
  77. tuners      auto_tune and hyperparam_search --synthetic at their CLI
                  defaults, 2 trials of 1 epoch: seconds, scores, K1 / K2
                  launches;
  78. depth_train train_depth --synthetic at its defaults (128^2, base 32,
                  batch 8, 64 samples) for 2 epochs; ms per step; 3 steps
                  on the card each from the CPU's state (parameters and
                  Adam's moments): losses within 1e-5 relative, updated
                  parameters within 1e-6 by mean (the output bias, whose
                  gradient is rounding noise, within 2 x lr; the
                  free-running 3 steps from one init logged beside them);
  79. render_stats  utils.profiling.render_with_stats at the large-cloud
                  render configuration (10^6 Gaussians, 512^2, M 256) with
                  "search" and "stream" binning: stage ms, counts, the
                  overflow integers equal to render_tiled's, K3 / K4 and
                  K1 launches; `trace` writes a Chrome trace with the
                  card's kernels;
  80. item10_phases  the seconds of 75-79 beside a 150 s cap (over it
                  fails).
  81. slat_reference  the v2 models at V2Config's full width (features
                  1 024 over 1 369 patches, hidden 512, 6 blocks of 8
                  heads, 8 Gaussians per voxel, 4 096 voxels, batch 2;
                  random weights from a seed): DirectSLatDecoder in
                  float32 with TF32 off, MLPSLatDecoder, and
                  DirectStructurePredictor at resolution 64, hidden 256,
                  on the card against the same weights on the CPU, one
                  cloud (within 1e-4); DirectSLatDecoder in bf16 on one
                  cloud of 2 048 voxels within 2 x the CPU's own bf16 gap;
                  occupancy_to_coords equal on both devices, also with
                  saturated ties; forward ms;
  82. v2_train   V2Trainer at full width (max_gaussians 16 384,
                  max_match_points 4 096) on two samples written in the
                  TRELLIS layout (features.pt, coords.pt, gaussians.ply,
                  filling max_coords and max_gaussians) and read by
                  TrellisDistillationDataset: float32 and bf16, each with
                  and without the render loss, and the two render routes
                  with use_checkpoint; per route 1 warmup and 3 timed
                  steps (ms, host ms, peak memory above the resident, K1
                  / K2 launches per step: 2 / 1 with the render loss, 0 /
                  0 without), 2 under torch.profiler for the four routes
                  without the checkpoint (device ms, busy share,
                  kernels); every loss finite; then K1 / K2 against
                  their plain versions at the step's two render packs
                  (T 128, M 256: the predictions with K2, the teachers);
  83. v2_cli     train_direct_decoder.main --synthetic --epochs 2, and
                  --data_dir on those files with --use_checkpoint
                  --use_render_loss: the checkpoints, sidecars and
                  history written, K1 / K2 launches; final_v2.pt loaded
                  and one more step taken;
  84. v2_reference  two render-loss steps at a small config (features
                  64, hidden 64, 2 blocks, K 4, 256 voxels, 1 024
                  Gaussians, dropout 0) on the card and on the CPU from
                  one init: losses within 1e-4 relative, params within
                  1e-5 by mean, K1 / K2 2 / 1 per step; then the seconds
                  of 81-84 beside a 90 s cap.
  85. smoke      `fresnel-torch smoke` (cli.main): the devices, the two
                  compute round trips and K1 once against its plain
                  version; exit 0, one K1 launch;
  86. bridges    the four bridge commands as the C++ viewer runs them, a
                  `python -m fresnel_tpu_torch.inference.bridges` process
                  each on the card, five at once (dinov2, depth, decoder
                  with results/exp2_model.msgpack and without a
                  checkpoint, test_novel_views with exp2_k8 at 8 views of
                  256^2), against the same commands on the CPU in this
                  process: features within 3e-5, depth 1e-6, Gaussians
                  1e-5 of each field's largest value (quaternions up to
                  sign), each view's mean and coverage 1e-4, the same
                  lines, verdict and PNG names; test_novel_views again in
                  this process on the card for its K1 launches (one a
                  view); seconds per command on each side;
  87. export     export_decoder.main on the card for the seven committed
                  decoders (npz and the traced module, each verified
                  against its eager decoder), each file loaded with
                  map_location="cpu" and held against the CPU's eager
                  decoder within 1e-5 of each field's largest value;
                  seconds per checkpoint;
  88. item11_phases  the seconds of 85-87 beside a 45 s cap (over it
                  fails).
  89. tile_size_image  the image->3DGS path's decoded cloud (5 476
                  Gaussians) through render_tiled at 512^2 with tile_size
                  8 and 32, the launch counts reset just before and read
                  just after: a render without a gradient, one with its
                  gradient (K1 2, K2 1) and a phase-blended one with
                  phases from a seed and its gradient (K1-phi 1, K2-phi
                  1); every output finite, the image within a mean
                  absolute difference of 1e-5 of the CPU's render at the
                  same size; K1 against its plain version at the image's
                  pack of that size (1e-5), device ms, plain ms, bound;
  90. tile_size_refine  a refine step at full width (render_raw at the
                  REFINE init, photometric_loss, backward) at 8 and 32 on
                  the card (K1 1, K2 1) and on the CPU: losses within 1e-5
                  relative; K1 / K2 against their plain versions at the
                  init's pack (K2 per field 1e-4, bit for bit run to run),
                  times and bounds;
  91. tile_size_phase  K1-phi / K2-phi against their plain versions on
                  PHASE_AB binned into tiles of 8 and 32 (1e-5 / 1e-4
                  per field, K2-phi bit for bit run to run), device ms,
                  plain ms, bounds, residency;
  92. tile_size_render  render_tiled on a million Gaussians at 512^2, M
                  256, with binning "search" (K3 once per tile-row group,
                  K1) and "stream" (K4, K1) at 8 and 32, the counts reset
                  just before and read just after; K3's tables (every
                  group) and K4's against their plain versions bit for
                  bit; K3 / K4 device ms (one group; K4's launch alone),
                  plain ms, bounds; K1 / K2 at the render pack of each
                  size against their plain versions;
  93. item5_phases  the seconds of 89-92 beside a 45 s cap (over it
                  fails).
  94. parallel_train  parallel/ on torch.distributed: two gloo ranks on
                  card 0, started once for phases 94, 96 and 97
                  (parallel.launch.run_job; NCCL refuses two ranks on one
                  card), run Trainer.fit(mesh=...) at the flagship config
                  (global batch 8, 4 a rank, dropout on) for 3 steps,
                  and Trainer.gradients of the first batch at the init;
                  against the same in one process on the card from the
                  same seeds (the fit twice): the first step's loss within
                  1e-4 relative, the gradient 1e-3 by its global norm and
                  the later losses 1e-3 (the constants say why),
                  the ranks' parameters bit for bit equal (sha256); leaf
                  mean gaps, ms per step of both, the all-reduce's calls,
                  bytes and ms (gloo goes through host copies), K1 / K2
                  launches per rank (one each a step);
  95. parallel_nccl  the same fit at world size 1 over NCCL against the
                  single-process fit: losses within 1e-5 relative, leaf
                  means 1e-6 (the card's fit is not bit for bit run to
                  run), ms per step beside it; `train_gaussian_decoder --num_devices 2`
                  on a one-card machine raises ValueError;
  96. parallel_render  the three sharded renders on the two ranks against
                  render_tiled in this process: batch-sharded (two decoded
                  clouds, 512^2, 1e-5), Gaussian-sharded (the first
                  depth-sorted, capacity for every tile's list, no pair
                  dropped, 2e-3), pixel-sharded (the 10^6 cloud at 512^2,
                  M 256, search and stream binning: K3 / K4 on each band,
                  2e-3); the ranks' images bit for bit equal; ms per call;
  97. parallel_tp  shard_state over a (1, 2) ("data", "model") mesh:
                  tests/test_parallel.py's network (64 -> 256 -> 8), its
                  loss and gradient within 1e-5 of the replicated step's;
                  the sharded fraction of the flagship Trainer state; then
                  the seconds of 94-97 beside a 90 s cap (over it fails).
Then the card's name and power limit as nvidia-smi gives them, the kernel
table as one JSON line, and as the last line {"ok": true, "device": {...}}.

With `--ab`, each ROOT is a checkout of this repository (a parent commit
unpacked with `git archive` into a git-ignored directory, or `.`), given
in turns (`.archive/parent . . .archive/parent`) so that drift on the card
shows.  For each root in order, a subprocess imports that checkout's
`fresnel_tpu_torch` (building its ten kernels into its `build/`),
builds this script's image, refine and render packs with it, and times
through the functions every version has: K1 at all three, K2 with
cotangents from a seed and K1 + K2 through autograd (a refine step's pair)
at the refine and render packs, with the sha256 of K1's and K2's outputs
(the same bits in every version); K3 (`build_rank_table`), K4
(`bin_gaussians_stream`) and K4's launch alone (`_launch`) on the render
path's million depth-sorted Gaussians; K5 and K6 (`splat._launch_fwd` /
`_launch_bwd`, whose signatures every version of the dense splat keeps)
on seeded synthetic clouds (DENSE_AB: 8 ISO clouds of 5 476 at 256^2
whose reach matches experiment 4's at its profiled state, 4 WAVE clouds
with the box at the 64-px cap); K1-phi and K2-phi
(`raster._launch_fwd_phase` / `_launch_bwd_phase`, which every version
of the phase kernels has) on a seeded synthetic pack at the
phase-blended training pack's shape and near its statistics (PHASE_AB:
T 1 024, M 256, 103.4 slots per tile, median 15, 334 tiles at the cap,
radian phases), with their bounds, the sha256 of their outputs and,
where the checkout has it, their residency; K7 and K8
(`dense_composite._launch_fwd` / `_launch_bwd`, whose signatures every
version keeps) on the image's decoded cloud in DENSE and SIMPLE mode at
256^2 and 512^2 with cotangents from a seed, with their bounds, the
sha256 of K7's outputs and, where the checkout has it, their residency.
Each as `ms` on the device, `call_ms` per call and the device ms of each
kernel by name (torch.profiler; not for K7 / K8), with ptxas's
registers and spills of those ten kernels;
K1 (image pack), K2 (refine pack), K1-phi and K2-phi (PHASE_AB) at tile
sizes 8 and 32, where the checkout's kernels take a tile size;
and the refine step at full width (`fit_scene`: ms per step over 20
steps, device ms per step and top kernels over 5); and the
train_sh_full route's step (its flags, corpus and batch as phase 57
builds them: ms per step over AB_TRAIN_STEPS steps, host ms, device ms,
busy share and kernels per step); one JSON line per root.

Imports torch, numpy and fresnel_tpu_torch only.
"""

import contextlib
import dataclasses
import hashlib
import inspect
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 8
N_TIMED = 30
# ~20 ms of device sleep at the H100's clocks: longer than the host takes to
# queue 50 calls of a compositing kernel's wrapper.
SLEEP_CYCLES = 40_000_000
KERNEL_TOL = 1e-5
# K2 per field, relative to the field's largest plain value: the kernel and
# the plain version differ in summation order only (sequential suffix sums
# from each segment's prefix and a shuffle tree against cumsum and
# torch.sum), in float32.
KERNEL_BWD_TOL = 1e-4
REF_POS_TOL = 1e-4
REF_IMG_MEAN_TOL = 1e-4
# Refine gradient, card against CPU, relative to each gradient's largest
# entry: projection rounds differently on the card (fused multiply-adds),
# and summation orders differ in the compositor and the gather's backward.
REFINE_GRAD_TOL = 1e-3
REFINE_LOSS_RTOL = 1e-5
# Refine trajectories: Adam's first steps are ~lr * sign(g), so a raw entry
# whose gradient sits near zero can step +-lr on one side only; held by the
# losses and the mean abs difference of raw.
REF_LOSS_RTOL = 1e-4
REF_RAW_MEAN_TOL = 1e-4
# train_reference: each parameter leaf's mean absolute card-CPU difference
# after 3 steps (one Adam step moves an entry by about lr = 2e-4), except
# the leaves whose gradient is zero in exact arithmetic, which step on
# rounding noise of either sign (tests/test_torch_trainer.py names them).
REF_PARAM_MEAN_TOL = 1e-5
REF_ZERO_GRAD = r"res\.\d\.conv1\.bias|attn\.k\.bias"
REFINE = dict(grid=37, K=4, res=256, max_per_tile=1024, lr=1e-2,
              depth_offset_init=-0.13)
REFINE_STEPS = 100
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores.  The data sheet gives no rate for 32-bit integer
# arithmetic; the integer kernels K3 and K4 are held to the float32 rate,
# which the integer units do not exceed, so their bounds stay lower bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# One pixel-Gaussian evaluation in K1: offsets, quadratic form, box test,
# alpha, weights, four sums and the transmittance update (~20 FLOP) and one
# exp.  Counted for the pixels inside the slot's box only: outside it every
# term is exactly 0.
OPS_PER_EVAL = 21
# One pixel-slot evaluation in K2 (counted from csrc/raster_bwd.cu): K1's
# alpha (~17), the weight and four suffix updates (9), the clamp and
# reciprocal (3), dalpha (~23 with its gate), the chain into ten gradient
# terms (~26), the transmittance update (2) and ten adds of the reduction
# over the tile's pixels (10).
OPS_PER_EVAL_BWD = 90
# Per slot of a tile, the pixels its box covers: mx +- r, my +- r, each
# rounded to a pixel.
OPS_PER_SLOT_BOX = 8
PACK_BYTES = 12 * 4
PIX_F = 256             # pixels per tile
FIELDS = ("positions", "scales", "rotations", "colors", "opacities")
# The render path at full width: the configuration of the JAX package's
# experiments/bench_stream_binning.py.
RENDER = dict(n=1_000_000, res=512, max_per_tile=256, spread=0.8,
              z_offset=-2.0, scale=0.02)
RENDER_CLOUDS = 4
AGREE_N = 200_000
RENDER_REF_N = 120_000
# The flagship trained model, results/exp2_k8_model.msgpack.json: exp 2,
# K 8, surface-init head biases, depth_offset_init -0.128, the jointly
# trained ImageEncoder (feature_dim 384, grid 37, width 64, attn_pool 1),
# 256^2, max_per_tile 1024, batch 8, AdamW lr 2e-4 cosine over 300 epochs,
# weight decay 1e-5, loss weights rgb 1, ssim 0.5, depth 0.1, boundary 0.1,
# no augmentation, its HFGS terms off.
TRAIN = dict(experiment=2, gaussians_per_patch=8, scale_bias=-2.6,
             opacity_bias=1.5, depth_offset_init=-0.128, train_encoder=True,
             feature_dim=384, feature_size=37, encoder_width=64,
             image_size=256, max_per_tile=1024, batch_size=8, epochs=300,
             lr=2e-4, weight_decay=1e-5, rgb_weight=1.0, ssim_weight=0.5,
             depth_weight=0.1, boundary_weight=0.1, lpips_weight=0.0,
             use_augmentation=False, seed=0)
TRAIN_HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
                  learnable_wavelengths=False)
TRAIN_SCENES = 16
TRAIN_WARMUP, TRAIN_STEPS = 2, 20
# train_reference: a small config on the card and on the CPU.
TRAIN_REF = dict(TRAIN, image_size=64, feature_size=8, encoder_width=16,
                 gaussians_per_patch=4, max_per_tile=256, batch_size=2)
TRAIN_REF_STEPS = 3
# Small packs: M = 32 (render_tiled at N <= 32) and M = 96 (N = 70, the
# m_cap rounding to a multiple of 32).
SMALL_M = ((20, 32), (70, 96))
# One (tile, Gaussian) entry of K3, one Gaussian read by K4 and one hit it
# keeps: four integer compares and one count.
OPS_PER_TEST = 5


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def cuda_median_ms(torch, fn, n=N_TIMED, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(torch, fn, n=50, reps=5):
    """Device ms of one call of fn: n calls back to back behind a sleep that
    keeps the card busy while the host queues them, so the host's time per
    call (Python, allocation, launch) is hidden; the median over `reps`
    such runs.  Also whether the host finished queueing before the sleep
    ended in every run (else the host's time leaks in)."""
    fn()
    torch.cuda.synchronize()
    per_call, hidden = [], True
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(SLEEP_CYCLES)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        hidden &= host_ms < ev[0].elapsed_time(ev[1])
        per_call.append(ev[1].elapsed_time(ev[2]) / n)
    return statistics.median(per_call), hidden


def ptxas_lines(log_text):
    """ptxas's registers and spill lines, one per kernel entry, from nvcc's
    -Xptxas -v output (the entry's mangled name beside them)."""
    out, entry = [], ""
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "registers" in ln or "spill" in ln:
            out.append(f"{entry}: {ln.split('info    : ')[-1].strip()}")
    return out


def kernel_times(torch, fn, n=50):
    """A kernel's time two ways: `ms` on the device (device_ms over n calls;
    fewer where the host's time per call is large, so the sleep still
    hides it) and `call_ms`, CUDA events around each call
    (cuda_median_ms), which holds the host's time per call whenever that
    exceeds the kernel's."""
    ms, hidden = device_ms(torch, fn, n=n)
    return dict(ms=ms, call_ms=cuda_median_ms(torch, fn),
                host_time_hidden=hidden)


def bound(bytes_moved, ops):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            dict(bytes=bytes_moved, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms))


def smooth_image(size, seed):
    """(3, size, size) float32 in [0, 1]: low-frequency waves and a few
    discs, a scene with edges and flat regions (not white noise)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.empty((3, size, size))
    for c in range(3):
        fx, fy, ph = rng.uniform(1, 3), rng.uniform(1, 3), rng.uniform(0, 6)
        img[c] = 0.5 + 0.3 * np.sin(2 * np.pi * fx * x + ph) * np.cos(
            2 * np.pi * fy * y)
    for _ in range(4):
        cx, cy, r = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), \
            rng.uniform(0.06, 0.18)
        img[:, (x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 1, (3, 1))
    return np.clip(img, 0, 1).astype(np.float32)


def profile_ms(torch, fn, n, top=8, cpu=True):
    """torch.profiler over fn(): wall ms, device ms, kernels and the `top`
    kernels by device time, each per unit of n.  cpu=False traces the
    device alone, which keeps the profiler's own summary of a step's
    thousands of host-side operators out of the phase's seconds (none of
    these numbers reads them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CPU] if cpu else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # Kernel names are cut to 80 characters, so sum the ones that collide.
    by_name = {}
    for e in kernels:
        by_name[e.key[:80]] = (by_name.get(e.key[:80], 0.0)
                               + e.self_device_time_total / 1e3 / n)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(wall_ms=wall_ms / n, device_ms=device_ms / n,
                indexing_backward_ms=sum(v for k, v in ranked
                                         if "indexing_backward" in k),
                device_busy_share=device_ms / wall_ms if device_ms else None,
                kernels=sum(e.count for e in kernels) / n,
                top_kernels_ms=dict(ranked[:top]))


def reset_counts(raster, binning, stream_binning):
    """Every launch counter to 0: K1-K4 here, and the wave-optics kernels'
    (K1-phi, K2-phi, K5, K6; read by read_all_counts) and the dense
    compositing pair's (K7, K8; read by renderer_counts) with them."""
    from fresnel_tpu_torch.render import dense_composite, splat

    raster.launches = raster.launches_bwd = 0
    binning.launches = stream_binning.launches = 0
    raster.launches_phase = raster.launches_phase_bwd = 0
    splat.launches = splat.launches_bwd = 0
    dense_composite.launches = dense_composite.launches_bwd = 0


def read_counts(raster, binning, stream_binning):
    return dict(k1=raster.launches, k2=raster.launches_bwd,
                k3=binning.launches, k4=stream_binning.launches)


def max_abs_diff(torch, a, b, rows=64):
    """max |a - b| of two large 2-D tensors, in float32, a slab at a time."""
    worst = 0.0
    for r in range(0, a.shape[0], rows):
        worst = max(worst, (a[r:r + rows].float()
                            - b[r:r + rows].float()).abs().max().item())
    return worst


def pack_stats(torch, raster, pack, counts, ntx, tiles_per_image=None,
               tile_size=16):
    """A pack's count distribution, the (tile, segment) units K1 and K2 run
    for it (the segment length L they choose, the units, the blocks
    launched, the tiles that need a fold, the heaviest unit's slots, the
    scratch bytes) and the pixel-slot pairs inside the slots' boxes (the
    rest K1 skips, and K2 where a whole warp is outside), at tile size
    `tile_size` (a checkout before it took one is asked at 16 only)."""
    T, M = pack.shape[:2]
    ts, P = tile_size, tile_size * tile_size
    ti = T if tiles_per_image is None else tiles_per_image
    size_arg = () if ts == 16 else (ts,)
    resident = raster.resident_blocks(pack.device.index, *size_arg)
    L = raster.segment_length(counts, M, resident)
    c = counts.long()
    pix = torch.arange(P, device=pack.device)
    pairs_in = warps_in = 0
    for t0 in range(0, T, 64):
        t = torch.arange(t0, min(T, t0 + 64),
                         device=pack.device)[:, None] % ti
        g = pack[t0:t0 + 64]
        r = g[..., 5, None]
        px = (t % ntx * ts + pix % ts).float()[:, None, :]
        py = (t // ntx * ts + pix // ts).float()[:, None, :]
        inside = (((px - g[..., 0, None]).abs() <= r)
                  & ((py - g[..., 1, None]).abs() <= r)
                  & (torch.arange(M, device=pack.device)
                     < counts[t0:t0 + 64, None])[..., None])
        pairs_in += int(inside.sum().item())
        warps_in += int(inside.view(*inside.shape[:2], -1, 32).any(-1).sum()
                        .item())
    occupied = max(1, int(c.sum().item()))
    n_seg = (c + L - 1) // L
    return dict(counts_max=int(c.max().item()),
                counts_median=c.float().median().item(),
                counts_p99=torch.quantile(c.float(), 0.99).item(),
                tiles_at_cap=int((c == M).sum().item()), seg=raster.SEG,
                segment_length=L, units=int(n_seg.sum().item()),
                blocks_launched=min(max(resident, T),
                                    T * max(1, -(-M // raster.SEG))),
                merged_tiles=int((n_seg > 1).sum().item()),
                heaviest_unit_slots=min(int(c.max().item()), L),
                scratch_bytes=(math.prod(raster.scratch_shape(
                    T, M, *size_arg)) * 4 + T * 4),
                box_pixel_pairs=pairs_in,
                box_pixel_share=pairs_in / (occupied * P),
                box_warp_share=warps_in / (occupied * P / 32))


def compositing_bounds(stats, T, M, occupied, names=("k1", "k2"),
                       ops=(OPS_PER_EVAL, OPS_PER_EVAL_BWD), bwd_pix=10,
                       carry_bytes=0, pix=PIX_F):
    """The bounds of K1 and K2 on a pack of `pix` pixels a tile (or, with
    their `names`, `ops` per pair, the backward's floats read per pixel
    and the bytes of the carry between them, K1-phi and K2-phi):
    the bytes the function moves and the operations it does on the
    pixel-slot pairs inside the slots' boxes (plus each slot's box),
    beside the count over all pairs (`all_pairs_ops`: every pair, as if no
    term were 0)."""
    box_ops = occupied * OPS_PER_SLOT_BOX
    out = {}
    for name, per_pair, bytes_moved in (
            (names[0], ops[0],
             occupied * PACK_BYTES + T * 4 + T * pix * 5 * 4
             + carry_bytes),
            (names[1], ops[1],
             occupied * PACK_BYTES + T * 4 + T * pix * bwd_pix * 4
             + T * M * PACK_BYTES + carry_bytes)):
        ms, by, work = bound(bytes_moved,
                             stats["box_pixel_pairs"] * per_pair + box_ops)
        all_pairs = occupied * pix * per_pair
        out[name] = dict(**work, bound_ms=ms, bound_by=by,
                         all_pairs_ops=all_pairs,
                         all_pairs_bound_ms=bound(bytes_moved, all_pairs)[0])
    return out


def k2_routes(torch, raster, pack, counts, ntx, fwd, cots):
    """K2 handed K1's segment prefixes (as the refine step launches it) and
    called alone (it recomputes them): whether both give the same bits, and
    each one's times."""
    with torch.no_grad():
        prefix = raster._launch_fwd(pack, counts, ntx, keep_prefix=True)[3]
        alone = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots)
        handed = raster._launch_bwd(pack, counts, ntx, *fwd, *cots,
                                    prefix=prefix)
        return dict(routes_bitwise_equal=bool(torch.equal(alone, handed)),
                    handed=kernel_times(torch, lambda: raster._launch_bwd(
                        pack, counts, ntx, *fwd, *cots, prefix=prefix)),
                    alone=kernel_times(
                        torch, lambda: raster.composite_tiles_bwd(
                            pack, counts, ntx, *fwd, *cots)))


BWD_FIELDS = ("mx", "my", "ca", "cb", "cc", "radius", "R", "G", "B",
              "opacity", "depth", "pad")


def bwd_errors(got, ref):
    """Per field of K2's gradient: max abs error, the plain version's
    largest value, and their ratio (the error the tolerance holds)."""
    scale = {f: ref[..., i].abs().max().item()
             for i, f in enumerate(BWD_FIELDS)}
    err = {f: (got[..., i] - ref[..., i]).abs().max().item()
           for i, f in enumerate(BWD_FIELDS)}
    rel = {f: err[f] / scale[f] if scale[f] else err[f] for f in BWD_FIELDS}
    return err, scale, rel


def tables_equal(torch, a, b):
    """Two (tile_indices, tile_valid) tables: same validity, same live
    entries, and the same dead entries (index 0)."""
    (ai, av), (bi, bv) = a, b
    return bool(torch.equal(av, bv)
                and torch.equal(torch.where(av, ai, -1),
                                torch.where(bv, bi, -1))
                and torch.equal(ai, bi))


def fields(cloud):
    return tuple(getattr(cloud, k) for k in FIELDS)


def render_cloud(seed, count=RENDER["n"]):
    """A cloud of the render path's configuration, on the CPU."""
    from fresnel_tpu_torch.core.gaussians import GaussianCloud

    return GaussianCloud.test_cloud(
        count, seed=seed, spread=RENDER["spread"],
        z_offset=RENDER["z_offset"], scale=RENDER["scale"])


def decoded_pack(torch, models, image):
    """The image->3DGS path's TilePack of one image (the decoded cloud under
    the path's camera), and the number of decoded Gaussians."""
    from fresnel_tpu_torch import pipeline
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import tile

    with torch.no_grad():
        x = pipeline.resize_to_model(image)
        out = models.decoder(models.dino(x), models.depth(x))
        tp = tile.pack_tiles(*[out[k][0] for k in FIELDS],
                             Camera.default_training(pipeline.RENDER_SIZE))
    return tp, int(out["positions"].shape[1])


def refine_init(torch, dev):
    """The refine path at full width from seed 0: (scene, depth, camera,
    config, the initial raw parameters, the init's TilePack)."""
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.models.decoders import head_transform
    from fresnel_tpu_torch.models.encoders import gradient_depth_estimate
    from fresnel_tpu_torch.render import tile
    from fresnel_tpu_torch.train import fit_teacher

    scene = smooth_image(REFINE["res"], 0)
    depth = gradient_depth_estimate(
        torch.from_numpy(scene.transpose(1, 2, 0).copy()).to(dev),
        REFINE["res"]).cpu().numpy()
    cam = Camera.default_training(REFINE["res"])
    cfg = tile.TileRendererConfig(max_per_tile=REFINE["max_per_tile"])
    raw0 = fit_teacher.init_raw(scene, depth, cam, grid=REFINE["grid"],
                                K=REFINE["K"])
    with torch.no_grad():
        head = head_transform(torch.from_numpy(raw0).to(dev),
                              torch.from_numpy(depth).to(dev)[None],
                              torch.tensor(REFINE["depth_offset_init"],
                                           device=dev))
        tp = tile.pack_tiles(*[head[k][0] for k in FIELDS], cam.to(dev), cfg)
    return scene, depth, cam, cfg, raw0, tp


def render_phases(torch, dev, k1, k2, path_launches):
    """Phases 14-20: the large-cloud render path.  Returns the kernel-table
    entries of K3 and K4 (and raises K1's and K2's errors to what this
    path's pack showed)."""
    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile

    counters = (raster, binning, stream_binning)
    n, res, M = RENDER["n"], RENDER["res"], RENDER["max_per_tile"]
    ts = 16
    ntx = nty = res // ts
    T = ntx * nty
    cam = Camera.default_training(res)
    cfg = tile.TileRendererConfig(max_per_tile=M)
    cfg_stream = tile.TileRendererConfig(max_per_tile=M, binning="stream")

    def kernels_at_shapes(cl, camera, c):
        """K3 and K1 against their plain versions on what `render_tiled`
        hands them for cloud `cl` under `camera` and config `c` (search
        binning): K3 bit for bit, K1's largest absolute error."""
        gx, gy = -(-camera.width // ts), -(-camera.height // ts)
        sp_ = tile.project_sorted(*fields(cl), camera, c)
        xlo, xhi, ylo, yhi, vis_, n2_ = tile._padded_intervals(
            sp_.means2d, sp_.radii, sp_.visible, ts)
        b_ = (xlo, torch.where(vis_, xhi, -1), ylo,
              torch.where(vis_, yhi, -1))
        groups_ = tile.search_groups(cl.num_gaussians, gx, gy)
        gy_g = -(-gy // groups_)
        k3_equal = True
        for g in range(groups_):
            got_ = binning.build_rank_table(*b_, gx, gy_g, n2_,
                                            y_offset=g * gy_g)
            ref_ = binning.build_rank_table_plain(*b_, gx, gy_g, n2_,
                                                  y_offset=g * gy_g)
            k3_equal &= bool(torch.equal(got_[0], ref_[0])
                             and torch.equal(got_[1], ref_[1]))
            del got_, ref_
        tp_ = tile.pack_tiles(*fields(cl), camera, c)
        fwd_ = raster.composite_tiles_packed(tp_.pack, tp_.counts,
                                             tp_.n_tiles_x)
        plain_ = raster.composite_tiles_plain(tp_.pack, tp_.counts,
                                              tp_.n_tiles_x)
        return dict(grid=[gx, gy], n2=n2_, groups=groups_,
                    M=int(tp_.pack.shape[1]),
                    occupied_slots=int(tp_.counts.sum().item()),
                    k3_bitwise_equal=k3_equal,
                    k1_max_abs_err=max((g_ - r_).abs().max().item()
                                       for g_, r_ in zip(fwd_, plain_)))

    # 14. kernel_table (K3) at full width
    with torch.no_grad():
        sp = tile.project_sorted(*fields(render_cloud(0).to(dev)), cam, cfg)
        cxlo, cxhi, cylo, cyhi, vis, n2 = tile._padded_intervals(
            sp.means2d, sp.radii, sp.visible, ts)
        bounds = (cxlo, torch.where(vis, cxhi, -1), cylo,
                  torch.where(vis, cyhi, -1))
        tab, cum = binning.build_rank_table(*bounds, ntx, nty, n2)
        torch.cuda.synchronize()
        ref_tab, ref_cum = binning.build_rank_table_plain(*bounds, ntx, nty,
                                                          n2)
        table_equal = bool(torch.equal(tab, ref_tab))
        cumtot_equal = bool(torch.equal(cum, ref_cum))
        table_err = 0.0 if table_equal else max_abs_diff(torch, tab, ref_tab)
        cum_err = (cum - ref_cum).abs().max().item()
        del ref_tab
        groups = 4
        nty_g = nty // groups
        grouped_equal = True
        for g in range(groups):
            tab_g, cum_g = binning.build_rank_table(
                *bounds, ntx, nty_g, n2, y_offset=g * nty_g)
            rows = slice(g * nty_g * ntx, (g + 1) * nty_g * ntx)
            grouped_equal &= bool(torch.equal(tab_g, tab[rows])
                                  and torch.equal(cum_g, ref_cum[rows]))
            del tab_g, cum_g

        def mask_build():
            ax = torch.arange(ntx, dtype=torch.int32, device=dev)[:, None]
            ay = torch.arange(nty, dtype=torch.int32, device=dev)[:, None]
            hx = (ax >= cxlo[None]) & (ax <= cxhi[None])
            hy = (ay >= cylo[None]) & (ay <= cyhi[None]) & vis[None]
            return tile._rank_table_from_hits(
                (hy[:, None, :] & hx[None, :, :]).reshape(T, n2))

        xla_tab, xla_cum = mask_build()
        xla_equal = bool(torch.equal(xla_tab, tab)
                         and torch.equal(xla_cum, cum))
        del xla_tab, xla_cum, tab, cum
        k3_t = kernel_times(torch, lambda: binning.build_rank_table(
            *bounds, ntx, nty, n2))
        k3_plain_ms = cuda_median_ms(
            torch, lambda: binning.build_rank_table_plain(
                *bounds, ntx, nty, n2), n=3, warmup=1)
        xla_ms = cuda_median_ms(torch, mask_build, n=5, warmup=1)
    k3_bound_ms, k3_bound_by, k3_work = bound(
        T * n2 * 2 + T * (n2 // 256) * 4 + 4 * n2 * 4, T * n2 * OPS_PER_TEST)
    log("kernel_table", name="bin_table", n_gaussians=n, n2=n2, T=T,
        table_bitwise_equal=table_equal, cumtot_bitwise_equal=cumtot_equal,
        max_abs_err=max(table_err, float(cum_err)),
        grouped_bitwise_equal=grouped_equal, groups=groups,
        mask_build_bitwise_equal=xla_equal, **k3_t, plain_ms=k3_plain_ms,
        mask_build_ms=xla_ms, table_bytes=T * n2 * 2, **k3_work,
        bound_ms=k3_bound_ms, bound_by=k3_bound_by)
    if not (table_equal and cumtot_equal and grouped_equal and xla_equal):
        fail("K3 disagrees with its plain version")
    k3 = dict(max_abs_err=max(table_err, float(cum_err)), ms=k3_t["ms"],
              call_ms=k3_t["call_ms"],
              plain_ms=k3_plain_ms, bound_ms=k3_bound_ms,
              bound_by=k3_bound_by)

    # 15. kernel_stream (K4) at full width
    with torch.no_grad():
        sorted_in = (sp.means2d, sp.radii, sp.visible)
        got = stream_binning.bin_gaussians_stream(*sorted_in, ntx, nty, ts, M)
        again = stream_binning.bin_gaussians_stream(*sorted_in, ntx, nty, ts,
                                                    M)
        torch.cuda.synchronize()
        plain = stream_binning.bin_gaussians_stream_plain(*sorted_in, ntx,
                                                          nty, ts, M)
        search = tile._bin_gaussians_search(*sorted_in, ntx, nty, ts, M)
        eq_plain = tables_equal(torch, got, plain)
        eq_search = tables_equal(torch, got, search)
        eq_again = tables_equal(torch, got, again)
        k4_err = float((torch.where(got[1], got[0], -1)
                        - torch.where(plain[1], plain[0], -1)).abs().max())
        counts = got[1].sum(dim=1)
        full = counts == M
        # The stream position after which a tile needs nothing more: its
        # M-th hit, or the end of the stream if it never fills.
        need = torch.where(full, got[0][:, M - 1].long() + 1, n)
        fill = need[full].double()
        iv = stream_binning.stream_intervals(*sorted_in, ntx, nty, ts)
        n_chunks, capacity, _ = stream_binning.stream_plan(n, T, M)
        # The open (chunk, tile) pairs are the chunks that hold a kept hit
        # of the tile; a place walk reads its chunk up to its last one.
        chunk_len = stream_binning.STREAM_CHUNK
        tiles = torch.arange(T, device=dev)[:, None].expand(T, M)[got[1]]
        idx = got[0][got[1]].long()
        key = tiles * n_chunks + idx // chunk_len
        last = torch.full((T * n_chunks,), -1, dtype=torch.long, device=dev)
        last.scatter_reduce_(0, key, idx, "amax")
        opened = last >= 0
        open_pairs = int(opened.sum().item())
        place_reads = int((last[opened] % chunk_len + 1).sum().item())
        k4_t = kernel_times(
            torch, lambda: stream_binning.bin_gaussians_stream(
                *sorted_in, ntx, nty, ts, M), n=20)
        k4_launch_t = kernel_times(
            torch, lambda: stream_binning._launch(iv, ntx, nty, M))
        k4_plain_ms = cuda_median_ms(
            torch, lambda: stream_binning.bin_gaussians_stream_plain(
                *sorted_in, ntx, nty, ts, M), n=3, warmup=1)
        search_ms = cuda_median_ms(
            torch, lambda: tile._bin_gaussians_search(
                *sorted_in, ntx, nty, ts, M), n=5, warmup=1)
        del plain, search, again, iv, tiles, idx, key, last, opened
    # The function's work: every Gaussian's interval is read and tested
    # once, and the tiles it covers follow from the interval, so one count
    # per hit that this run's data keeps (a tile's hits up to its M-th).
    # What this implementation's tile-major scan tests, the sum over tiles
    # of `need`, is logged beside it and is no part of the bound.
    scan_tests = int(need.sum().item())
    kept_hits = int(counts.sum().item())
    k4_bound_ms, k4_bound_by, k4_work = bound(
        n * (2 * 4 + 4 + 1) + T * M * (4 + 1),
        (n + kept_hits) * OPS_PER_TEST)
    log("kernel_stream", name="bin_stream", n_gaussians=n, T=T, M=M,
        equals_plain=eq_plain, equals_search=eq_search,
        repeat_bitwise_equal=eq_again, max_abs_err=k4_err, **k4_t,
        launch_only_ms=k4_launch_t["ms"],
        launch_only_call_ms=k4_launch_t["call_ms"],
        launch_only_host_time_hidden=k4_launch_t["host_time_hidden"],
        chunk=chunk_len, chunks=n_chunks, pair_capacity=capacity,
        open_pairs=open_pairs, place_gaussians_read=place_reads,
        plain_ms=k4_plain_ms,
        search_binning_ms=search_ms, tiles_filled=int(full.sum().item()),
        fill_position_mean=fill.mean().item() if fill.numel() else None,
        fill_position_max=fill.max().item() if fill.numel() else None,
        kept_hits=kept_hits, tile_scan_interval_tests=scan_tests,
        tile_scan_ops_ms=scan_tests * OPS_PER_TEST / F32_OPS_PER_S * 1e3,
        **k4_work, bound_ms=k4_bound_ms, bound_by=k4_bound_by)
    if not (eq_plain and eq_search and eq_again):
        fail("K4 disagrees with its plain version or the search binning")
    # `ms` is the launch's, as the bound is the function's from the
    # intervals; the wrapper adds their preparation (~10 torch ops).
    k4 = dict(max_abs_err=k4_err, ms=k4_launch_t["ms"],
              call_ms=k4_launch_t["call_ms"], wrapper_ms=k4_t["ms"],
              plain_ms=k4_plain_ms,
              bound_ms=k4_bound_ms, bound_by=k4_bound_by)
    del sp, sorted_in, got, bounds, cxlo, cxhi, cylo, cyhi, vis

    # 16. binnings_agree at 200 000 Gaussians
    with torch.no_grad():
        sp = tile.project_sorted(
            *fields(render_cloud(1, AGREE_N).to(dev)), cam, cfg)
        a = (sp.means2d, sp.radii, sp.visible, ntx, nty, ts, M)
        ref = tile._bin_gaussians(*a)
        _, _, cylo, cyhi = binning.tile_intervals(sp.means2d, sp.radii, ts)
        ay = torch.arange(nty, dtype=torch.int32, device=dev)[:, None]
        row_hits = ((ay >= cylo[None]) & (ay <= cyhi[None])
                    & sp.visible[None]).sum(dim=1)
        n2 = -(-AGREE_N // 256) * 256
        auto_cap = -(-min(max(2 * ntx * M, 4 * n2 // nty), n2) // 256) * 256
        fit = (row_hits <= auto_cap).repeat_interleave(ntx)
        rows_auto = tile._bin_gaussians_rows(*a)
        agree = {
            "search_pallas_g1": tile._bin_gaussians_search(
                *a, groups=1, table="pallas"),
            "search_pallas_g4": tile._bin_gaussians_search(
                *a, groups=4, table="pallas"),
            "search_xla_g1": tile._bin_gaussians_search(
                *a, groups=1, table="xla"),
            "search_xla_g4": tile._bin_gaussians_search(
                *a, groups=4, table="xla"),
            "stream": stream_binning.bin_gaussians_stream(*a),
            "rows_all_fit": tile._bin_gaussians_rows(
                *a, row_capacity=int(row_hits.max().item())),
            "chunked": tile._bin_gaussians_chunked(*a),
        }
        agree = {k: tables_equal(torch, v, ref) for k, v in agree.items()}
        agree["rows_auto_capacity"] = tables_equal(
            torch, (rows_auto[0][fit], rows_auto[1][fit]),
            (ref[0][fit], ref[1][fit]))
    log("binnings_agree", n_gaussians=AGREE_N, T=T, M=M, equal_to_pairs=agree,
        rows_auto_capacity=auto_cap, row_hits_max=int(row_hits.max().item()),
        tile_rows_within_auto_capacity=int((row_hits <= auto_cap).sum()),
        tiles_at_cap=int(ref[1].all(dim=1).sum().item()))
    if not all(agree.values()):
        fail(f"binnings disagree: {agree}")
    del sp, a, ref, rows_auto, fit

    # 17. render_path: render_tiled at full width, both binning kernels
    clouds = [render_cloud(10 + i).to(dev) for i in range(RENDER_CLOUDS)]
    results = {}
    with torch.no_grad():
        for name, c in (("search", cfg), ("stream", cfg_stream)):
            tile.render_tiled(*fields(clouds[0]), cam, config=c)   # warmup
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(*counters)
            events, outs = [], []
            t0 = time.perf_counter()
            for cl in clouds:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                outs.append(tile.render_tiled(*fields(cl), cam, config=c,
                                              return_overflow=True))
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / len(clouds) * 1e3
            path_launches[f"render_{name}"] = read_counts(*counters)
            results[name] = dict(
                images=[o[0] for o in outs],
                overflow=[o[1].tolist() for o in outs],
                e2e_ms=[s.elapsed_time(e) for s, e in events],
                host_ms=host_ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        # Stage times, and K1 on this path's pack.
        stage_names = ("project_sort", "binning_search", "binning_stream",
                       "gather", "raster_fwd")
        per_stage = {s_: [] for s_ in stage_names}
        for cl in clouds:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            sp = tile.project_sorted(*fields(cl), cam, cfg)
            ev[1].record()
            idx, valid = tile.bin_tiles(sp.means2d, sp.radii, sp.visible,
                                        ntx, nty, M, cfg)
            ev[2].record()
            tile.bin_tiles(sp.means2d, sp.radii, sp.visible, ntx, nty, M,
                           cfg_stream)
            ev[3].record()
            pack, counts = tile.gather_pack(sp, idx, valid)
            ev[4].record()
            raster.composite_tiles_packed(pack, counts, ntx)
            ev[5].record()
            torch.cuda.synchronize()
            for i, s_ in enumerate(stage_names):
                per_stage[s_].append(ev[i].elapsed_time(ev[i + 1]))
        fwd = raster.composite_tiles_packed(pack, counts, ntx)
        fwd_ref = raster.composite_tiles_plain(pack, counts, ntx)
        k1_errs = {nm: (g - r).abs().max().item() for nm, g, r in zip(
            ("color", "depth", "transmittance"), fwd, fwd_ref)}
        k1_t = kernel_times(torch, lambda: raster.composite_tiles_packed(
            pack, counts, ntx))
        k1_plain_ms = cuda_median_ms(
            torch, lambda: raster.composite_tiles_plain(pack, counts, ntx),
            n=10)
        occupied = int(counts.sum().item())
        stats = pack_stats(torch, raster, pack, counts, ntx)
        bounds_r = compositing_bounds(stats, T, M, occupied)
        # K2 at this pack, the other shape the training slice gives it.
        crng = np.random.default_rng(2)
        cots = [torch.from_numpy(crng.normal(size=tuple(o.shape)).astype(
            np.float32)).to(dev) for o in fwd]
        k2_got = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots)
        k2_again = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots)
        k2_ref = raster.composite_tiles_bwd_plain(pack, counts, ntx, *fwd,
                                                  *cots)
        k2_err, _, k2_rel = bwd_errors(k2_got, k2_ref)
        k2_repeat = bool(torch.equal(k2_got, k2_again))
        k2_plain_ms = cuda_median_ms(
            torch, lambda: raster.composite_tiles_bwd_plain(
                pack, counts, ntx, *fwd, *cots), n=5, warmup=1)
        routes = k2_routes(torch, raster, pack, counts, ntx, fwd, cots)
        del sp, idx, valid, pack, counts, fwd, fwd_ref, cots, k2_got
        del k2_again, k2_ref
    same = all(torch.equal(a_, b_) for a_, b_ in zip(
        results["search"]["images"], results["stream"]["images"]))
    imgs = results["search"]["images"]
    ok_img = all(tuple(i.shape) == (3, res, res)
                 and bool(torch.isfinite(i).all())
                 and i.min().item() >= 0.0 and i.max().item() <= 1.0
                 and i.max().item() > 0.1 for i in imgs)
    log("render_path", n_gaussians=n, res=res, M=M, clouds=len(clouds),
        launches={k: path_launches[f"render_{k}"] for k in results},
        e2e_ms_median={k: statistics.median(v["e2e_ms"])
                       for k, v in results.items()},
        e2e_ms={k: v["e2e_ms"] for k, v in results.items()},
        host_ms_per_render={k: v["host_ms"] for k, v in results.items()},
        stage_ms_median={k: statistics.median(v)
                         for k, v in per_stage.items()},
        images_bitwise_equal=same,
        image_mean=[i.mean().item() for i in imgs],
        overflow_dropped_total_tiles_max=results["search"]["overflow"],
        peak_mem_gb={k: v["peak_mem_gb"] for k, v in results.items()},
        pack_stats=stats,
        k1_at_render_shapes=dict(max_abs_err=k1_errs, tol=KERNEL_TOL,
                                 **k1_t, plain_ms=k1_plain_ms,
                                 occupied_slots=occupied, **bounds_r["k1"]),
        k2_at_render_shapes=dict(max_abs_err=k2_err, rel_err=k2_rel,
                                 tol=KERNEL_BWD_TOL,
                                 repeat_bitwise_equal=k2_repeat,
                                 **routes["alone"], plain_ms=k2_plain_ms,
                                 handed=routes["handed"],
                                 routes_bitwise_equal=routes[
                                     "routes_bitwise_equal"],
                                 **bounds_r["k2"]))
    want = {"render_search": dict(k1=len(clouds), k2=0, k3=len(clouds), k4=0),
            "render_stream": dict(k1=len(clouds), k2=0, k3=0, k4=len(clouds))}
    for k, v in want.items():
        if path_launches[k] != v:
            fail(f"{k} launched {path_launches[k]}, expected {v}")
    if not (same and ok_img):
        fail("the full-width renders are not finite, equal images in [0, 1]")
    if results["search"]["overflow"] != results["stream"]["overflow"]:
        fail("overflow telemetry differs between the binnings")
    k1_err = max(k1_errs.values())
    if not k1_err <= KERNEL_TOL:
        fail(f"K1 disagrees with its plain version at the render shapes: "
             f"{k1_errs}")
    if not (max(k2_rel.values()) <= KERNEL_BWD_TOL and k2_repeat
            and routes["routes_bitwise_equal"]):
        fail(f"K2 disagrees with its plain version at the render shapes, "
             f"across its routes or from run to run: {k2_rel}")
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_err)
    k2["max_abs_err"] = max(k2["max_abs_err"], max(k2_err.values()))
    del results, imgs

    # 18. render_reference: 120 000 Gaussians on the card and on the CPU
    with torch.no_grad():
        small = render_cloud(2, RENDER_REF_N)
        sp_c = tile.project_sorted(*fields(small), cam, cfg)
        tab_c = tile.bin_tiles(sp_c.means2d, sp_c.radii, sp_c.visible, ntx,
                               nty, M, cfg)
        reset_counts(*counters)
        tab_g = tile.bin_tiles(sp_c.means2d.to(dev), sp_c.radii.to(dev),
                               sp_c.visible.to(dev), ntx, nty, M, cfg)
        tab_s = tile.bin_tiles(sp_c.means2d.to(dev), sp_c.radii.to(dev),
                               sp_c.visible.to(dev), ntx, nty, M, cfg_stream)
        ref_counts = read_counts(*counters)
        tables_same = (tables_equal(torch, (tab_g[0].cpu(), tab_g[1].cpu()),
                                    tab_c)
                       and tables_equal(torch,
                                        (tab_s[0].cpu(), tab_s[1].cpu()),
                                        tab_c))
        sp_g = tile.project_sorted(*fields(small.to(dev)), cam, cfg)
        iv_c = torch.stack(binning.tile_intervals(sp_c.means2d, sp_c.radii,
                                                  ts))
        iv_g = torch.stack(binning.tile_intervals(sp_g.means2d, sp_g.radii,
                                                  ts)).cpu()
        img_c = tile.render_tiled(*fields(small), cam, config=cfg)
        img_g = tile.render_tiled(*fields(small.to(dev)), cam, config=cfg)
        img_err = (img_g.cpu() - img_c).abs()
    log("render_reference", n_gaussians=RENDER_REF_N, res=res, M=M,
        tables_identical_on_identical_inputs=tables_same,
        launches_on_card=ref_counts,
        gaussians_whose_intervals_differ=int(
            (iv_c != iv_g).any(dim=0).sum().item()),
        img_mean_abs=img_err.mean().item(), img_max_abs=img_err.max().item(),
        img_mean_tol=REF_IMG_MEAN_TOL)
    if not (tables_same and ref_counts["k3"] == 1 and ref_counts["k4"] == 1):
        fail("the card's tables differ from the CPU's on identical inputs")
    if not img_err.mean().item() <= REF_IMG_MEAN_TOL:
        fail("the card's large-cloud render disagrees with the CPU's")
    del sp_c, sp_g, tab_c, tab_g, tab_s, small

    # 19. render_cli: the functions under `render` and `orbit`
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.bin")
        gio.save_binary(path, clouds[0])
        loaded = gio.load_binary(path)
        cli.render(loaded, device=dev)                             # warmup
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        img = cli.render(loaded, device=dev)
        torch.cuda.synchronize()
        render_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        azimuths, views = cli.orbit(loaded, views=8, size=256, device=dev)
        torch.cuda.synchronize()
        orbit_ms = (time.perf_counter() - t0) * 1e3
        path_launches["render_cli"] = read_counts(*counters)
        # K3 and K1 at the shapes that path gave them, and its images
        # against the table build that launches no K3.
        on_card = loaded.to(dev)
        cli_checks = {}
        with torch.no_grad():
            for label, c_cam, m_cli, shown in (
                    [("render", Camera.from_pose(0.0, 0.0, 512, distance=2.0),
                      512, img)]
                    + [(f"orbit_az{int(az):03d}",
                        Camera.from_pose(0.0, np.radians(az), 256,
                                         distance=2.0), 256, v)
                       for az, v in zip(azimuths, views)]):
                c_cli = tile.TileRendererConfig(max_per_tile=m_cli)
                chk = kernels_at_shapes(on_card, c_cam, c_cli)
                before_k3 = binning.launches
                via_masks = tile.render_tiled(
                    *fields(on_card), c_cam,
                    config=dataclasses.replace(c_cli, table_build="xla"))
                chk["image_equals_mask_build"] = bool(
                    torch.equal(shown, via_masks)
                    and binning.launches == before_k3)
                cli_checks[label] = chk
        del on_card
        cli_k1_err = max(c["k1_max_abs_err"] for c in cli_checks.values())
        cli_ok = all(c["k3_bitwise_equal"] and c["image_equals_mask_build"]
                     and c["k1_max_abs_err"] <= KERNEL_TOL
                     for c in cli_checks.values())
        good = (loaded.num_gaussians == n
                and tuple(img.shape) == (3, 512, 512)
                and tuple(views.shape) == (8, 3, 256, 256)
                and bool(torch.isfinite(img).all())
                and bool(torch.isfinite(views).all())
                and img.max().item() > 0.1
                and all(v.max().item() > 0.1 for v in views))
        log("render_cli", n_gaussians=loaded.num_gaussians,
            file_bytes=os.path.getsize(path), render_ms=render_ms,
            render_shape=list(img.shape), render_mean=img.mean().item(),
            orbit_views=len(azimuths), orbit_ms_per_view=orbit_ms / 8,
            orbit_shape=list(views.shape),
            orbit_means=[v.mean().item() for v in views],
            launches=path_launches["render_cli"],
            kernels_at_cli_shapes=cli_checks, k1_tol=KERNEL_TOL)
        if not good:
            fail("cli.render / cli.orbit gave a bad image")
        if not cli_ok:
            fail(f"a kernel disagrees with its plain version at the shapes "
                 f"of cli.render / cli.orbit: {cli_checks}")
        k1["max_abs_err"] = max(k1["max_abs_err"], cli_k1_err)
        if path_launches["render_cli"] != dict(k1=9, k2=0, k3=9, k4=0):
            fail(f"render + orbit launched {path_launches['render_cli']}")
        del loaded, img, views

    # 20. render_profile
    n_prof = 2
    with torch.no_grad():
        prof = profile_ms(torch, lambda: [
            tile.render_tiled(*fields(cl), cam, config=cfg)
            for cl in clouds[:n_prof]], n_prof)
    log("render_profile", renders=n_prof, wall_ms_per_render=prof["wall_ms"],
        device_ms_per_render=prof["device_ms"],
        device_busy_share=prof["device_busy_share"],
        kernels_per_render=prof["kernels"],
        top_kernels_ms_per_render=prof["top_kernels_ms"])
    return k3, k4


def kernel_small_m(torch, dev):
    """K1 and K2 against their plain versions on the packs `render_tiled`
    makes at M = 32 and M = 96 (N = 20 and 70 at 64^2): K1 within 1e-5,
    K2 per field within 1e-4 of the field's largest plain value, K2 bit
    for bit run to run."""
    from fresnel_tpu_torch.core.gaussians import GaussianCloud
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import raster, tile

    out = []
    for n, want_m in SMALL_M:
        cloud = GaussianCloud.test_cloud(n, seed=n, spread=0.5, z_offset=-2.0,
                                         scale=0.06).to(dev)
        with torch.no_grad():
            tp = tile.pack_tiles(*fields(cloud), Camera.default_training(64),
                                 tile.TileRendererConfig(max_per_tile=128))
            pack, counts, ntx = tp.pack, tp.counts, tp.n_tiles_x
            fwd = raster.composite_tiles_packed(pack, counts, ntx)
            ref = raster.composite_tiles_plain(pack, counts, ntx)
            ferr = max((g - r).abs().max().item() for g, r in zip(fwd, ref))
            crng = np.random.default_rng(n)
            cots = [torch.from_numpy(crng.normal(size=tuple(o.shape)).astype(
                np.float32)).to(dev) for o in fwd]
            got = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots)
            again = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots)
            bref = raster.composite_tiles_bwd_plain(pack, counts, ntx, *fwd,
                                                    *cots)
        berr, _, rel = bwd_errors(got, bref)
        row = dict(n=n, M=int(pack.shape[1]), T=int(pack.shape[0]),
                   counts_max=int(counts.max().item()), k1_max_abs_err=ferr,
                   k2_max_abs_err=max(berr.values()),
                   k2_rel_err=max(rel.values()),
                   k2_repeat_bitwise_equal=bool(torch.equal(got, again)))
        out.append(row)
        if row["M"] != want_m:
            fail(f"N = {n} gave M = {row['M']}, not {want_m}")
        if not (ferr <= KERNEL_TOL and row["k2_rel_err"] <= KERNEL_BWD_TOL
                and row["k2_repeat_bitwise_equal"]):
            fail(f"K1 / K2 disagree with their plain versions at M = "
                 f"{row['M']}: {row}")
    log("kernel_small_m", packs=out, k1_tol=KERNEL_TOL,
        k2_tol=KERNEL_BWD_TOL)
    return max(r["k1_max_abs_err"] for r in out), max(
        r["k2_max_abs_err"] for r in out)


def train_setup(torch, dev, cfg_kw, tmp, dropout=None, lpips=None):
    """A Trainer of config `cfg_kw` on `dev` (decoder dropout 0 when
    `dropout` is 0; the LPIPS module `lpips`, if any) and its init state
    with depth_offset_init applied."""
    from fresnel_tpu_torch.train import config as tconfig
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder

    cfg = tconfig.TrainingConfig(output_dir=tmp, **cfg_kw)
    trainer = Trainer(cfg, tconfig.PhysicsConfig(),
                      tconfig.HFGSConfig(**TRAIN_HFGS), tconfig.HFTSConfig(),
                      lpips=lpips, device=dev)
    if dropout is not None:
        trainer.model = build_decoder(cfg, trainer.physics_config,
                                      dropout=dropout)
    state = trainer.init_state()
    state["params"]["model.depth_offset"] = torch.tensor(
        cfg.depth_offset_init, device=trainer.device)
    return trainer, state


def train_batches(dataset, batch_size, n, seed=0):
    """n batches (numpy) in the order `fit` draws them, epoch after epoch."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        out.extend(dataset.batches(batch_size, rng))
    return out[:n]


def train_phases(torch, dev, path_launches):
    """Phases 21-24: decoder training at the flagship config.  Returns the
    numbers of K1 and K2 at the training pack (T = 8 * 256, M = 1024)."""
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli

    counters = (raster, binning, stream_binning)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    data_dir = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    synthetic_corpus.generate_corpus(data_dir, n_images=TRAIN_SCENES,
                                     image_size=TRAIN["image_size"], seed=0)
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dataset = ImageDataset(data_dir, image_size=TRAIN["image_size"],
                           feature_dim=TRAIN["feature_dim"],
                           use_augmentation=False, device=dev)
    caches_s = time.perf_counter() - t0
    B = TRAIN["batch_size"]

    # 21. train_reference: a small config, card against CPU, same init.
    ref_batches = train_batches(dataset, TRAIN_REF["batch_size"],
                                TRAIN_REF_STEPS)
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        trainer, state = train_setup(torch, d, TRAIN_REF,
                                     os.path.join(tmp, f"ref_{name}"),
                                     dropout=0.0)
        trainer._make_optimizer(TRAIN_REF_STEPS)
        gen = torch.Generator(device=d).manual_seed(1)
        losses = []
        for batch in ref_batches:
            state, ld = trainer.train_step(
                state, trainer.device_batch(batch),
                TRAIN_REF["gaussians_per_patch"], None, gen)
            losses.append(float(ld["total"]))
        runs[name] = (losses, {k: v.cpu() for k, v in
                               state["params"].items()})
    (lg, pg), (lc, pc) = runs["card"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    diffs = {k: (pg[k] - pc[k]).abs() for k in pc}
    mean_abs = {k: d.mean().item() for k, d in diffs.items()}
    zero_grad = {k for k in mean_abs if re.search(REF_ZERO_GRAD, k)}
    held = {k: v for k, v in mean_abs.items() if k not in zero_grad}
    worst = sorted(held.items(), key=lambda kv: -kv[1])[:5]
    log("train_reference", config={k: TRAIN_REF[k] for k in (
        "image_size", "feature_size", "encoder_width", "gaussians_per_patch",
        "max_per_tile", "batch_size")}, steps=TRAIN_REF_STEPS, dropout=0.0,
        losses_card=lg, losses_cpu=lc, loss_rel_max=loss_rel,
        loss_rtol=REF_LOSS_RTOL,
        param_mean_abs_worst=dict(worst),
        param_mean_abs_tol=REF_PARAM_MEAN_TOL,
        param_mean_abs_zero_grad={k: mean_abs[k] for k in sorted(zero_grad)},
        param_max_abs=max(d.max().item() for d in diffs.values()))
    if not (loss_rel <= REF_LOSS_RTOL
            and max(held.values()) <= REF_PARAM_MEAN_TOL):
        fail("the card's training steps disagree with the CPU's")

    # 22. train_path: the flagship config at full width.
    trainer, state = train_setup(torch, dev, TRAIN, os.path.join(tmp, "run"))
    steps_per_epoch = max(1, len(dataset) // B)
    trainer._make_optimizer(TRAIN["epochs"] * steps_per_epoch)
    batches = [trainer.device_batch(b) for b in train_batches(
        dataset, B, TRAIN_WARMUP + TRAIN_STEPS)]
    gen = torch.Generator(device=dev).manual_seed(1)
    K = TRAIN["gaussians_per_patch"]
    for batch in batches[:TRAIN_WARMUP]:
        state, _ = trainer.train_step(state, batch, K, None, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    events, lds = [], []
    t0 = time.perf_counter()
    for batch in batches[TRAIN_WARMUP:]:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        state, ld = trainer.train_step(state, batch, K, None, gen)
        end.record()
        events.append((start, end))
        lds.append(ld)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    path_launches["train"] = read_counts(*counters)
    ms = [s.elapsed_time(e) for s, e in events]
    keys = list(lds[0])
    table = torch.stack([torch.stack([ld[k] for k in keys])
                         for ld in lds]).cpu().numpy()      # one host read
    loss = {k: table[:, i].tolist() for i, k in enumerate(keys)}
    total = np.asarray(loss["total"])
    first5, last5 = float(total[:5].mean()), float(total[-5:].mean())
    log("train_path", config=TRAIN, hfgs=TRAIN_HFGS, scenes=len(dataset),
        corpus_seconds=corpus_s, caches_seconds=caches_s,
        warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
        launches=path_launches["train"], ms_per_step_median=statistics.median(
            ms), ms_per_step=ms, host_ms_per_step=host_ms,
        images_per_s=B / (host_ms / 1e3),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        loss_first5_mean=first5, loss_last5_mean=last5,
        losses=loss["total"],
        overflow={k: float(np.mean(loss[k])) for k in keys
                  if k.startswith("overflow")},
        final_loss_terms={k: loss[k][-1] for k in keys})
    if path_launches["train"] != dict(k1=TRAIN_STEPS, k2=TRAIN_STEPS, k3=0,
                                      k4=0):
        fail(f"training launched {path_launches['train']} in "
             f"{TRAIN_STEPS} steps")
    if not np.all(np.isfinite(table)):
        fail("a training loss is not finite")
    if not last5 < first5:
        fail(f"the training loss did not fall: {first5} -> {last5}")

    # K1 and K2 at the training pack (one batch: T = 8 * 256, M = 1024).
    batch = batches[-1]
    with torch.no_grad():
        params = state["params"]
        feats = trainer._features(params, batch["image"])
        from torch.func import functional_call
        out = functional_call(
            trainer.model, {k[6:]: v for k, v in params.items()
                            if k.startswith("model.")},
            (feats, batch["depth"]), dict(num_gaussians=K))
        cloud = [out[k].detach() for k in FIELDS]
        bp = tile.pack_tiles_batched(*cloud, trainer.camera,
                                     trainer.renderer.config)
    pack, counts, ntx, ti = (bp.pack, bp.counts, bp.n_tiles_x,
                             bp.tiles_per_image)
    T, M = pack.shape[:2]
    with torch.no_grad():
        fwd = raster.composite_tiles_packed(pack, counts, ntx,
                                            tiles_per_image=ti)
        fwd_ref = raster.composite_tiles_plain(pack, counts, ntx,
                                               tiles_per_image=ti)
        ferr = {n: (g - r).abs().max().item() for n, g, r in zip(
            ("color", "depth", "transmittance"), fwd, fwd_ref)}
        crng = np.random.default_rng(2)
        cots = [torch.from_numpy(crng.normal(size=tuple(o.shape)).astype(
            np.float32)).to(dev) for o in fwd]
        prefix = raster._launch_fwd(pack, counts, ntx, keep_prefix=True,
                                    tiles_per_image=ti)[3]
        got = raster._launch_bwd(pack, counts, ntx, *fwd, *cots,
                                 prefix=prefix, tiles_per_image=ti)
        again = raster._launch_bwd(pack, counts, ntx, *fwd, *cots,
                                   prefix=prefix, tiles_per_image=ti)
        alone = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots,
                                           tiles_per_image=ti)
        bref = raster.composite_tiles_bwd_plain(pack, counts, ntx, *fwd,
                                                *cots, tiles_per_image=ti)
        berr, _, rel = bwd_errors(got, bref)
        k1_t = kernel_times(torch, lambda: raster._launch_fwd(
            pack, counts, ntx, keep_prefix=True, tiles_per_image=ti), n=20)
        k2_t = kernel_times(torch, lambda: raster._launch_bwd(
            pack, counts, ntx, *fwd, *cots, prefix=prefix,
            tiles_per_image=ti), n=20)
        k1_plain = cuda_median_ms(torch, lambda: raster.composite_tiles_plain(
            pack, counts, ntx, tiles_per_image=ti), n=3, warmup=1)
        k2_plain = cuda_median_ms(
            torch, lambda: raster.composite_tiles_bwd_plain(
                pack, counts, ntx, *fwd, *cots, tiles_per_image=ti),
            n=3, warmup=1)
    occupied = int(counts.sum().item())
    stats = pack_stats(torch, raster, pack, counts, ntx, tiles_per_image=ti)
    bnds = compositing_bounds(stats, T, M, occupied)

    # The same batch's render and backward: one batched pack against B
    # separate render_tiled calls (CUDA events, median of 3).
    cots_img = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, 3, TRAIN["image_size"], TRAIN["image_size"])).astype(
            np.float32)).to(dev)

    def batched():
        leaves = [c.clone().requires_grad_() for c in cloud]
        img, dep, _ = trainer.renderer.batch(*leaves, trainer.camera)
        torch.autograd.backward([img], [cots_img])

    def separate():
        leaves = [c.clone().requires_grad_() for c in cloud]
        for b in range(B):
            img = tile.render_tiled(*[x[b] for x in leaves], trainer.camera,
                                    config=trainer.renderer.config)
            torch.autograd.backward([img], [cots_img[b]])

    render_ms = dict(batched=cuda_median_ms(torch, batched, n=3, warmup=1),
                     separate=cuda_median_ms(torch, separate, n=3, warmup=1))
    log("train_kernels", T=T, M=M, tiles_per_image=ti,
        n_gaussians=int(cloud[0].shape[1]), occupied_slots=occupied,
        k1_max_abs_err=ferr, k1_tol=KERNEL_TOL, k2_rel_err=rel,
        k2_tol=KERNEL_BWD_TOL, k2_repeat_bitwise_equal=bool(
            torch.equal(got, again)),
        k2_routes_bitwise_equal=bool(torch.equal(got, alone)),
        k1=dict(**k1_t, plain_ms=k1_plain, **bnds["k1"]),
        k2=dict(**k2_t, plain_ms=k2_plain, **bnds["k2"]), **stats,
        render_and_backward_ms=render_ms)
    if not (max(ferr.values()) <= KERNEL_TOL
            and max(rel.values()) <= KERNEL_BWD_TOL
            and torch.equal(got, again) and torch.equal(got, alone)):
        fail("K1 / K2 disagree with their plain versions at the training "
             "pack, or do not repeat")

    # 23. train_profile
    n_prof = 4
    prof_batches = batches[:n_prof]

    def steps():
        nonlocal state
        for b in prof_batches:
            state, _ = trainer.train_step(state, b, K, None, gen)

    prof = profile_ms(torch, steps, n_prof, top=10)
    log("train_profile", steps=n_prof, wall_ms_per_step=prof["wall_ms"],
        device_ms_per_step=prof["device_ms"],
        device_busy_share=prof["device_busy_share"],
        kernels_per_step=prof["kernels"],
        indexing_backward_ms_per_step=prof["indexing_backward_ms"],
        top_kernels_ms_per_step=prof["top_kernels_ms"])

    # 24. train_cli: the training CLI on the corpus, one epoch.
    out_dir = os.path.join(tmp, "cli")
    argv = ["--data_dir", data_dir, "--output_dir", out_dir, "--epochs",
            "1", "--batch_size", str(B), "--lr", str(TRAIN["lr"]),
            "--gaussians_per_patch", "8", "--surface_init",
            "--depth_offset_init", str(TRAIN["depth_offset_init"]),
            "--train_encoder", "--max_per_tile", "1024", "--lpips_weight",
            "0", "--no_augmentation", "--device", "cuda"]
    t0 = time.perf_counter()
    cli_trainer, cli_state = tcli.main(argv)
    cli_s = time.perf_counter() - t0
    ckpt = os.path.join(out_dir, "final_model.pt")
    written = sorted(os.listdir(out_dir))
    back, epoch = cli_trainer.load_checkpoint(ckpt)
    same = (torch.equal(back["step"], cli_state["step"])
            and all(torch.equal(back["params"][k], v)
                    for k, v in cli_state["params"].items())
            and torch.equal(back["opt_state"]["count"],
                            cli_state["opt_state"]["count"])
            and all(torch.equal(back["opt_state"][m][k], v)
                    for m in ("mu", "nu")
                    for k, v in cli_state["opt_state"][m].items()))
    feats = cli_trainer.encode(back["params"], batches[0]["image"])
    with open(ckpt + ".json") as f:
        meta = json.load(f)
    log("train_cli", argv=argv, seconds=cli_s, files=written,
        sidecar_keys=sorted(meta), history=cli_trainer.history.get("total"),
        round_trip_bitwise_equal=same, encode_shape=list(feats.shape),
        encode_finite=bool(torch.isfinite(feats).all()))
    if not ("final_model.pt.json" in written and same
            and tuple(feats.shape) == (B, 37, 37, 384)
            and torch.isfinite(feats).all()):
        fail("the training CLI's checkpoint, round trip or encode failed")
    shutil.rmtree(tmp, ignore_errors=True)
    return (dict(max_abs_err=max(ferr.values()), ms=k1_t["ms"],
                 plain_ms=k1_plain, bound_ms=bnds["k1"]["bound_ms"]),
            dict(max_abs_err=max(berr.values()), ms=k2_t["ms"],
                 plain_ms=k2_plain, bound_ms=bnds["k2"]["bound_ms"]))


# The committed trained checkpoints (results/*.msgpack): all seven are
# read and load into the port's Trainer.
CKPTS = ("exp2", "exp2_k8", "v2combo", "exp2_e74", "exp2_g74zi", "exp4",
         "exp4_budget")
INFER_TIMED = 3
INFER_RTOL = 1e-5
# corpus_v1_eval and corpus_v2_eval as cloud/make_corpus.sh makes them
# (24 scenes each, seeds 1 and 21); view-aware training takes the first 4
# corpus_v2 scenes.  corpus_v2_eval is cut to its first 4 scenes (its 24
# took 35 s to raytrace on the card's host, 8 of them 23 s): v2combo's
# eval is logged beside the committed TPU JSON over those 4, the scenes
# view-aware training takes.
EVAL_SCENES, EVAL_SEED, EVAL_SIZE = 24, 1, 256
EVAL_V2_SCENES, EVAL_V2_SEED, VIEW_SCENES = 4, 21, 4
# Card against the port's CPU on the first scene of each eval (the CPU's
# renders of 2 scenes took 11-15 s an eval).
EVAL_REF_SCENES = 1
EVAL_SSIM_TOL, EVAL_PSNR_TOL = 1e-4, 1e-3
# exp2's sidecar says epoch 300 of 300 and a resume starts at epoch + 1:
# epochs 301-303 of 16 scenes at batch 8 are 6 steps.
RESUME_EPOCHS = 304
# v2combo (epoch 224 of 225) resumed on 4 corpus_v2 scenes at batch 4
# (cut from 8): epochs 225-229, one step each.
VIEW_EPOCHS, VIEW_BATCH, VIEW_TIMED = 230, 4, 5
VIEW_REF = dict(TRAIN_REF, view_weight=0.5, z_offset_scale=0.2,
                depth_z_scale=2.0, depth_offset_init=-1.0)
# resume_reference: exp2's sidecar config cut to 64^2 and batch 2 (the
# CLI turns LPIPS off without its weights).  Per leaf, card against CPU:
# the params' mean absolute difference within REF_PARAM_MEAN_TOL; mu's
# and nu's within RESUME_MOMENT_RTOL of the leaf's mean absolute value.
# The moments carry the checkpoint's 6 000 steps, so a moment lost or
# mapped to the wrong leaf is off by 0.3 or more of that; rounding is not
# (the scalar depth_offset's gradient sums every pixel, and the card's
# summation order moves its mu by 6e-4 of its size).
RESUME_REF = dict(image_size=64, batch_size=2, lpips_weight=0.0)
RESUME_MOMENT_RTOL = 1e-2
# The new phases' time on the card, which they are meant to keep to.
CKPT_PHASES_CAP_S = 90.0


# Experiment 4, distillation and the 74^2 upsampled decoder (phases 32-37).
# The evals of the four checkpoints against their committed TPU JSONs:
# frontal SSIM within 1e-3 and PSNR within 0.05 dB.
EXP4_EVALS = ("exp4", "exp4_budget", "exp2_g74zi", "exp2_e74")
INFER_N = {"exp4": 377, "exp4_budget": 5476, "exp2_g74zi": 74 * 74 * 2}
COMMITTED_SSIM_TOL, COMMITTED_PSNR_TOL = 1e-3, 0.05
# teacher_fit4: exp4_budget's spiral on the first 8 of the 16 training
# scenes, 256^2, M 1024; cut from 800 Adam steps to 50.
TEACHER = dict(scenes=8, grid=5476, steps=50, res=256)
TEACHER_REF_STEPS = 2
# distill_train4: exp4_budget's sidecar config with distillation on those
# 8 scenes at batch 8 (cut from 150 epochs of 160 scenes to 4 epochs, one
# step each), then DISTILL_TIMED steps timed by CUDA events.
DISTILL_EPOCHS, DISTILL_TIMED = 4, 3
# distill_reference: that config cut to 64^2, batch 2, dropout 0.
DISTILL_REF = dict(image_size=64, batch_size=2, lpips_weight=0.0,
                   distill_weight=1.0, distill_decay_epochs=2,
                   depth_offset_init=None)
DISTILL_REF_STEPS = 2
DISTILL_PARAM_MEAN_TOL = 1e-6
# exp4_resume_reference: 2 steps.  At a third the card and the CPU part
# (loss 2.7e-4 relative; ROADMAP Queue 3).
EXP4_RESUME_STEPS = 2
# The new phases' time on the card, which they are meant to keep to.
EXP4_PHASES_CAP_S = 60.0


def ckpt_path(name):
    return os.path.join(HERE, "results", f"{name}_model.msgpack")


def rel_err(got, want):
    """max |got - want| over max |want|, for each field of two clouds."""
    return {k: ((getattr(got, k) - getattr(want, k)).abs().max()
                / getattr(want, k).abs().max().clamp(min=1e-30)).item()
            for k in ("positions", "colors", "opacities")}


def eval_gate(card, cpu, size):
    """The card's metrics against the CPU's on the same scenes: frontal
    SSIM / PSNR, per-view SSIM where there are GT views, and coverage
    within 2 pixels of S^2 per view."""
    cov = max(abs(card["per_view_coverage"][k] - v)
              for k, v in cpu["per_view_coverage"].items())
    ssim_d = [abs(card["frontal_ssim"] - cpu["frontal_ssim"])] + [
        abs(card["per_view_ssim"][k] - v)
        for k, v in cpu.get("per_view_ssim", {}).items()]
    psnr_d = abs(card["frontal_psnr"] - cpu["frontal_psnr"])
    out = dict(ssim_max_abs=max(ssim_d), psnr_abs=psnr_d,
               coverage_max_abs=cov, ssim_tol=EVAL_SSIM_TOL,
               psnr_tol=EVAL_PSNR_TOL, coverage_tol=2 / size ** 2)
    out["ok"] = (out["ssim_max_abs"] <= EVAL_SSIM_TOL
                 and psnr_d <= EVAL_PSNR_TOL and cov <= 2 / size ** 2)
    return out


def eval_checkpoint(torch, name, data_dir, counters, grid=None):
    """`cli eval` of one checkpoint over a corpus on the card (and its
    qualitative grid to the path `grid`), the launches it made, and the
    card against the CPU on the first EVAL_REF_SCENES scenes."""
    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.evaluation.novel_view_eval import (
        evaluate_novel_views)

    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    res, samples, mpt = cli.evaluate(ckpt_path(name), data_dir=data_dir,
                                     size=EVAL_SIZE, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = read_counts(*counters)
    if grid:
        cli.save_grid(samples, grid, EVAL_SIZE, mpt)
        torch.cuda.synchronize()
        launches = read_counts(*counters)
    card = evaluate_novel_views(samples[:EVAL_REF_SCENES],
                                render_size=EVAL_SIZE, max_per_tile=mpt)
    t0 = time.perf_counter()
    cpu, _, _ = cli.evaluate(ckpt_path(name), data_dir=data_dir,
                             max_images=EVAL_REF_SCENES, size=EVAL_SIZE,
                             device="cpu")
    cpu_s = time.perf_counter() - t0
    return dict(results=res, samples=samples, max_per_tile=mpt,
                seconds=eval_s, seconds_per_scene=eval_s / len(samples),
                launches=launches, gate=eval_gate(card, cpu, EVAL_SIZE),
                cpu_seconds=cpu_s)


def committed_deltas(name, res):
    """The run's metrics less the committed TPU evaluation's
    (results/eval_<name>_eval.json), key by key."""
    with open(os.path.join(HERE, "results", f"eval_{name}_eval.json")) as f:
        ref = json.load(f)
    out = {}
    for k, v in ref.items():
        if isinstance(v, dict) and k in res:
            out[k] = {kk: res[k][kk] - vv for kk, vv in v.items()
                      if isinstance(vv, (int, float)) and kk in res[k]}
        elif isinstance(v, (int, float)) and k in res:
            out[k] = res[k] - v
    return ref, out


def sidecar_trainer(name, dev, **over):
    """The Trainer of a checkpoint's sidecar config with `over` applied,
    on `dev`, its decoder's dropout 0."""
    from fresnel_tpu_torch.train import config as tconfig
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder

    with open(ckpt_path(name) + ".json") as f:
        meta = json.load(f)
    cfg = tconfig.TrainingConfig(**dict(meta["config"], **over))
    trainer = Trainer(cfg, tconfig.PhysicsConfig(**meta["physics_config"]),
                      tconfig.HFGSConfig(**meta["hfgs_config"]),
                      tconfig.HFTSConfig(**meta["hfts_config"]), device=dev)
    trainer.model = build_decoder(cfg, trainer.physics_config, dropout=0.0)
    return trainer


def view_batches(trainer, dataset, n):
    """n device batches of a view-aware run, each GT view drawn from the
    generator the batches are shuffled with, epoch after epoch."""
    rng = np.random.default_rng(0)
    out = []
    while len(out) < n:
        for b in dataset.batches(trainer.config.batch_size, rng):
            out.append(trainer.device_batch(b, rng))
    return out[:n]


def lap_timer():
    """(seconds by phase, lap): lap(name) adds the seconds since the last
    lap to phase `name`'s and returns them."""
    phase_s, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        dt, mark[0] = now - mark[0], now
        phase_s[name] = phase_s.get(name, 0.0) + dt
        return dt
    return phase_s, lap


def resume_reference(torch, dev, name, corpus, phase, seconds,
                     steps=TRAIN_REF_STEPS):
    """A full checkpoint's loaded state (params, moments, count) stepped
    `steps` times at its sidecar config cut by RESUME_REF, under
    the Trainer's own schedule (lr > 0 at the loaded count), on the card
    and on the CPU from the same batches of `corpus`, dropout 0: losses
    within REF_LOSS_RTOL relative, each params leaf's mean absolute
    difference within REF_PARAM_MEAN_TOL, each mu and nu leaf's within
    RESUME_MOMENT_RTOL of the leaf's mean absolute value, the count
    advanced on both, the params moved.  Logs `phase` (its seconds from
    `seconds()`)."""
    from fresnel_tpu_torch.data.dataset import ImageDataset

    runs = {}
    for which, d in (("card", dev), ("cpu", torch.device("cpu"))):
        tr = sidecar_trainer(name, d, **RESUME_REF)
        st, _ = tr.load_checkpoint(ckpt_path(name))
        count0 = int(st["opt_state"]["count"])
        loaded = {k: v.cpu() for k, v in st["params"].items()}
        lr = float(tr.optimizer.learning_rate(st["opt_state"]["count"]))
        ds = ImageDataset(corpus, image_size=RESUME_REF["image_size"],
                          use_augmentation=False, device=d)
        g_ = torch.Generator(device=d).manual_seed(1)
        losses = []
        for bb in view_batches(tr, ds, steps):
            st, ld = tr.train_step(st, bb, tr.config.gaussians_per_patch,
                                   None, g_)
            losses.append(float(ld["total"]))
        leaves = {part: {k: v.cpu() for k, v in tree.items()}
                  for part, tree in (("params", st["params"]),
                                     ("mu", st["opt_state"]["mu"]),
                                     ("nu", st["opt_state"]["nu"]))}
        moved = max((leaves["params"][k] - v).abs().max().item()
                    for k, v in loaded.items())
        runs[which] = dict(losses=losses, leaves=leaves, lr=lr, moved=moved,
                           count0=count0,
                           count=int(st["opt_state"]["count"]))
    card, cpu = runs["card"], runs["cpu"]
    loss_rel = max(abs(a - b_) / max(abs(b_), 1e-6)
                   for a, b_ in zip(card["losses"], cpu["losses"]))
    worst, worst_rel = {}, {}
    for part, tree in cpu["leaves"].items():
        diffs = {k: (card["leaves"][part][k] - v).abs().mean().item()
                 for k, v in tree.items()}
        worst[part] = max((d, k) for k, d in diffs.items())
        worst_rel[part] = max((d / max(tree[k].abs().mean().item(), 1e-30),
                               k) for k, d in diffs.items())
    log(phase, checkpoint=name, steps=steps, dropout=0.0,
        config=RESUME_REF, lr_at_resume=card["lr"], count=card["count"],
        params_moved_max=card["moved"], losses_card=card["losses"],
        losses_cpu=cpu["losses"], loss_rel_max=loss_rel,
        loss_rtol=REF_LOSS_RTOL, mean_abs_worst=worst,
        mean_abs_rel_worst=worst_rel, params_tol=REF_PARAM_MEAN_TOL,
        moments_rtol=RESUME_MOMENT_RTOL, phase_seconds=seconds())
    if not (card["lr"] > 0 and card["moved"] > 0
            and card["count"] == cpu["count"] == card["count0"] + steps
            and loss_rel <= REF_LOSS_RTOL
            and worst["params"][0] <= REF_PARAM_MEAN_TOL
            and worst_rel["mu"][0] <= RESUME_MOMENT_RTOL
            and worst_rel["nu"][0] <= RESUME_MOMENT_RTOL):
        fail(f"{name}'s resumed state's steps on the card disagree with the "
             "CPU's")


def infer_image(tmp):
    """The 512^2 PNG `cli infer` reads, made once under `tmp`."""
    from PIL import Image

    path = os.path.join(tmp, "scene.png")
    if not os.path.exists(path):
        Image.fromarray((smooth_image(512, 7).transpose(1, 2, 0)
                         * 255).astype(np.uint8)).save(path)
    return path


def infer_run(torch, name, img_path, tmp):
    """`cli infer` of checkpoint `name` on the card (host ms per call after
    a warmup, INFER_TIMED calls) and on the CPU: the Gaussians kept, and
    the card's PLY against the CPU's (rel_err, None if the counts
    differ)."""
    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core import io as gio

    card_ply = os.path.join(tmp, f"{name}_card.ply")
    cpu_ply = os.path.join(tmp, f"{name}_cpu.ply")
    argv = ["infer", img_path, card_ply, "--checkpoint", ckpt_path(name)]
    cli.main(argv)                                             # warmup
    ms = []
    for _ in range(INFER_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cli.main(argv[:2] + [cpu_ply] + argv[3:] + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    a, b = gio.load_ply(card_ply), gio.load_ply(cpu_ply)
    same_n = a.num_gaussians == b.num_gaussians
    return dict(host_ms=ms, host_ms_median=statistics.median(ms),
                kept_card=a.num_gaussians, kept_cpu=b.num_gaussians,
                cpu_seconds=cpu_s, rel_err=rel_err(a, b) if same_n else None)


def checkpoint_phases(torch, dev, path_launches, tmp):
    """Phases 25-31: the committed trained checkpoints on the card, their
    corpora made under `tmp`.  Returns K1's and K2's numbers at the eval
    and view packs."""
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
    from fresnel_tpu_torch.train.flax_msgpack import read_flat
    from fresnel_tpu_torch.train.harness import trainer_from_checkpoint

    counters = (raster, binning, stream_binning)
    phase_s, lap = lap_timer()

    # 25. ckpt_read: every committed checkpoint decoded and loaded into a
    # Trainer on the card.
    files = {}
    for name in CKPTS:
        t0 = time.perf_counter()
        flat = read_flat(ckpt_path(name))
        files[name] = dict(leaves=len(flat),
                           bytes=os.path.getsize(ckpt_path(name)),
                           seconds=time.perf_counter() - t0)
    loads = {}
    for name in CKPTS:
        t0 = time.perf_counter()
        tr = trainer_from_checkpoint(ckpt_path(name), dev)
        state, epoch = tr.load_checkpoint(ckpt_path(name))
        torch.cuda.synchronize()
        loads[name] = dict(
            seconds=time.perf_counter() - t0, epoch=epoch,
            step=int(state["step"]), count=int(state["opt_state"]["count"]),
            leaves=len(state["params"]),
            on_card=all(v.is_cuda for v in state["params"].values()))
    log("ckpt_read", files=files, loads=loads,
        phase_seconds=lap("ckpt_read"))
    if not all(v["on_card"] for v in loads.values()):
        fail("a committed checkpoint did not load onto the card")

    # 26. infer_path: `fresnel-torch infer` with a checkpoint, on the card
    # and on the CPU.
    img_path = infer_image(tmp)
    infer = {name: infer_run(torch, name, img_path, tmp)
             for name in ("exp2_k8", "exp2")}
    log("infer_path", image=512, rtol=INFER_RTOL, **infer,
        phase_seconds=lap("infer_path"))
    if not all(v["rel_err"] is not None
               and max(v["rel_err"].values()) <= INFER_RTOL
               for v in infer.values()):
        fail("the card's infer disagrees with the CPU's")

    # 27. eval_path: `fresnel-torch eval` of exp2_k8 and exp2 over
    # corpus_v1_eval (24 scenes at 256^2), with the grid.
    v1 = os.path.join(tmp, "corpus_v1_eval")
    t0 = time.perf_counter()
    synthetic_corpus.generate_corpus(v1, n_images=EVAL_SCENES,
                                     image_size=EVAL_SIZE, seed=EVAL_SEED)
    corpus_s = time.perf_counter() - t0
    evals = {}
    for name in ("exp2_k8", "exp2"):
        ev = eval_checkpoint(torch, name, v1, counters,
                             grid=os.path.join(tmp, f"{name}_grid.png"))
        if name == "exp2_k8":
            path_launches["eval"] = ev["launches"]
        ref, deltas = committed_deltas(name, ev["results"])
        evals[name] = ev
        log("eval_path", checkpoint=name, scenes=len(ev["samples"]),
            size=EVAL_SIZE, max_per_tile=ev["max_per_tile"],
            corpus_seconds=corpus_s, seconds=ev["seconds"],
            seconds_per_scene=ev["seconds_per_scene"],
            launches=ev["launches"], results=ev["results"],
            committed=ref, minus_committed=deltas, card_vs_cpu=ev["gate"],
            cpu_seconds=ev["cpu_seconds"], phase_seconds=lap("eval_path"))
        want = dict(k1=8 * EVAL_SCENES + 8, k2=0, k3=0, k4=0)
        if ev["launches"] != want or len(ev["samples"]) != EVAL_SCENES:
            fail(f"eval of {name} launched {ev['launches']} over "
                 f"{len(ev['samples'])} scenes, not {want}")
        if not ev["gate"]["ok"]:
            fail(f"the card's eval of {name} disagrees with the CPU's")

    # 28. eval_v2: v2combo on corpus_v2_eval's first scenes, with their GT
    # orbit views, the raytracer in parallel processes.
    v2 = os.path.join(tmp, "corpus_v2_eval")
    n_proc = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fresnel_tpu_torch.data.raytrace_corpus", v2,
         "--n_images", str(EVAL_V2_SCENES), "--seed", str(EVAL_V2_SEED),
         "--start", str(s), "--stride", str(n_proc)], cwd=HERE)
        for s in range(n_proc)]
    codes = [p.wait() for p in procs]
    v2_s = time.perf_counter() - t0
    if any(codes):
        fail(f"the corpus_v2 processes exited with {codes}")
    ev = eval_checkpoint(torch, "v2combo", v2, counters)
    ref, deltas = committed_deltas("v2combo", ev["results"])
    log("eval_v2", checkpoint="v2combo", scenes=len(ev["samples"]),
        processes=n_proc, corpus_seconds=v2_s, seconds=ev["seconds"],
        seconds_per_scene=ev["seconds_per_scene"], launches=ev["launches"],
        results=ev["results"], committed=ref, minus_committed=deltas,
        card_vs_cpu=ev["gate"], cpu_seconds=ev["cpu_seconds"],
        phase_seconds=lap("eval_v2"))
    if "per_view_ssim" not in ev["results"] or not ev["gate"]["ok"] \
            or len(ev["samples"]) != EVAL_V2_SCENES:
        fail("the v2combo eval has no per-view SSIM, or the card's "
             "disagrees with the CPU's")

    # K1 at the eval pack: exp2_k8's first scene from azimuth 90.
    g = evals["exp2_k8"]["samples"][0]["gaussians"]
    with torch.no_grad():
        tp = tile.pack_tiles(
            *[g[k] for k in FIELDS],
            Camera.from_pose(0.0, np.radians(90.0), EVAL_SIZE),
            tile.TileRendererConfig(max_per_tile=evals["exp2_k8"][
                "max_per_tile"]))
    k1_eval = pack_kernels(torch, raster, tp.pack, tp.counts, tp.n_tiles_x,
                           None, backward=False)
    lap("kernel_eval_packs")

    # 29. resume_path: `cli train --resume` from exp2's full checkpoint.
    corpus = os.path.join(tmp, "corpus_v1")
    synthetic_corpus.generate_corpus(corpus, n_images=TRAIN_SCENES,
                                     image_size=TRAIN["image_size"], seed=0)
    argv = ["--data_dir", corpus, "--output_dir", os.path.join(tmp, "resume"),
            "--epochs", str(RESUME_EPOCHS), "--batch_size", "8", "--lr",
            "2e-4", "--gaussians_per_patch", "4", "--surface_init",
            "--depth_offset_init", "-0.128", "--max_per_tile", "1024",
            "--no_augmentation", "--resume", ckpt_path("exp2"), "--device",
            "cuda"]
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    trainer, state = tcli.main(argv)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    path_launches["resume"] = read_counts(*counters)
    steps = int(state["step"]) - 6000
    # The first batch's loss at the resumed params against a random init
    # of the same config (dropout masks from one seed).
    dataset = ImageDataset(corpus, image_size=TRAIN["image_size"],
                           use_augmentation=False, device=dev)
    batch = trainer.device_batch(next(iter(dataset.batches(
        8, np.random.default_rng(0)))))
    back, _ = trainer.load_checkpoint(ckpt_path("exp2"))
    init = trainer.init_state()["params"]
    init["model.depth_offset"] = torch.tensor(-0.128, device=dev)
    with torch.no_grad():
        first = {k: float(trainer.loss(p, batch, 4, None, torch.Generator(
            device=dev).manual_seed(1))[0]) for k, p in (
                ("resumed", back["params"]), ("random_init", init))}
    log("resume_path", argv=argv, seconds=resume_s, steps=steps,
        launches=path_launches["resume"], epoch_losses=trainer.history,
        first_batch_loss=first, step=int(state["step"]),
        count=int(state["opt_state"]["count"]),
        phase_seconds=lap("resume_path"))
    if path_launches["resume"] != dict(k1=steps, k2=steps, k3=0, k4=0) \
            or steps != (RESUME_EPOCHS - 301) * (TRAIN_SCENES // 8):
        fail(f"the resume made {steps} steps and launched "
             f"{path_launches['resume']}")
    if not first["resumed"] < first["random_init"]:
        fail(f"the resumed model's loss is not below a random init's: "
             f"{first}")

    # The loaded full state stepped where the learning rate is positive,
    # card against CPU: a wrong mu, nu or count on the card shows here.
    resume_reference(torch, dev, "exp2", corpus, "resume_reference",
                     lambda: lap("resume_path"))

    # 30. view_train: `cli train --resume` from v2combo's thin params with
    # view_weight 0.5 on the first corpus_v2 scenes; then timed steps.
    argv = ["--data_dir", v2, "--max_images", str(VIEW_SCENES),
            "--output_dir", os.path.join(tmp, "view"),
            "--epochs", str(VIEW_EPOCHS), "--batch_size", str(VIEW_BATCH),
            "--lr", "2e-4", "--gaussians_per_patch", "8", "--train_encoder",
            "--surface_init", "--depth_offset_init", "-1.0",
            "--depth_z_scale", "2.0", "--z_offset_scale", "0.2",
            "--view_weight", "0.5", "--lpips_weight", "0",
            "--max_per_tile", "1024", "--no_augmentation", "--resume",
            ckpt_path("v2combo"), "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    trainer, state = tcli.main(argv)
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    path_launches["view_train"] = read_counts(*counters)
    steps = VIEW_EPOCHS - 225
    dataset = ImageDataset(v2, image_size=EVAL_SIZE, use_augmentation=False,
                           max_images=VIEW_SCENES, device=dev)
    batches = view_batches(trainer, dataset, VIEW_TIMED + 1)
    gen = torch.Generator(device=dev).manual_seed(1)
    state, _ = trainer.train_step(state, batches[0], 8, None, gen)
    events, lds = [], []
    for b in batches[1:]:
        ev_ = (torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
        ev_[0].record()
        state, ld = trainer.train_step(state, b, 8, None, gen)
        ev_[1].record()
        events.append(ev_)
        lds.append(ld)
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in events]
    view_terms = [{k: float(v) for k, v in ld.items()} for ld in lds]
    log("view_train", argv=argv, seconds=view_s, steps=steps,
        launches=path_launches["view_train"], epoch_losses=trainer.history,
        timed_steps=VIEW_TIMED, ms_per_step=ms,
        ms_per_step_median=statistics.median(ms), loss_terms=view_terms,
        phase_seconds=lap("view_train"))
    if path_launches["view_train"] != dict(k1=2 * steps, k2=2 * steps, k3=0,
                                           k4=0):
        fail(f"view-aware training launched {path_launches['view_train']} "
             f"in {steps} steps")
    if not all(np.isfinite(t["total"]) and t["view"] > 0
               for t in view_terms):
        fail("a view-aware loss is not finite or has no view term")

    # K1 and K2 at the view pack: the last batch's clouds, each under its
    # GT view's camera (one image per camera).
    b = batches[-1]
    with torch.no_grad():
        out = trainer.decode(state["params"], trainer.encode(
            state["params"], b["image"]), b["depth"])
        cams = [Camera.from_pose(0.0, a, EVAL_SIZE) for a in b["view_az_rad"]]
        bp = tile.pack_tiles_batched(*[out[k] for k in FIELDS], cams,
                                     trainer.renderer.config)
    k12_view = pack_kernels(torch, raster, bp.pack, bp.counts, bp.n_tiles_x,
                            bp.tiles_per_image, backward=True)
    log("kernel_eval_packs", eval_pack=k1_eval, view_pack=k12_view,
        k1_tol=KERNEL_TOL, k2_tol=KERNEL_BWD_TOL,
        phase_seconds=lap("kernel_eval_packs"))
    if not (k1_eval["k1_max_abs_err"] <= KERNEL_TOL
            and k12_view["k1_max_abs_err"] <= KERNEL_TOL
            and k12_view["k2_rel_err"] <= KERNEL_BWD_TOL):
        fail("K1 / K2 disagree with their plain versions at the eval or "
             "view pack")

    # 31. view_reference: a small view-aware config on the card and on the
    # CPU from one init, dropout 0, 3 steps.
    from fresnel_tpu_torch.data import raytrace_corpus
    small = os.path.join(tmp, "corpus_v2_small")
    raytrace_corpus.generate_corpus(small, n_images=2,
                                    image_size=VIEW_REF["image_size"],
                                    seed=EVAL_V2_SEED)
    ds = ImageDataset(small, image_size=VIEW_REF["image_size"],
                      use_augmentation=False, device=dev)
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        tr, st = train_setup(torch, d, VIEW_REF,
                             os.path.join(tmp, f"vref_{name}"), dropout=0.0)
        tr._make_optimizer(TRAIN_REF_STEPS)
        g_ = torch.Generator(device=d).manual_seed(1)
        losses = []
        for bb in view_batches(tr, ds, TRAIN_REF_STEPS):
            st, ld = tr.train_step(st, bb, VIEW_REF["gaussians_per_patch"],
                                   None, g_)
            losses.append({k: float(v) for k, v in ld.items()})
        runs[name] = (losses, {k: v.cpu() for k, v in st["params"].items()})
    (lg, pg), (lc, pc) = runs["card"], runs["cpu"]
    loss_rel = max(abs(a[k] - b_[k]) / max(abs(b_[k]), 1e-6)
                   for a, b_ in zip(lg, lc) for k in ("total", "view"))
    mean_abs = {k: (pg[k] - pc[k]).abs().mean().item() for k in pc}
    held = {k: v for k, v in mean_abs.items()
            if not re.search(REF_ZERO_GRAD, k)}
    log("view_reference", steps=TRAIN_REF_STEPS, dropout=0.0,
        config={k: VIEW_REF[k] for k in (
            "image_size", "feature_size", "encoder_width",
            "gaussians_per_patch", "batch_size", "view_weight",
            "z_offset_scale", "depth_z_scale")},
        losses_card=[x["total"] for x in lg],
        losses_cpu=[x["total"] for x in lc],
        view_card=[x["view"] for x in lg], view_cpu=[x["view"] for x in lc],
        loss_rel_max=loss_rel, loss_rtol=REF_LOSS_RTOL,
        param_mean_abs_worst=dict(sorted(held.items(),
                                         key=lambda kv: -kv[1])[:5]),
        param_mean_abs_tol=REF_PARAM_MEAN_TOL,
        phase_seconds=lap("view_reference"))
    if not (loss_rel <= REF_LOSS_RTOL
            and max(held.values()) <= REF_PARAM_MEAN_TOL):
        fail("the card's view-aware steps disagree with the CPU's")
    log("checkpoint_phases", seconds=phase_s,
        total_seconds=sum(phase_s.values()), cap_seconds=CKPT_PHASES_CAP_S)
    return k1_eval, k12_view


def exp4_phases(torch, dev, path_launches, tmp):
    """Phases 32-37: experiment 4 (the Fibonacci spiral decoder), its
    teacher fits and distilled training, and the 74^2 decoders, on the
    card, the corpora under `tmp` (made by checkpoint_phases, or here when
    run alone).  Returns K1's and K2's numbers at the M 384 pack and at
    exp4_budget's training pack."""
    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import fit_teacher
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    v1 = os.path.join(tmp, "corpus_v1_eval")
    corpus = os.path.join(tmp, "corpus_v1")
    synthetic_corpus.generate_corpus(v1, n_images=EVAL_SCENES,
                                     image_size=EVAL_SIZE, seed=EVAL_SEED)
    synthetic_corpus.generate_corpus(corpus, n_images=TRAIN_SCENES,
                                     image_size=TRAIN["image_size"], seed=0)

    # 32-33. exp4_ckpt and upsample_ckpt: `cli infer` of exp4, exp4_budget
    # and exp2_g74zi, card against CPU; `cli eval` of those and exp2_e74
    # over corpus_v1_eval beside the committed TPU evaluations.
    img_path = infer_image(tmp)
    image = cli._load_image(img_path)
    evals = {}
    for name in EXP4_EVALS:
        phase = "exp4_ckpt" if name.startswith("exp4") else "upsample_ckpt"
        inf = None
        if name in INFER_N:
            decoded = cli.infer(image, ckpt_path(name),
                                device=dev).num_gaussians
            inf = dict(infer_run(torch, name, img_path, tmp),
                       decoded=decoded)
        ev = eval_checkpoint(torch, name, v1, counters)
        path_launches[f"eval_{name}"] = ev["launches"]
        ref, deltas = committed_deltas(name, ev["results"])
        evals[name] = ev
        log(phase, checkpoint=name, infer=inf, infer_rtol=INFER_RTOL,
            scenes=len(ev["samples"]), size=EVAL_SIZE,
            max_per_tile=ev["max_per_tile"], seconds=ev["seconds"],
            seconds_per_scene=ev["seconds_per_scene"],
            launches=ev["launches"], results=ev["results"], committed=ref,
            minus_committed=deltas,
            committed_tol=dict(frontal_ssim=COMMITTED_SSIM_TOL,
                               frontal_psnr=COMMITTED_PSNR_TOL),
            card_vs_cpu=ev["gate"], cpu_seconds=ev["cpu_seconds"],
            phase_seconds=lap(phase))
        if inf is not None and not (
                inf["decoded"] == INFER_N[name] and inf["rel_err"]
                and max(inf["rel_err"].values()) <= INFER_RTOL):
            fail(f"the card's infer of {name} disagrees with the CPU's, or "
                 f"decoded {inf['decoded']} Gaussians")
        want = dict(k1=8 * EVAL_SCENES, k2=0, k3=0, k4=0)
        if ev["launches"] != want or len(ev["samples"]) != EVAL_SCENES:
            fail(f"eval of {name} launched {ev['launches']} over "
                 f"{len(ev['samples'])} scenes, not {want}")
        if not ev["gate"]["ok"]:
            fail(f"the card's eval of {name} disagrees with the CPU's")
        if not (abs(deltas["frontal_ssim"]) <= COMMITTED_SSIM_TOL
                and abs(deltas["frontal_psnr"]) <= COMMITTED_PSNR_TOL):
            fail(f"the eval of {name} is off its committed evaluation: "
                 f"{deltas['frontal_ssim']}, {deltas['frontal_psnr']} dB")

    # 34. teacher_fit4: `fit_teacher.main --experiment 4` over the first
    # training scenes, then one scene's fit on the card against the CPU.
    argv = ["--data_dir", corpus, "--scenes", str(TEACHER["scenes"]),
            "--experiment", "4", "--grid", str(TEACHER["grid"]),
            "--steps", str(TEACHER["steps"]), "--res", str(TEACHER["res"]),
            "--overwrite", "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    records = fit_teacher.main(argv)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    path_launches["teacher_fit4"] = read_counts(*counters)
    sample = ImageDataset(corpus, image_size=TEACHER["res"],
                          use_augmentation=False, max_images=1,
                          device=dev)._samples[0]
    kw = dict(steps=TEACHER_REF_STEPS, grid=TEACHER["grid"], K=1,
              res=TEACHER["res"], experiment=4)
    scene = np.ascontiguousarray(sample.image.transpose(2, 0, 1))
    tg, mg = fit_teacher.fit_scene(scene, sample.depth, device=dev, **kw)
    tc, mc = fit_teacher.fit_scene(scene, sample.depth, device=cpu, **kw)
    raw_d = np.abs(tg["raw"] - tc["raw"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mg["losses"],
                                                       mc["losses"]))
    dos = [r["depth_offset"] for r in records]
    ms_step = [r["seconds"] / r["steps"] * 1e3 for r in records]
    n, steps = TEACHER["scenes"], TEACHER["steps"]
    log("teacher_fit4", argv=argv, seconds=fit_s,
        launches=path_launches["teacher_fit4"], per_scene=records,
        ssim_mean=float(np.mean([r["ssim"] for r in records])),
        psnr_mean=float(np.mean([r["psnr"] for r in records])),
        depth_offset_mean=float(np.mean(dos)),
        depth_offset_sd=float(np.std(dos)),
        ms_per_step=ms_step, ms_per_step_median=statistics.median(ms_step),
        reference=dict(steps=TEACHER_REF_STEPS, losses_card=mg["losses"],
                       losses_cpu=mc["losses"], loss_rel_max=loss_rel,
                       loss_rtol=REF_LOSS_RTOL,
                       raw_mean_abs=float(raw_d.mean()),
                       raw_max_abs=float(raw_d.max()),
                       raw_mean_tol=REF_RAW_MEAN_TOL),
        phase_seconds=lap("teacher_fit4"))
    if path_launches["teacher_fit4"] != dict(k1=(steps + 1) * n,
                                             k2=steps * n, k3=0, k4=0):
        fail(f"the teacher fits launched {path_launches['teacher_fit4']}")
    if len(records) != n or not all(np.isfinite(r["ssim"])
                                    for r in records):
        fail("a teacher fit did not finish with a finite SSIM")
    if not (loss_rel <= REF_LOSS_RTOL and raw_d.mean() <= REF_RAW_MEAN_TOL):
        fail("the card's experiment-4 teacher fit disagrees with the CPU's")

    # 35. distill_train4: `cli train --experiment 4` with distillation from
    # those sidecars at exp4_budget's width, then timed steps.
    argv = ["--data_dir", corpus, "--max_images", str(TEACHER["scenes"]),
            "--output_dir", os.path.join(tmp, "distill4"), "--experiment",
            "4", "--n_spiral_points", str(TEACHER["grid"]), "--epochs",
            str(DISTILL_EPOCHS), "--batch_size", "8", "--lr", "2e-4",
            "--surface_init", "--max_per_tile", "1024", "--distill_weight",
            "1.0", "--distill_decay_epochs", "2", "--no_augmentation",
            "--lpips_weight", "0", "--device", "cuda"]
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    trainer, state = tcli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    path_launches["distill_train4"] = read_counts(*counters)
    dataset = ImageDataset(corpus, image_size=EVAL_SIZE,
                           use_augmentation=False,
                           max_images=TEACHER["scenes"], teacher_experiment=4,
                           device=dev)
    batches = [trainer.device_batch(b) for b in train_batches(
        dataset, 8, DISTILL_TIMED + 1)]
    gen = torch.Generator(device=dev).manual_seed(1)
    state, _ = trainer.train_step(state, batches[0], 4, None, gen)
    events, lds = [], []
    for b in batches[1:]:
        ev_ = (torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
        ev_[0].record()
        state, ld = trainer.train_step(state, b, 4, None, gen)
        ev_[1].record()
        events.append(ev_)
        lds.append(ld)
    torch.cuda.synchronize()
    ms = [s_.elapsed_time(e) for s_, e in events]
    hist = trainer.history
    log("distill_train4", argv=argv, seconds=train_s,
        launches=path_launches["distill_train4"],
        distill_per_epoch=hist.get("distill"), total_per_epoch=hist["total"],
        distill_scale_per_epoch=[max(0.0, 1.0 - e / 2)
                                 for e in range(DISTILL_EPOCHS)],
        timed_steps=DISTILL_TIMED, ms_per_step=ms,
        ms_per_step_median=statistics.median(ms),
        loss_terms=[{k: float(v) for k, v in ld.items()} for ld in lds],
        phase_seconds=lap("distill_train4"))
    if path_launches["distill_train4"] != dict(k1=DISTILL_EPOCHS,
                                               k2=DISTILL_EPOCHS, k3=0, k4=0):
        fail(f"distilled training launched {path_launches['distill_train4']}"
             f" in {DISTILL_EPOCHS} steps")
    if not (len(hist.get("distill", [])) == DISTILL_EPOCHS
            and np.all(np.isfinite(hist["total"]))
            and all(np.isfinite(float(ld["distill"])) for ld in lds)):
        fail("a distilled step has no finite distill term")

    # The same config at 64^2, batch 2, dropout 0, card against CPU.
    runs = {}
    for which, d in (("card", dev), ("cpu", cpu)):
        tr = sidecar_trainer("exp4_budget", d,
                             n_spiral_points=TEACHER["grid"], **DISTILL_REF)
        ds = ImageDataset(corpus, image_size=DISTILL_REF["image_size"],
                          use_augmentation=False,
                          max_images=TEACHER["scenes"], teacher_experiment=4,
                          device=d)
        bbs = view_batches(tr, ds, DISTILL_REF_STEPS)
        st = tr.init_state()
        st["params"]["model.depth_offset"] = bbs[0]["teacher_do"].mean()
        g_ = torch.Generator(device=d).manual_seed(1)
        losses = []
        for i, bb in enumerate(bbs):
            bb["distill_scale"] = 1.0 - i / 2
            st, ld = tr.train_step(st, bb, 4, None, g_)
            losses.append({k: float(v) for k, v in ld.items()})
        runs[which] = (losses, {k: v.cpu() for k, v in st["params"].items()})
    (lg, pg), (lc, pc) = runs["card"], runs["cpu"]
    loss_rel = max(abs(a[k] - b_[k]) / max(abs(b_[k]), 1e-6)
                   for a, b_ in zip(lg, lc) for k in ("total", "distill"))
    mean_abs = {k: (pg[k] - pc[k]).abs().mean().item() for k in pc}
    log("distill_reference", steps=DISTILL_REF_STEPS, dropout=0.0,
        config=DISTILL_REF, losses_card=lg, losses_cpu=lc,
        loss_rel_max=loss_rel, loss_rtol=REF_LOSS_RTOL,
        param_mean_abs_worst=dict(sorted(mean_abs.items(),
                                         key=lambda kv: -kv[1])[:5]),
        param_mean_abs_tol=DISTILL_PARAM_MEAN_TOL,
        phase_seconds=lap("distill_train4"))
    if not (loss_rel <= REF_LOSS_RTOL
            and max(mean_abs.values()) <= DISTILL_PARAM_MEAN_TOL):
        fail("the card's distilled steps disagree with the CPU's")

    # 36. kernel_exp4_packs: K1 and K2 at the M 384 pack (exp4's first eval
    # scene under the training camera, as its teacher fit renders it) and
    # at exp4_budget's training pack (the last timed batch's 8 clouds).
    g = evals["exp4"]["samples"][0]["gaussians"]
    with torch.no_grad():
        tp = tile.pack_tiles(*[g[k] for k in FIELDS],
                             Camera.default_training(EVAL_SIZE),
                             tile.TileRendererConfig(max_per_tile=1024))
        b = batches[-1]
        out = trainer.decode(state["params"], b["features"], b["depth"])
        bp = tile.pack_tiles_batched(*[out[k] for k in FIELDS],
                                     trainer.camera, trainer.renderer.config)
    k_m384 = pack_kernels(torch, raster, tp.pack, tp.counts, tp.n_tiles_x,
                          None, backward=True)
    k_train = pack_kernels(torch, raster, bp.pack, bp.counts, bp.n_tiles_x,
                           bp.tiles_per_image, backward=True)
    log("kernel_exp4_packs", m384_pack=k_m384, train_pack=k_train,
        k1_tol=KERNEL_TOL, k2_tol=KERNEL_BWD_TOL,
        phase_seconds=lap("kernel_exp4_packs"))
    if (k_m384["M"], k_train["T"], k_train["M"]) != (384, 8 * 256, 1024):
        fail(f"the exp-4 packs are not M 384 and (2048, 1024): "
             f"{k_m384['M']}, {k_train['T']}, {k_train['M']}")
    if not all(k["k1_max_abs_err"] <= KERNEL_TOL
               and k["k2_rel_err"] <= KERNEL_BWD_TOL
               for k in (k_m384, k_train)):
        fail("K1 / K2 disagree with their plain versions at an exp-4 pack")

    # 37. exp4_resume_reference: exp4's full state stepped on the card and
    # on the CPU.
    resume_reference(torch, dev, "exp4", corpus, "exp4_resume_reference",
                     lambda: lap("exp4_resume_reference"), EXP4_RESUME_STEPS)
    log("exp4_phases", seconds=phase_s, total_seconds=sum(phase_s.values()),
        cap_seconds=EXP4_PHASES_CAP_S)
    return k_m384, k_train


# The CVS consistency view synthesizer (phases 38-43).  The campaign's
# config (cloud/train_cvs_fullwidth.sh, round5_queue1.sh): 256^2, base 128,
# batch 4, --use_amp, --concat_input_view.  The datasets: 4 scenes each
# (cut from the campaign's 120-160); the experiment-2 teachers of 4 scenes
# of the 256^2 training corpus, fitted for 50 Adam steps of 800.
CVS_SIZE = 256
CVS_FULL = dict(image_size=CVS_SIZE, base_channels=128, batch_size=4,
                use_amp=True, concat_input_view=True, epochs=3,
                save_interval=100)
CVS_SCENES, CVS_TEACHER_STEPS = 4, 25
CVS_WARMUP, CVS_TIMED, CVS_F32_TIMED, CVS_PROFILED = 2, 12, 3, 3
# cvs_reference: the JAX trainer's defaults (64^2, base 64: attention at
# the 16 and 8 levels), fp32, batch 2, 2 steps with the same draws.
CVS_REF = dict(image_size=64, base_channels=64, batch_size=2,
               use_quality_aware=True, concat_input_view=True)
CVS_REF_STEPS = 2
CVS_PARAM_MEAN_TOL = 1e-6
CVS_GEN_TOL = 1e-4
# The attention key bias has no gradient in exact arithmetic (the softmax
# removes a per-query constant): Adam steps it on rounding noise.
CVS_ZERO_GRAD = r"key\.bias$"
# Each view's and target depth's mean absolute card-CPU difference.  The
# teacher clouds are depth-locked surfaces: under an orbit pose their
# near-equal depths sort apart on the card and the CPU by a rounding, and
# the compositing order flips at a few pixels (up to 1.4e-2 there on an
# H100), as in the render slice's box-edge flips; the number of values
# beyond the tolerance is logged.
CVS_VIEW_TOL = 1e-5
CVS_GEN_TIMED = 5
# cvs_multiview: 8 orbit views, the 3DGS fit of 2 000 Gaussians cut from
# 300 Adam steps to 50; card against CPU over 1 step (each CPU step of
# the 8-view pack took ~20 s).
CVS_VIEWS, CVS_FIT_STEPS, CVS_FIT_REF_STEPS = 8, 50, 1
# The new phases' time on the card, which they are meant to keep to.
CVS_PHASES_CAP_S = 90.0


def cvs_corpora(tmp):
    """The 256^2 training corpus's first CVS_SCENES scenes (copied to their
    own directory, for their experiment-2 teachers) and corpus_v2_eval's,
    made under `tmp` where checkpoint_phases has not made them."""
    from fresnel_tpu_torch.data import synthetic_corpus

    corpus = os.path.join(tmp, "corpus_v1")
    synthetic_corpus.generate_corpus(corpus, n_images=CVS_SCENES,
                                     image_size=CVS_SIZE, seed=0)
    teach = os.path.join(tmp, "cvs_teacher")
    os.makedirs(teach, exist_ok=True)
    for i in range(CVS_SCENES):
        for suffix in (".png", "_depth.bin"):
            shutil.copy(os.path.join(corpus, f"scene_{i:04d}{suffix}"), teach)
    v2 = os.path.join(tmp, "corpus_v2_eval")
    if all(os.path.exists(os.path.join(v2, f"scene_{i:04d}_views.npz"))
           for i in range(CVS_SCENES)):
        return teach, v2
    n_proc = max(1, min(CVS_SCENES, os.cpu_count() or 1))
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "from fresnel_tpu_torch.data import raytrace_corpus as r;"
         f" r.generate_corpus({v2!r}, {CVS_SCENES}, {CVS_SIZE}, "
         f"{EVAL_V2_SEED}, start={i}, stride={n_proc})"], cwd=HERE)
        for i in range(n_proc)]
    if any(p.wait() for p in procs):
        fail("the corpus_v2 processes failed")
    return teach, v2


def cvs_phases(torch, dev, path_launches, tmp):
    """Phases 38-43: the CVS family on the card (its three datasets,
    training at full width in bf16, resume, generation, multi-view
    generation and its 3DGS fit), the corpora under `tmp`.  Returns K1's
    numbers at the teacher render pack and K1's and K2's at the
    optimize_3dgs pack."""
    import contextlib
    import io
    from pathlib import Path

    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.inference import cvs_multiview
    from fresnel_tpu_torch.losses.ssim import ssim
    from fresnel_tpu_torch.models.decoders import head_transform
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import fit_teacher, train_cvs

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    teach, v2 = cvs_corpora(tmp)
    lap("cvs_corpora")

    # 38. cvs_data: the three datasets on the card, each against the same
    # dataset built on the CPU.
    reset_counts(*counters)
    fit_teacher.main(["--data_dir", teach, "--steps", str(CVS_TEACHER_STEPS),
                      "--res", str(CVS_SIZE), "--experiment", "2",
                      "--device", str(dev)])
    path_launches["cvs_teacher_fit"] = read_counts(*counters)
    teacher_s = lap("cvs_data")
    builds = dict(
        bootstrap=lambda d: train_cvs.GaussianBootstrapDataset(
            n_scenes=CVS_SCENES, image_size=CVS_SIZE, device=d),
        teacher=lambda d: train_cvs.TeacherMultiviewDataset(
            teach, image_size=CVS_SIZE, device=d),
        gt=lambda d: train_cvs.GTMultiviewDataset(
            v2, image_size=CVS_SIZE, max_scenes=CVS_SCENES, device=d))
    data, stats = {}, {}
    for name, build in builds.items():
        reset_counts(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data[name] = build(dev)
        seconds = time.perf_counter() - t0
        path_launches[f"cvs_data_{name}"] = read_counts(*counters)
        ref = build(cpu)
        pairs = list(zip(data[name]._samples, ref._samples))
        errs = {k: max(float(np.abs(a[k] - b[k]).max()) for a, b in pairs)
                for k in ("input_image", "target_image", "target_depth",
                          "features", "R_rel", "t_rel")}
        views_mean = {k: max(float(np.abs(a[k] - b[k]).mean())
                             for a, b in pairs)
                      for k in ("input_image", "target_image",
                                "target_depth")}
        views_over = {k: int(sum((np.abs(a[k] - b[k]) > CVS_VIEW_TOL).sum()
                                 for a, b in pairs))
                      for k in ("input_image", "target_image",
                                "target_depth")}
        fscale = max(float(np.abs(s["features"]).max())
                     for s in ref._samples)
        stats[name] = dict(pairs=len(data[name]), seconds=seconds,
                           k1=path_launches[f"cvs_data_{name}"]["k1"],
                           max_abs_vs_cpu=errs, mean_abs_vs_cpu=views_mean,
                           values_over_tol=views_over, features_scale=fscale)
        if not (len(data[name]) == len(ref)
                and max(views_mean.values()) <= CVS_VIEW_TOL
                and errs["features"] <= 1e-4 * fscale
                and max(errs["R_rel"], errs["t_rel"]) <= 1e-6):
            fail(f"the {name} dataset on the card disagrees with the CPU's: "
                 f"{errs}, {views_mean}")
    log("cvs_data", teacher_fits=dict(
        scenes=CVS_SCENES, steps=CVS_TEACHER_STEPS, seconds=teacher_s,
        launches=path_launches["cvs_teacher_fit"]), datasets=stats,
        view_tol=CVS_VIEW_TOL, phase_seconds=lap("cvs_data"))
    if (stats["bootstrap"]["k1"], stats["teacher"]["k1"],
            stats["gt"]["k1"]) != (4 * CVS_SCENES, 4 * CVS_SCENES, 0):
        fail(f"the datasets launched K1 {[s['k1'] for s in stats.values()]} "
             "times")

    # 39. cvs_reference: the JAX trainer's defaults, fp32, card against
    # CPU from one init with the same draws.
    ref_ds = train_cvs.GaussianBootstrapDataset(
        n_scenes=1, views_per_scene=3, image_size=CVS_REF["image_size"],
        device=cpu)
    batch = next(iter(ref_ds.batches(CVS_REF["batch_size"],
                                     np.random.default_rng(0))))
    drng = np.random.default_rng(11)
    draws = [(torch.from_numpy(drng.integers(0, 1000, CVS_REF["batch_size"])),
              torch.from_numpy(drng.normal(size=batch["target_image"].shape)
                               .astype(np.float32)))
             for _ in range(CVS_REF_STEPS)]
    gnoise = torch.from_numpy(drng.normal(size=(
        CVS_REF["batch_size"], 3, CVS_REF["image_size"],
        CVS_REF["image_size"])).astype(np.float32))
    runs = {}
    for which, d in (("card", dev), ("cpu", cpu)):
        t = train_cvs.CVSTrainer(train_cvs.CVSTrainConfig(**CVS_REF),
                                 device=d)
        st, b = t.init_state(), t.device_batch(batch)
        losses = []
        for ts, noise in draws:
            st, ld = t.train_step(st, b, 0.5, ts.to(d), noise.to(d))
            losses.append({k: float(v) for k, v in ld.items()})
        gens = {n: t.generate(st, b["features"], b["R_rel"], b["t_rel"],
                              gnoise, n, input_image=b["input_image"]).cpu()
                for n in (1, 4)}
        runs[which] = (losses, {g: {k: v.cpu() for k, v in tree.items()}
                                for g, tree in (
                                    ("params", st["params"]),
                                    ("ema_params", st["ema_params"]),
                                    ("mu", st["opt_state"]["mu"]),
                                    ("nu", st["opt_state"]["nu"]))}, gens)
    (lg, tg, gg), (lc, tc, gc) = runs["card"], runs["cpu"]
    loss_rel = max(abs(a[k] - b_[k]) / max(abs(b_[k]), 1e-6)
                   for a, b_ in zip(lg, lc) for k in b_)
    worst = {}
    for part, tree in tc.items():
        held = {k: v for k, v in tree.items()
                if not re.search(CVS_ZERO_GRAD, k)}
        if part in ("params", "ema_params"):
            worst[part] = max(((tg[part][k] - v).abs().mean().item(), k)
                              for k, v in held.items())
        else:
            worst[part] = max(((tg[part][k] - v).abs().mean().item()
                               / max(v.abs().mean().item(), 1e-30), k)
                              for k, v in held.items())
    gen_err = {n: ((gg[n] - gc[n]).abs().max()
                   / gc[n].abs().max()).item() for n in gc}
    log("cvs_reference", config=CVS_REF, steps=CVS_REF_STEPS,
        losses_card=lg, losses_cpu=lc, loss_rel_max=loss_rel,
        loss_rtol=REF_LOSS_RTOL, params_mean_abs_worst=worst["params"],
        ema_mean_abs_worst=worst["ema_params"],
        mu_mean_abs_rel_worst=worst["mu"], nu_mean_abs_rel_worst=worst["nu"],
        params_tol=CVS_PARAM_MEAN_TOL, moments_rtol=RESUME_MOMENT_RTOL,
        generate_rel_err=gen_err, generate_tol=CVS_GEN_TOL,
        phase_seconds=lap("cvs_reference"))
    if not (loss_rel <= REF_LOSS_RTOL
            and worst["params"][0] <= CVS_PARAM_MEAN_TOL
            and worst["ema_params"][0] <= CVS_PARAM_MEAN_TOL
            and worst["mu"][0] <= RESUME_MOMENT_RTOL
            and worst["nu"][0] <= RESUME_MOMENT_RTOL
            and max(gen_err.values()) <= CVS_GEN_TOL):
        fail("the card's CVS steps or generation disagree with the CPU's")

    # 40. cvs_train: the campaign's config at full width on the teacher
    # pairs, bf16, then float32.
    out_dir = os.path.join(tmp, "cvs_train")
    train_res = {}
    for amp in (True, False):
        cfg = train_cvs.CVSTrainConfig(**dict(CVS_FULL, use_amp=amp,
                                              output_dir=out_dir))
        t = train_cvs.CVSTrainer(cfg, device=dev)
        n_timed = CVS_TIMED if amp else CVS_F32_TIMED
        bs = [t.device_batch(b) for b in train_batches(
            data["teacher"], cfg.batch_size, CVS_WARMUP + n_timed)]
        gen = torch.Generator(device=dev).manual_seed(1)
        st = t.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i, b in enumerate(bs):
            ts, noise = t.draw(b, gen)
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            st, ld = t.train_step(st, b, 0.1, ts, noise)
            end.record()
            losses.append(ld["total"])
            if i >= CVS_WARMUP:
                ms.append((start, end))
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in ms]
        losses = torch.stack(losses).cpu().tolist()
        res = dict(steps=len(ms), ms_per_step=statistics.median(ms),
                   ms=ms, images_per_s=cfg.batch_size * 1e3
                   / statistics.median(ms),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   losses=losses)
        if amp:
            def steps():
                nonlocal st
                for b in bs[:CVS_PROFILED]:
                    ts, noise = t.draw(b, gen)
                    st, _ = t.train_step(st, b, 0.1, ts, noise)
            prof = profile_ms(torch, steps, CVS_PROFILED)
            res.update(device_ms_per_step=prof["device_ms"],
                       wall_ms_per_step=prof["wall_ms"],
                       device_busy_share=prof["device_busy_share"],
                       kernels_per_step=prof["kernels"],
                       top_kernels_ms_per_step=prof["top_kernels_ms"])
        train_res["bf16" if amp else "fp32"] = res
        if not np.all(np.isfinite(losses)):
            fail(f"a full-width CVS loss is not finite: {losses}")
        del t, st, bs
    log("cvs_train", config=CVS_FULL, dataset="teacher",
        pairs=len(data["teacher"]), **train_res,
        phase_seconds=lap("cvs_train"))

    # 41. cvs_resume: train_cvs.main with --stop_epoch, then --resume from
    # its .pt; the epoch and the ramp continue.
    res_dir = os.path.join(tmp, "cvs_resume")
    argv = ["--data_dir", teach, "--dataset_cache",
            os.path.join(tmp, "cvs_cache.npz"), "--image_size",
            str(CVS_FULL["image_size"]), "--base_channels",
            str(CVS_FULL["base_channels"]), "--batch_size", "4", "--use_amp",
            "--concat_input_view", "--epochs", "3", "--output_dir", res_dir,
            "--device", str(dev)]
    logs = []
    for extra in (["--stop_epoch", "1"],
                  ["--resume", os.path.join(res_dir, "cvs.pt")]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_cvs.main(argv + extra)
        logs.append(buf.getvalue())
    epochs = [re.findall(r"epoch (\d+)/3 cw=([\d.]+) total=([\d.naninf]+)",
                         s) for s in logs]
    final = os.path.join(res_dir, "cvs_final.pt")
    meta = json.loads(open(final + ".json").read())
    log("cvs_resume", segments=[[list(e) for e in seg] for seg in epochs],
        continued="continuing at 1" in logs[1], final_epoch=meta["epoch"],
        phase_seconds=lap("cvs_resume"))
    if not ([e[:2] for e in epochs[0]] == [("1", "0.10")]
            and [e[:2] for e in epochs[1]] == [("2", "0.20"), ("3", "0.30")]
            and "continuing at 1" in logs[1] and meta["epoch"] == 2):
        fail(f"the resumed CVS run did not continue: {epochs}")

    # 42. cvs_generate: one-step and 4-step generation at 256^2, batch 1,
    # bf16 and fp32, from the resumed state; one-step SSIM / PSNR against
    # the teacher pairs' targets.
    gen_res = {}
    for amp in (True, False):
        t = train_cvs.CVSTrainer(train_cvs.CVSTrainConfig(
            **dict(CVS_FULL, use_amp=amp)), device=dev)
        st, _ = t.load_checkpoint(final)
        b = t.device_batch(next(iter(data["teacher"].batches(
            1, np.random.default_rng(2)))))
        noise = torch.randn((1, 3, CVS_SIZE, CVS_SIZE), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(3))
        key = "bf16" if amp else "fp32"
        for n in (1, 4):
            gen_res[f"{key}_{n}step_ms"] = cuda_median_ms(
                torch, lambda: t.generate(st, b["features"], b["R_rel"],
                                          b["t_rel"], noise, n,
                                          input_image=b["input_image"]),
                n=CVS_GEN_TIMED, warmup=2)
        if amp:
            pairs = t.device_batch(next(iter(data["teacher"].batches(
                len(data["teacher"]), np.random.default_rng(0),
                shuffle=False))))
            g = torch.Generator(device=dev).manual_seed(4)
            z = torch.randn(tuple(pairs["target_image"].shape), device=dev,
                            generator=g)
            out = t.generate(st, pairs["features"], pairs["R_rel"],
                             pairs["t_rel"], z, 1,
                             input_image=pairs["input_image"]).clamp(0, 1)
            tgt = pairs["target_image"]
            mse = ((out - tgt) ** 2).mean(dim=(1, 2, 3))
            gen_res["one_step_ssim"] = float(ssim(out, tgt))
            gen_res["one_step_psnr"] = float((-10 * torch.log10(
                mse.clamp(min=1e-10))).mean())
            gen_res["pairs"] = int(tgt.shape[0])
        del t, st
    log("cvs_generate", size=CVS_SIZE, batch=1, timed=CVS_GEN_TIMED, **gen_res,
        note="SSIM / PSNR: a sanity number of 3 epochs on 12 pairs",
        phase_seconds=lap("cvs_generate"))

    # 43. cvs_multiview: cvs_multiview.main with the resumed state, 8 orbit
    # views, then the 3DGS fit (K1 + K2 once per step, all 8 views in one
    # pack); the fit timed; the card against the CPU over 1 step.
    img = os.path.join(teach, "scene_0000.png")
    ply = os.path.join(tmp, "cvs_fit.ply")
    reset_counts(*counters)
    t0 = time.perf_counter()
    mv = cvs_multiview.main([img, "--checkpoint", final, "--views",
                             str(CVS_VIEWS), "--output_dir",
                             os.path.join(tmp, "cvs_views"),
                             "--optimize_3dgs", ply, "--fit_steps",
                             str(CVS_FIT_STEPS), "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    path_launches["cvs_multiview"] = read_counts(*counters)
    back = gio.load_ply(ply)
    views, poses = mv["views"], mv["poses"]
    fit_ms = mv["fit_seconds"] * 1e3 / CVS_FIT_STEPS
    ref_l = {}
    for which, d in (("card", dev), ("cpu", cpu)):
        got = []
        cvs_multiview.optimize_3dgs(views, poses, CVS_SIZE,
                                    steps=CVS_FIT_REF_STEPS, device=d,
                                    losses=got)
        ref_l[which] = [float(x) for x in got]
    fit_rel = max(abs(a - b_) / abs(b_) for a, b_ in zip(ref_l["card"],
                                                         ref_l["cpu"]))
    fit_losses = torch.stack(mv["fit_losses"]).cpu().tolist()
    log("cvs_multiview", views=CVS_VIEWS, fit_steps=CVS_FIT_STEPS,
        main_seconds=main_s, launches=path_launches["cvs_multiview"],
        fit_ms_per_step=fit_ms, fit_loss_first=fit_losses[0],
        fit_loss_last=fit_losses[-1], ply_rows=back.num_gaussians,
        ply_finite=bool(torch.isfinite(back.to_flat()).all()),
        views_finite=bool(np.isfinite(views).all()),
        ref_losses_card=ref_l["card"], ref_losses_cpu=ref_l["cpu"],
        ref_loss_rel_max=fit_rel, ref_loss_rtol=REF_LOSS_RTOL,
        phase_seconds=lap("cvs_multiview"))
    if path_launches["cvs_multiview"] != dict(k1=CVS_FIT_STEPS,
                                              k2=CVS_FIT_STEPS, k3=0, k4=0):
        fail(f"cvs_multiview launched {path_launches['cvs_multiview']}")
    if not (back.num_gaussians == 2000 and torch.isfinite(back.to_flat())
            .all() and np.isfinite(views).all() and fit_rel <= REF_LOSS_RTOL
            and np.all(np.isfinite(fit_losses))):
        fail("cvs_multiview's views, PLY or fit are wrong")

    # K1 at the teacher render pack (the first teacher cloud under its
    # frontal camera at 256^2, M 1 024) and K1 + K2 at the optimize_3dgs
    # pack (2 000 Gaussians of the fit's init under the 8 orbit cameras).
    with torch.no_grad():
        with np.load(fit_teacher.teacher_path(Path(img))) as z:
            raw, do = z["raw"], float(z["depth_offset"])
        depth = np.fromfile(os.path.join(teach, "scene_0000_depth.bin"),
                            np.float32)
        depth = depth.reshape(2 * (int(round(len(depth) ** 0.5)),))
        out = head_transform(torch.from_numpy(raw).to(dev)[None],
                             torch.from_numpy(depth).to(dev)[None],
                             torch.tensor(do, device=dev))
        tp = tile.pack_tiles(*[out[k][0] for k in FIELDS],
                             Camera.from_pose(0.0, 0.0, CVS_SIZE).to(dev),
                             tile.TileRendererConfig(max_per_tile=1024))
        p = {k: v.to(dev) for k, v in cvs_multiview.fit_init(2000, 0).items()}
        cams = [Camera.from_pose(el, az, CVS_SIZE).to(dev)
                for el, az in poses]
        bp = tile.pack_tiles_batched(
            *[x[None].expand(len(cams), *x.shape) for x in (
                p["positions"], torch.exp(p["log_scales"]), p["rotations"],
                torch.sigmoid(p["color_logits"]),
                torch.sigmoid(p["opacity_logits"]))],
            cams, tile.TileRendererConfig(max_per_tile=256))
    k_teacher = pack_kernels(torch, raster, tp.pack, tp.counts,
                             tp.n_tiles_x, None, backward=False)
    k_fit = pack_kernels(torch, raster, bp.pack, bp.counts, bp.n_tiles_x,
                         bp.tiles_per_image, backward=True)
    log("kernel_cvs_packs", teacher_pack=k_teacher, fit_pack=k_fit,
        k1_tol=KERNEL_TOL, k2_tol=KERNEL_BWD_TOL,
        phase_seconds=lap("kernel_cvs_packs"))
    if (k_teacher["M"], k_fit["T"], k_fit["M"]) != (1024, 8 * 256, 256):
        fail(f"the CVS packs are not M 1024 and (2048, 256): "
             f"{k_teacher['M']}, {k_fit['T']}, {k_fit['M']}")
    if not (k_teacher["k1_max_abs_err"] <= KERNEL_TOL
            and k_fit["k1_max_abs_err"] <= KERNEL_TOL
            and k_fit["k2_rel_err"] <= KERNEL_BWD_TOL):
        fail("K1 / K2 disagree with their plain versions at a CVS pack")
    log("cvs_phases", seconds=phase_s, total_seconds=sum(phase_s.values()),
        cap_seconds=CVS_PHASES_CAP_S)
    return k_teacher, k_fit


# The geometric SAAG path, the viewer server and experiments 1, 3 and 5
# (phases 44-48).  SAAG at the CLI defaults: grid 256, 65 536 points x 12
# static blocks; the server's session at its defaults (grid 256, subsample
# 2: 16 384 points x 12 = 196 608 Gaussians), /render at 1 024^2 with
# max_per_tile 512 (search binning: K3 + K1).  Training at the
# TrainingConfig defaults (256^2, batch 4, 37^2 x 384 patch features, K 4,
# M 256; 377 spiral points and 16 NCA steps) on an 8-scene synthetic
# corpus; the card against the CPU at 64^2, batch 2.
SAAG_GRID = 256
SAAG_STATIC = SAAG_GRID * SAAG_GRID * 12
SAAG_TIMED = 3
# saag_reference: the CPU tests hold everything but rotations bit for bit
# against the JAX package and rotations within 1e-6; on the card the
# norms and arccos round apart by an ulp, which moves a rotation by about
# ulp / sin(angle) near a flat normal (7.9e-5 was seen between the two
# packages' full infer paths, whose depths differ by ~1e-6): rotations are
# held at 2e-4, every other field at 1e-6.
SAAG_FIELD_TOL, SAAG_ROT_TOL = 1e-6, 2e-4
SAAG_ULPS = 4            # how near its threshold a parting entry must be
SERVE_RENDER = 1024
SERVE_TIMED = 3
EXP135 = (1, 3, 5)
EXP135_SCENES, EXP135_WARMUP, EXP135_TIMED, EXP135_PROFILED = 8, 2, 5, 3
EXP135_REF = dict(image_size=64, batch_size=2)
EXP135_REF_STEPS = 2
SAAG_PHASES_CAP_S = 60.0


def saag_margins(torch, pc, depth, sp, wp, shp, dp, depth_scale):
    """Per point, the smallest distance in float32 ulps from a value a
    SAAG mask tests to that test's threshold: z against 0.01 *
    depth_scale, confidence against min_confidence, the normalised
    gradient against the edge, shell, wrap and density thresholds, the
    gradient direction's length against 0.1."""
    from fresnel_tpu_torch.geometry import surface_info

    px, py = pc.pixel_xy[:, 0].long(), pc.pixel_xy[:, 1].long()
    info = surface_info(depth, sp.gradient_scale)
    gm, gd = info["gradient_mag"][py, px], info["gradient_dir"][py, px]
    ng = (gm / torch.clamp(torch.where(pc.valid, gm, 0.0).max(),
                           min=1e-6)).cpu().numpy()
    conf = pc.confidence.cpu().numpy()

    def ulps(a, b):
        b = np.float32(b)
        return np.abs(a.astype(np.float64) - b) / np.spacing(abs(b))

    m = [ulps((1.0 - conf) * np.float32(depth_scale), 0.01 * depth_scale),
         ulps(conf, sp.min_confidence),
         ulps(torch.linalg.norm(gd, dim=-1).cpu().numpy(), 0.1)]
    m += [ulps(ng, t) for t in (sp.edge_threshold, shp.edge_threshold,
                                wp.edge_threshold, dp.gradient_threshold)]
    return np.min(m, axis=0)


def k3_at(torch, binning, tile, cloud_fields, camera, cfg):
    """K3 against its plain version on what render_tiled hands it for a
    cloud under `camera` (every search group): bit for bit; its device
    time over all groups, the plain version's, and the bound (the table
    and totals written, the intervals read once; one test per (tile,
    Gaussian) pair)."""
    ts = cfg.tile_size
    gx, gy = -(-camera.width // ts), -(-camera.height // ts)
    sp = tile.project_sorted(*cloud_fields, camera, cfg)
    xlo, xhi, ylo, yhi, vis, n2 = tile._padded_intervals(
        sp.means2d, sp.radii, sp.visible, ts)
    b = (xlo, torch.where(vis, xhi, -1), ylo, torch.where(vis, yhi, -1))
    groups = tile.search_groups(cloud_fields[0].shape[0], gx, gy)
    gy_g = -(-gy // groups)
    equal = True
    for g in range(groups):
        got = binning.build_rank_table(*b, gx, gy_g, n2, y_offset=g * gy_g)
        ref = binning.build_rank_table_plain(*b, gx, gy_g, n2,
                                             y_offset=g * gy_g)
        equal &= bool(torch.equal(got[0], ref[0])
                      and torch.equal(got[1], ref[1]))
        del got, ref

    def all_groups(fn):
        return lambda: [fn(*b, gx, gy_g, n2, y_offset=g * gy_g)
                        for g in range(groups)]

    t = kernel_times(torch, all_groups(binning.build_rank_table), n=10)
    plain_ms = cuda_median_ms(
        torch, all_groups(binning.build_rank_table_plain), n=3, warmup=1)
    T = gx * gy_g * groups
    ms, by, work = bound(T * n2 * 2 + T * (n2 // 256) * 4 + 4 * n2 * 4,
                         T * n2 * OPS_PER_TEST)
    return dict(bitwise_equal=equal, n2=n2, groups=groups, T=T, **t,
                plain_ms=plain_ms, bound_ms=ms, bound_by=by, **work)


def html_count(path):
    """The Gaussian count a viewer page embeds (loadCloud's second
    argument)."""
    with open(path) as f:
        m = re.search(r'loadCloud\("[^"]*", (\d+)\);', f.read())
    return int(m.group(1))


def saag_phases(torch, dev, path_launches, tmp):
    """Phases 44-48: the SAAG path (cli infer --saag / --no_model /
    --html), the live viewer server, decoder experiments 1, 3 and 5, and
    K1 / K3 at the SAAG render pack and K1 / K2 at the three training
    packs.  Returns (K1 and K3 at the render pack, {experiment: K1 and K2
    at its training pack})."""
    import threading
    import urllib.request
    from io import BytesIO

    from PIL import Image

    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.geometry import (
        AdaptiveDensityParams, SilhouetteWrapParams, SurfaceGaussianParams,
        VolumetricShellParams, pointcloud_from_depth, to_surface_gaussians)
    from fresnel_tpu_torch.models.encoders import (
        create_depth_estimator, resize_linear)
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder
    from fresnel_tpu_torch.viewer import serve
    from fresnel_tpu_torch.viewer.html_viewer import pack_cloud

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    img_path = infer_image(tmp)
    image = np.asarray(Image.open(img_path).convert("RGB"),
                       np.float32) / 255.0

    # 44. saag_reference: to_surface_gaussians at 256^2 on the card and on
    # the CPU from the same depth and colour.
    t_img = torch.from_numpy(image)
    with torch.no_grad():
        depth = create_depth_estimator("gradient")(t_img, SAAG_GRID)
        color = resize_linear(t_img.permute(2, 0, 1), SAAG_GRID,
                              SAAG_GRID).permute(1, 2, 0)
    params = (SurfaceGaussianParams(), SilhouetteWrapParams(),
              VolumetricShellParams(), AdaptiveDensityParams())
    clouds, pcs = {}, {}
    for name, d in (("card", dev), ("cpu", cpu)):
        with torch.no_grad():
            pc = pointcloud_from_depth(depth.to(d), color=color.to(d),
                                       depth_scale=2.0).normalize(3.0)
            clouds[name] = to_surface_gaussians(pc, depth.to(d), *params)
            pcs[name] = pc
    card, ref = clouds["card"].to(cpu), clouds["cpu"]
    margins = saag_margins(torch, pcs["cpu"], depth, *params, 2.0)
    m_card = (card.opacities > 0).numpy()
    m_cpu = (ref.opacities > 0).numpy()
    parted = np.nonzero(m_card != m_cpu)[0]
    near = bool((margins[parted % (SAAG_GRID ** 2)] <= SAAG_ULPS).all())
    keep = torch.from_numpy(m_card == m_cpu)
    errs = {k: (getattr(card, k)[keep] - getattr(ref, k)[keep]).abs().max()
            .item() for k in FIELDS}
    pc_equal = all(torch.equal(getattr(pcs["card"], k).cpu(),
                               getattr(pcs["cpu"], k))
                   for k in ("positions", "colors", "confidence", "valid"))
    rot_over = int(((card.rotations - ref.rotations).abs()
                    > 1e-6).sum().item())
    log("saag_reference", n_static=card.num_gaussians,
        active=int(m_cpu.sum()), masks_parted=len(parted),
        parted_within_ulps=near, ulps=SAAG_ULPS,
        pointcloud_bitwise_equal=pc_equal, max_abs_err=errs,
        rotations_over_1e6=rot_over, field_tol=SAAG_FIELD_TOL,
        rotation_tol=SAAG_ROT_TOL, phase_seconds=lap("saag_reference"))
    if not (card.num_gaussians == SAAG_STATIC and near and pc_equal
            and errs["rotations"] <= SAAG_ROT_TOL
            and all(v <= SAAG_FIELD_TOL for k, v in errs.items()
                    if k != "rotations")):
        fail("the SAAG cloud on the card disagrees with the CPU's")
    del clouds, pcs, card, ref

    # 45. saag_infer: cli infer --saag --html at the CLI defaults.
    ply, html = os.path.join(tmp, "saag.ply"), os.path.join(tmp, "saag.html")
    argv = ["infer", img_path, ply, "--saag", "--html", html]
    cli.main(argv)                                             # warmup
    ms = []
    for _ in range(SAAG_TIMED):
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    path_launches["saag_infer"] = read_counts(*counters)
    back = gio.load_ply(ply)
    static, cats = cli.saag_infer(image, device=dev)
    live, live_cats = cli.compact(static, cats)
    packed_n = pack_cloud(live, live_cats)[1]
    nm_ply = os.path.join(tmp, "no_model.ply")
    cli.main(["infer", img_path, nm_ply, "--no_model"])
    with open(ply, "rb") as a, open(nm_ply, "rb") as b:
        no_model_same = a.read() == b.read()
    log("saag_infer", host_ms=ms, host_ms_median=statistics.median(ms),
        n_static=static.num_gaussians, n_live=live.num_gaussians,
        ply_rows=back.num_gaussians,
        ply_finite=bool(torch.isfinite(back.to_flat()).all()),
        html_count=html_count(html), pack_cloud_count=packed_n,
        html_bytes=os.path.getsize(html),
        no_model_same_bytes=no_model_same,
        launches=path_launches["saag_infer"],
        phase_seconds=lap("saag_infer"))
    if not (static.num_gaussians == SAAG_STATIC
            and back.num_gaussians == live.num_gaussians > 0
            and torch.isfinite(back.to_flat()).all()
            and html_count(html) == packed_n and no_model_same):
        fail("cli infer --saag / --no_model / --html gave a bad cloud")
    del static, live, back

    # 46. viewer_serve: the reprocess server on port 0, its session on the
    # card at its defaults.
    session = serve.load_session(img_path, grid=SAAG_GRID, device=dev)
    httpd = serve.make_server(session, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=300) as r:
            return r.status, r.read()

    def post(obj):
        req = urllib.request.Request(
            base + "/reprocess", data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    try:
        status, page = get("/")
        page_ok = (status == 200 and b'id="rp_normal_strength"' in page
                   and b"/reprocess" in page)
        reprocess = {}
        for sub in (1, 2):
            t0 = time.perf_counter()
            st, body = post({"subsample": sub})
            ms_rp = (time.perf_counter() - t0) * 1e3
            with session.lock:
                n_static = session.cloud.num_gaussians
                want = min(int((session.cloud.opacities > 1e-3).sum()), 100000)
            reprocess[sub] = dict(status=st, error=body.get("error"),
                                  n=body.get("n"), n_expected=want,
                                  n_static=n_static, host_ms=ms_rp,
                                  server_ms=body.get("ms"))
        render_ms, launches = [], None
        for i in range(SERVE_TIMED + 1):
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.perf_counter()
            st_r, png = get(f"/render?az=0.3&el=0.1&dist=2.0"
                            f"&size={SERVE_RENDER}")
            if i:
                render_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_counts(*counters)
        path_launches["viewer_render"] = launches
        arr = np.asarray(Image.open(BytesIO(png)))
        st_p, ply_bytes = get("/export.ply")
        exp_path = os.path.join(tmp, "export.ply")
        with open(exp_path, "wb") as f:
            f.write(ply_bytes)
        exported = gio.load_ply(exp_path)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    log("viewer_serve", page_ok=page_ok, reprocess=reprocess,
        render_status=st_r, render_shape=list(arr.shape),
        render_max=int(arr.max()), render_mean=float(arr.mean()),
        render_host_ms=render_ms,
        render_host_ms_median=statistics.median(render_ms),
        render_launches=launches, export_status=st_p,
        export_rows=exported.num_gaussians,
        phase_seconds=lap("viewer_serve"))
    if not (page_ok and st_r == 200 and st_p == 200
            and all(r["status"] == 200 and r["error"] is None
                    and r["n"] == r["n_expected"] > 0
                    for r in reprocess.values())
            and reprocess[1]["n_static"] == SAAG_STATIC
            and reprocess[2]["n_static"] == SAAG_STATIC // 4
            and arr.shape == (SERVE_RENDER, SERVE_RENDER, 3)
            and arr.max() > 0
            and exported.num_gaussians == SAAG_STATIC // 4
            and torch.isfinite(exported.to_flat()).all()
            and launches == dict(k1=1, k2=0, k3=launches["k3"], k4=0)
            and launches["k3"] >= 1):
        fail("the viewer server's answers are wrong")

    # 48 (first half). kernel_saag_packs: K1 and K3 at the /render pack.
    with torch.no_grad():
        cl = session.cloud
        cam = Camera.from_pose(0.1, 0.3, SERVE_RENDER, distance=2.0).to(dev)
        cfg = tile.TileRendererConfig(max_per_tile=512)
        fields_ = tuple(getattr(cl, k) for k in FIELDS)
        k3 = k3_at(torch, binning, tile, fields_, cam, cfg)
        # The render alone (no PNG, no HTTP), CUDA events.
        render_ms = cuda_median_ms(
            torch, lambda: tile.render_tiled(*fields_, cam, config=cfg),
            n=5, warmup=1)
        tp = tile.pack_tiles(*fields_, cam, cfg)
        fwd = raster.composite_tiles_packed(tp.pack, tp.counts, tp.n_tiles_x)
        plain = raster.composite_tiles_plain(tp.pack, tp.counts,
                                             tp.n_tiles_x)
        k1_rel = max(((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
                     .item() for g, r in zip(fwd, plain))
    k1_render = pack_kernels(torch, raster, tp.pack, tp.counts,
                             tp.n_tiles_x, None, backward=False)
    k1_render["k1_rel_err"] = k1_rel
    k1_render["render_tiled_ms"] = render_ms
    del session, cl, tp, fwd, plain
    lap("kernel_saag_render_pack")

    # 47. exp135_train: cli train --experiment 1 / 3 / 5 on the corpus,
    # then timed steps, then the card against the CPU.
    data_dir = os.path.join(tmp, "corpus_exp135")
    synthetic_corpus.generate_corpus(data_dir, n_images=EXP135_SCENES,
                                     image_size=256, seed=0)
    ds = ImageDataset(data_dir, image_size=256, feature_dim=384,
                      use_augmentation=False, device=dev)
    ref_ds = ImageDataset(data_dir, image_size=EXP135_REF["image_size"],
                          feature_dim=384, use_augmentation=False,
                          device=dev)
    train_runs, train_packs = {}, {}
    for exp in EXP135:
        out_dir = os.path.join(tmp, f"exp{exp}")
        argv = ["--data_dir", data_dir, "--output_dir", out_dir, "--epochs",
                "1", "--experiment", str(exp), "--device", "cuda"]
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        cli.main(["train"] + argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        path_launches[f"exp{exp}_train"] = cli_launch = read_counts(*counters)
        with open(os.path.join(out_dir, "loss_history.json")) as f:
            hist = json.load(f)
        steps = EXP135_SCENES // 4

        # The configs the CLI built, LPIPS off as it turns it off without
        # weights.
        cfg, phys, hfgs, hfts = tcli.configs_from_args(
            tcli.build_parser().parse_args(argv))
        cfg.lpips_weight = 0.0
        tr = Trainer(cfg, phys, hfgs, hfts, device=dev)
        state = tr.init_state()
        batches = [tr.device_batch(b) for b in train_batches(
            ds, cfg.batch_size, EXP135_WARMUP + EXP135_TIMED)]
        gen = torch.Generator(device=dev).manual_seed(1)
        K = cfg.gaussians_per_patch
        for b in batches[:EXP135_WARMUP]:
            state, _ = tr.train_step(state, b, K, None, gen)
        torch.cuda.synchronize()
        reset_counts(*counters)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        lds = []
        for b in batches[EXP135_WARMUP:]:
            state, ld = tr.train_step(state, b, K, None, gen)
            lds.append(ld["total"])
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        timed_launch = read_counts(*counters)
        losses = [float(v) for v in lds]

        def profiled():
            st_ = state
            for b in batches[-EXP135_PROFILED:]:
                st_, _ = tr.train_step(st_, b, K, None, gen)
        prof = profile_ms(torch, profiled, EXP135_PROFILED, top=5)

        # The pack of the last step's clouds under the training camera.
        with torch.no_grad():
            last = batches[-1]
            out = tr.gaussians(state["params"], last["features"],
                               last["depth"], K, gen)
            bp = tile.pack_tiles_batched(
                *[out[k] for k in FIELDS], tr.camera,
                tile.TileRendererConfig(max_per_tile=cfg.max_per_tile))
        train_packs[exp] = pack_kernels(torch, raster, bp.pack, bp.counts,
                                        bp.n_tiles_x, bp.tiles_per_image,
                                        backward=True)

        # Card against CPU: 64^2, batch 2, dropout 0, the NCA's masks
        # drawn once on the host.
        ref_runs = {}
        ref_batches = train_batches(ref_ds, EXP135_REF["batch_size"],
                                    EXP135_REF_STEPS)
        masks = (torch.rand((cfg.nca_steps, 2, cfg.n_spiral_points, 1),
                            generator=torch.Generator().manual_seed(3))
                 < 0.5).float() if exp == 5 else None
        for name, d in (("card", dev), ("cpu", cpu)):
            rcfg = dataclasses.replace(cfg, **EXP135_REF)
            rt = Trainer(rcfg, phys, hfgs, hfts, device=d)
            rt.model = build_decoder(rcfg, rt.physics_config, dropout=0.0)
            st = rt.init_state()
            g_ = torch.Generator(device=d).manual_seed(1)
            ls = []
            for b in ref_batches:
                st, ld = rt.train_step(
                    st, rt.device_batch(b), K, None, g_,
                    nca_masks=None if masks is None else masks.to(d))
                ls.append(float(ld["total"]))
            ref_runs[name] = ls
        rel = max(abs(a - b) / max(abs(b), 1e-6)
                  for a, b in zip(ref_runs["card"], ref_runs["cpu"]))
        train_runs[exp] = dict(
            cli_seconds=cli_s, cli_launches=cli_launch, cli_steps=steps,
            cli_history=hist.get("total"),
            ms_per_step=start.elapsed_time(end) / EXP135_TIMED,
            host_ms_per_step=host_s * 1e3 / EXP135_TIMED,
            timed_launches=timed_launch, losses=losses, profile=prof,
            ref_losses_card=ref_runs["card"], ref_losses_cpu=ref_runs["cpu"],
            ref_loss_rel_max=rel,
            pack=dict(T=train_packs[exp]["T"], M=train_packs[exp]["M"]))
        log("exp135_train", experiment=exp, **train_runs[exp],
            loss_rtol=REF_LOSS_RTOL, phase_seconds=lap(f"exp{exp}_train"))
        one_each = dict(k1=1, k2=1, k3=0, k4=0)
        if not (cli_launch == {k: v * steps for k, v in one_each.items()}
                and timed_launch == {k: v * EXP135_TIMED
                                     for k, v in one_each.items()}
                and np.all(np.isfinite(losses))
                and np.all(np.isfinite(hist.get("total", [np.nan])))
                and rel <= REF_LOSS_RTOL):
            fail(f"experiment {exp}'s training on the card failed its "
                 "checks")
        del tr, state, batches

    # 48. kernel_saag_packs: the checks of K1 / K3 at the render pack and
    # K1 / K2 at the training packs.
    log("kernel_saag_packs", render_pack=dict(k1=k1_render, k3=k3),
        train_packs=train_packs, k1_tol=KERNEL_TOL, k2_tol=KERNEL_BWD_TOL,
        phase_seconds=lap("kernel_saag_packs"))
    if not (k3["bitwise_equal"] and k1_rel <= KERNEL_TOL
            and k1_render["T"] == (SERVE_RENDER // 16) ** 2
            and k1_render["M"] == 512
            and all(p["k1_max_abs_err"] <= KERNEL_TOL
                    and p["k2_rel_err"] <= KERNEL_BWD_TOL
                    for p in train_packs.values())):
        fail("K1 / K2 / K3 disagree with their plain versions at a SAAG or "
             "experiment 1 / 3 / 5 pack")
    log("saag_phases", seconds=phase_s, total_seconds=sum(phase_s.values()),
        cap_seconds=SAAG_PHASES_CAP_S)
    return dict(k1=k1_render, k3=k3), train_packs


# ---------------------------------------------------------------------------
# Phases 49-54: DINOv2 and Depth-Anything weights from a local path, and the
# decoder options the training launchers set
# ---------------------------------------------------------------------------

# config.json's backbone_config.out_indices, as Depth-Anything-V2-Small-hf
# ships it.
BB_OUT_INDICES = [3, 6, 9, 12]
# Card against the port's CPU, of the largest value: float32.  bf16 on the
# card is held to twice the CPU's own bf16-against-float32 gap.
BB_TOL = 1e-4
BB_FUSED_TOL = 1e-5
BB_INFER_TIMED, BB_ENCODER_TIMED = 3, 10
# refine with Depth-Anything: K1 / K2 per step from two calls' difference.
BB_REFINE_STEPS = (10, 60)
# cloud/train_overnight.sh's training step over 8 seeded 256^2 images,
# cut to its first 3 epochs of 100 (--stop_epoch 3: one step each, at K 1
# of the progressive schedule).
BB_LAUNCHER = ["--experiment", "2", "--epochs", "100", "--batch_size", "8",
               "--image_size", "256", "--use_fresnel_zones",
               "--use_edge_aware", "--progressive_schedule"]
BB_SCENES, BB_STOP_EPOCH = 8, 3
BB_WARMUP, BB_TIMED, BB_PROFILED = 2, 5, 3
BB_REF = dict(image_size=64, batch_size=2)
BB_REF_STEPS = 2
# Path 5: one training step for each remaining option, at the CLI's (the
# TrainingConfig's) defaults: 256^2, batch 4, K 4, M 256.
BB_OPTIONS = {
    "phase_output": ["--use_phase_output"],
    "pose_encoding": ["--use_pose_encoding", "--multi_pose_augmentation"],
    "depth_fusion": ["--use_depth_fusion"],
    "exp4_zones_phase_pose": ["--experiment", "4", "--use_fresnel_zones",
                              "--use_phase_output", "--use_pose_encoding"],
}
BB_OPTION_TIMED = 3
BB_PHASES_CAP_S = 90.0


def rel_max(torch, got, want):
    """max |got - want| over max |want| (float32, on the host)."""
    got, want = got.float().cpu(), want.float().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def quiet(fn, *a, **k):
    """fn(*a, **k) with its standard output captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue()


def backbone_phases(torch, dev, path_launches, tmp):
    """Phases 49-54: DINOv2 and Depth-Anything-V2-Small files written at
    the published shapes (random from a seed) under FRESNEL_TPU_MODELS and
    loaded by the factories; the backbones on the card against the CPU;
    `cli infer` on both routes; `cli refine`, the overnight launcher's
    training and `/render` of the viewer with Depth-Anything found; one
    training step per decoder option.  Returns K1 / K2 at the launcher's
    training pack."""
    import threading
    import urllib.request
    from io import BytesIO
    from pathlib import Path

    from PIL import Image

    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import (
        ImageDataset, _load_image, cache_paths)
    from fresnel_tpu_torch.models import backbone_files as bfiles
    from fresnel_tpu_torch.models import encoders, vit
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder
    from fresnel_tpu_torch.viewer import serve

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    env_before = os.environ.get("FRESNEL_TPU_MODELS")

    def models_at(path):
        os.environ["FRESNEL_TPU_MODELS"] = path

    # 49. backbone_load: the three files, then each through the factories.
    hf_dir = os.path.join(tmp, "models_hf")
    fb_dir = os.path.join(tmp, "models_fb")
    os.makedirs(hf_dir, exist_ok=True)
    os.makedirs(fb_dir, exist_ok=True)
    files = {
        "dinov2_hf": (os.path.join(hf_dir, "dinov2_small.safetensors"),
                      bfiles.dinov2_checkpoint("hf", seed=11)),
        "depth_anything": (
            os.path.join(hf_dir, "depth_anything_v2_small.safetensors"),
            bfiles.depth_anything_checkpoint(seed=12)),
        "dinov2_facebook": (
            os.path.join(fb_dir, "dinov2_vits14_pretrain.pth"),
            bfiles.dinov2_checkpoint("facebook", seed=13)),
    }
    written = {}
    for key, (path, sd) in files.items():
        t0 = time.perf_counter()
        bfiles.save_checkpoint(path, sd)
        written[key] = dict(file=os.path.basename(path), tensors=len(sd),
                            params=bfiles.n_params(sd),
                            bytes=os.path.getsize(path),
                            write_seconds=time.perf_counter() - t0)
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump({"backbone_config": {"out_indices": BB_OUT_INDICES}}, f)

    def timed_load(make):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obj = make()
        torch.cuda.synchronize()
        model = obj.model if hasattr(obj, "model") else obj
        return obj, dict(
            seconds=time.perf_counter() - t0,
            kind=getattr(obj, "kind", type(obj).__name__),
            weights_path=getattr(obj, "weights_path", None),
            tensors=getattr(obj, "n_loaded", len(model.state_dict())),
            params=sum(p.numel() for p in model.parameters()),
            device=str(next(model.parameters()).device))

    loads = {}
    models_at(fb_dir)
    ext_fb, loads["dinov2_facebook"] = timed_load(
        lambda: encoders.create_feature_extractor(device=dev))
    models_at(hf_dir)
    ext, loads["dinov2_hf"] = timed_load(
        lambda: encoders.create_feature_extractor(device=dev))
    est, loads["depth_anything"] = timed_load(
        lambda: encoders.create_depth_estimator(device=dev))
    da_cfg, loads["load_depth_anything"] = timed_load(
        lambda: vit.load_depth_anything(
            "small", files["depth_anything"][0], device=dev))
    log("backbone_load", files=written, loads=loads,
        config_out_indices=list(da_cfg.out_indices),
        phase_seconds=lap("backbone_load"))
    # Every parameter filled (a mask token and fusion level 0's dead
    # residual unit are the only file entries no parameter takes).
    dino_params = written["dinov2_hf"]["params"] - 384
    da_params = (written["depth_anything"]["params"] - 384
                 - 2 * (64 * 64 * 9 + 64))
    if not (loads["dinov2_hf"]["weights_path"] == files["dinov2_hf"][0]
            and loads["dinov2_facebook"]["weights_path"]
            == files["dinov2_facebook"][0]
            and loads["depth_anything"]["weights_path"]
            == files["depth_anything"][0]
            and loads["dinov2_hf"]["kind"] == "dinov2"
            and loads["depth_anything"]["kind"] == "depth_anything"
            and loads["dinov2_hf"]["params"] == dino_params
            and loads["dinov2_facebook"]["params"] == dino_params
            and loads["depth_anything"]["params"] == da_params
            and tuple(da_cfg.out_indices) == tuple(BB_OUT_INDICES)
            and all(v["device"].startswith("cuda") for v in loads.values())):
        fail(f"the backbones did not load from where they were written: "
             f"{loads}")
    del ext_fb, da_cfg

    # 50. backbone_reference: features and depth at 518^2, the card
    # against the port on the CPU, float32 and bf16.
    img_path = infer_image(tmp)
    image = torch.from_numpy(np.asarray(
        Image.open(img_path).convert("RGB"), np.float32) / 255.0)
    path_d, path_a = files["dinov2_hf"][0], files["depth_anything"][0]
    outs, seconds, f32_card = {}, {}, None
    for dname, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for side, d in (("card", dev), ("cpu", cpu)):
            t0 = time.perf_counter()
            if (dname, side) == ("bf16", "card"):
                e, s = ext, est
            else:
                e = encoders.DINOv2FeatureExtractor(path_d, compute_dtype=dt,
                                                    device=d)
                s = encoders.DepthAnythingEstimator(path_a, compute_dtype=dt,
                                                    device=d)
            x = image.to(d)
            outs[dname, side] = (e(x).cpu(), s(x, 256).cpu())
            seconds[f"{dname}_{side}"] = time.perf_counter() - t0
            if (dname, side) == ("f32", "card"):
                f32_card = (e, s)
            del e, s
    ref_errs = {}
    for i, what in enumerate(("features", "depth")):
        gap = rel_max(torch, outs["bf16", "cpu"][i], outs["f32", "cpu"][i])
        ref_errs[what] = dict(
            f32=rel_max(torch, outs["f32", "card"][i], outs["f32", "cpu"][i]),
            bf16_card_vs_cpu_f32=rel_max(torch, outs["bf16", "card"][i],
                                         outs["f32", "cpu"][i]),
            bf16_card_vs_cpu_bf16=rel_max(torch, outs["bf16", "card"][i],
                                          outs["bf16", "cpu"][i]),
            cpu_bf16_gap=gap)
    log("backbone_reference", shapes=[list(o.shape) for o in
                                      outs["f32", "card"]],
        max_rel_err=ref_errs, f32_tol=BB_TOL, bf16_rule="card bf16 within "
        "2 x the CPU's bf16-vs-f32 gap of the CPU's f32", seconds=seconds,
        phase_seconds=lap("backbone_reference"))
    if not (tuple(outs["f32", "card"][0].shape) == (37, 37, 384)
            and tuple(outs["f32", "card"][1].shape) == (256, 256)
            and all(e["f32"] <= BB_TOL
                    and e["bf16_card_vs_cpu_f32"] <= 2 * e["cpu_bf16_gap"]
                    for e in ref_errs.values())):
        fail(f"the backbones on the card disagree with the CPU: {ref_errs}")

    # 51. infer_backbones: cli infer, separate and --fused_encoder; then
    # the encoders alone on both routes.
    infer = {}
    for route, extra in (("separate", []), ("fused", ["--fused_encoder"])):
        ply = os.path.join(tmp, f"bb_{route}.ply")
        argv = ["infer", img_path, ply] + extra
        _, printed = quiet(cli.main, argv)                     # warmup
        ms = []
        for _ in range(BB_INFER_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            quiet(cli.main, argv)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        reset_counts(*counters)
        quiet(cli.main, argv)
        torch.cuda.synchronize()
        path_launches[f"infer_backbones_{route}"] = read_counts(*counters)
        prof = profile_ms(torch, lambda: [quiet(cli.main, argv)
                                          for _ in range(2)], 2, top=5)
        cloud = gio.load_ply(ply)
        infer[route] = dict(host_ms=ms, host_ms_median=statistics.median(ms),
                            printed=[ln for ln in printed.splitlines()
                                     if "estimator" in ln or "extractor" in ln
                                     or "route" in ln],
                            kept=cloud.num_gaussians,
                            finite=bool(torch.isfinite(cloud.to_flat()).all()),
                            profile=prof)
    clouds = {r: gio.load_ply(os.path.join(tmp, f"bb_{r}.ply"))
              for r in infer}
    ply_rel = (rel_err(clouds["fused"], clouds["separate"])
               if clouds["fused"].num_gaussians
               == clouds["separate"].num_gaussians else None)
    e32, s32 = f32_card
    fused32 = encoders.create_fused_encoder(e32, s32)
    fused16 = encoders.create_fused_encoder(ext, est)
    if fused32 is None or fused16 is None:
        fail("the fused encoder is None with both backbones loaded")
    x = image.to(dev)
    f_f, d_f = fused32(x, 256)
    fused_errs = dict(features=rel_max(torch, f_f, outs["f32", "card"][0]),
                      depth=rel_max(torch, d_f, outs["f32", "card"][1]))
    encoder = {}
    for route, fn in (("separate", lambda: (ext(x), est(x, 256))),
                      ("fused", lambda: fused16(x, 256))):
        p = profile_ms(torch, lambda: [fn() for _ in range(3)], 3, top=5)
        encoder[route] = dict(ms=cuda_median_ms(torch, fn,
                                                n=BB_ENCODER_TIMED),
                              device_ms=p["device_ms"],
                              kernels=p["kernels"],
                              device_busy_share=p["device_busy_share"],
                              top_kernels_ms=p["top_kernels_ms"])
    del e32, s32, fused32, f32_card
    log("infer_backbones", infer=infer, ply_fused_vs_separate=ply_rel,
        fused_vs_separate_f32=fused_errs, fused_tol=BB_FUSED_TOL,
        encoder=encoder,
        kernels_saved_per_call=(encoder["separate"]["kernels"]
                                - encoder["fused"]["kernels"]),
        phase_seconds=lap("infer_backbones"))
    if not (all(r["finite"] and r["kept"] > 0 for r in infer.values())
            and any("depth_anything (" in ln
                    for ln in infer["separate"]["printed"])
            and any("dinov2 (" in ln for ln in infer["separate"]["printed"])
            and any("fused dual trunk" in ln
                    for ln in infer["fused"]["printed"])
            and all(v <= BB_FUSED_TOL for v in fused_errs.values())
            and all(path_launches[f"infer_backbones_{r}"]
                    == dict(k1=0, k2=0, k3=0, k4=0) for r in infer)):
        fail(f"cli infer with the backbones failed its checks: "
             f"{fused_errs}")

    # 52. refine_backbones: cli refine at its defaults with Depth-Anything.
    refine_runs = {}
    for steps in BB_REFINE_STEPS:
        ply = os.path.join(tmp, f"refine_bb_{steps}.ply")
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        _, printed = quiet(cli.main, ["refine", img_path, ply, "--steps",
                                      str(steps)])
        torch.cuda.synchronize()
        refine_runs[steps] = dict(
            seconds=time.perf_counter() - t0,
            launches=read_counts(*counters),
            depth_anything=any("depth estimator: depth_anything (" in ln
                               for ln in printed.splitlines()),
            rows=gio.load_ply(ply).num_gaussians)
    lo, hi = BB_REFINE_STEPS
    path_launches["refine_backbones"] = refine_runs[hi]["launches"]
    ms_step = ((refine_runs[hi]["seconds"] - refine_runs[lo]["seconds"])
               * 1e3 / (hi - lo))
    log("refine_backbones", runs=refine_runs, ms_per_step=ms_step,
        phase_seconds=lap("refine_backbones"))
    if not all(r["depth_anything"] and r["rows"] == 5476
               and r["launches"] == dict(k1=s + 1, k2=s, k3=0, k4=0)
               for s, r in refine_runs.items()):
        fail("cli refine with Depth-Anything failed its checks")

    # 53. train_launcher: the overnight launcher's training step; caches
    # made by the loaded backbones.
    # A directory of seeded images alone (the corpus's own depth caches
    # left out), so the dataset makes both caches with the backbones.
    corpus_dir = os.path.join(tmp, "corpus_bb")
    synthetic_corpus.generate_corpus(corpus_dir, n_images=BB_SCENES,
                                     image_size=256, seed=5)
    data_dir = os.path.join(tmp, "images_bb")
    os.makedirs(data_dir, exist_ok=True)
    for png in sorted(Path(corpus_dir).glob("*.png")):
        shutil.copy(png, data_dir)
    out_dir = os.path.join(tmp, "launcher")
    argv = (["--data_dir", data_dir, "--output_dir", out_dir] + BB_LAUNCHER
            + ["--stop_epoch", str(BB_STOP_EPOCH), "--device", "cuda"])
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.perf_counter()
    quiet(cli.main, ["train"] + argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    path_launches["train_launcher"] = cli_launch = read_counts(*counters)
    with open(os.path.join(out_dir, "loss_history.json")) as f:
        hist = json.load(f)
    # The caches are the backbones' outputs (bf16 on the card, as the
    # dataset builds them).
    first = sorted(Path(data_dir).glob("*.png"))[0]
    img0 = torch.from_numpy(_load_image(first, 256)).to(dev)
    _, feat_p, depth_p, _ = cache_paths(first, 256, 384)
    cache_err = dict(
        features=float(np.abs(np.fromfile(feat_p, np.float32).reshape(
            37, 37, 384) - ext(img0).cpu().numpy()).max()),
        depth=float(np.abs(np.fromfile(depth_p, np.float32).reshape(
            256, 256) - est(img0, 256).cpu().numpy()).max()))
    cfg, phys, hfgs, hfts = tcli.configs_from_args(
        tcli.build_parser().parse_args(argv))
    cfg.lpips_weight = 0.0
    ds = ImageDataset(data_dir, image_size=256, feature_dim=384,
                      use_augmentation=False, device=dev)
    tr = Trainer(cfg, phys, hfgs, hfts, device=dev)
    state = tr.init_state()
    batches = [tr.device_batch(b) for b in train_batches(
        ds, cfg.batch_size, BB_WARMUP + BB_TIMED)]
    gen = torch.Generator(device=dev).manual_seed(1)
    step_ms = {}
    for K in (1, cfg.gaussians_per_patch):
        st = state
        for b in batches[:BB_WARMUP]:
            st, _ = tr.train_step(st, b, K, None, gen)
        torch.cuda.synchronize()
        reset_counts(*counters)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        lds = []
        for b in batches[BB_WARMUP:]:
            st, ld = tr.train_step(st, b, K, None, gen)
            lds.append(ld["total"])
        end.record()
        torch.cuda.synchronize()
        step_ms[K] = dict(ms_per_step=start.elapsed_time(end) / BB_TIMED,
                          launches=read_counts(*counters),
                          losses=[float(v) for v in lds])
    def profiled():
        st_ = state
        for b in batches[-BB_PROFILED:]:
            st_, _ = tr.train_step(st_, b, 1, None, gen)
    prof = profile_ms(torch, profiled, BB_PROFILED, top=5)
    with torch.no_grad():
        out = tr.gaussians(state["params"], batches[-1]["features"],
                           batches[-1]["depth"], 1, gen)
        bp = tile.pack_tiles_batched(
            *[out[k] for k in FIELDS], tr.camera,
            tile.TileRendererConfig(max_per_tile=cfg.max_per_tile))
    k_launch = pack_kernels(torch, raster, bp.pack, bp.counts, bp.n_tiles_x,
                            bp.tiles_per_image, backward=True)
    ref_ds = ImageDataset(data_dir, image_size=BB_REF["image_size"],
                          feature_dim=384, use_augmentation=False,
                          device=dev)
    ref_batches = train_batches(ref_ds, BB_REF["batch_size"], BB_REF_STEPS)
    ref_runs = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        rcfg = dataclasses.replace(cfg, **BB_REF)
        rt = Trainer(rcfg, phys, hfgs, hfts, device=d)
        rt.model = build_decoder(rcfg, rt.physics_config, dropout=0.0)
        st = rt.init_state()
        g_ = torch.Generator(device=d).manual_seed(1)
        ls = []
        for b in ref_batches:
            st, ld = rt.train_step(st, rt.device_batch(b), 1, None, g_)
            ls.append(float(ld["total"]))
        ref_runs[name] = ls
    rel = max(abs(a - b) / max(abs(b), 1e-6)
              for a, b in zip(ref_runs["card"], ref_runs["cpu"]))
    log("train_launcher", flags=BB_LAUNCHER, stop_epoch=BB_STOP_EPOCH,
        scenes=BB_SCENES, cli_seconds=cli_s, cli_launches=cli_launch,
        cli_history=hist.get("total"), cache_max_abs_diff=cache_err,
        steps=step_ms, profile=prof,
        pack=dict(T=k_launch["T"], M=k_launch["M"]),
        ref_losses_card=ref_runs["card"], ref_losses_cpu=ref_runs["cpu"],
        ref_loss_rel_max=rel, loss_rtol=REF_LOSS_RTOL,
        phase_seconds=lap("train_launcher"))
    if not (cli_launch == dict(k1=BB_STOP_EPOCH, k2=BB_STOP_EPOCH, k3=0,
                               k4=0)
            and np.all(np.isfinite(hist.get("total", [np.nan])))
            and len(hist.get("total", [])) == BB_STOP_EPOCH
            and max(cache_err.values()) <= 1e-6
            and all(v["launches"] == dict(k1=BB_TIMED, k2=BB_TIMED, k3=0,
                                          k4=0)
                    and np.all(np.isfinite(v["losses"]))
                    for v in step_ms.values())
            and rel <= REF_LOSS_RTOL
            and k_launch["k1_max_abs_err"] <= KERNEL_TOL
            and k_launch["k2_rel_err"] <= KERNEL_BWD_TOL):
        fail("the overnight launcher's training failed its checks")
    del tr, state, batches, st

    # 54. decoder_options: one training step per option through cli
    # train, timed steps, the card against the CPU; then /render of a
    # session whose depth is Depth-Anything's.
    options = {}
    pose_rng = np.random.default_rng(7)
    for name, flags in BB_OPTIONS.items():
        o_dir = os.path.join(tmp, f"opt_{name}")
        o_argv = ["--data_dir", data_dir, "--output_dir", o_dir, "--epochs",
                  "1", "--device", "cuda"] + flags
        torch.cuda.synchronize()
        reset_counts(*counters)
        quiet(cli.main, ["train"] + o_argv)
        torch.cuda.synchronize()
        cli_launch = read_counts(*counters)
        path_launches[f"option_{name}"] = cli_launch
        ocfg, ophys, ohfgs, ohfts = tcli.configs_from_args(
            tcli.build_parser().parse_args(o_argv))
        ocfg.lpips_weight = 0.0
        tr = Trainer(ocfg, ophys, ohfgs, ohfts, device=dev)
        st = tr.init_state()
        K = ocfg.gaussians_per_patch
        obatches = [tr.device_batch(b) for b in train_batches(
            ds, ocfg.batch_size, 1 + BB_OPTION_TIMED)]
        poses = [tr.draw_poses(pose_rng, ocfg.batch_size)
                 for _ in obatches]
        st, _ = tr.train_step(st, obatches[0], K, None, gen, poses[0])
        torch.cuda.synchronize()
        reset_counts(*counters)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        lds = []
        for b, p in zip(obatches[1:], poses[1:]):
            st, ld = tr.train_step(st, b, K, None, gen, p)
            lds.append(ld["total"])
        end.record()
        torch.cuda.synchronize()
        timed_launch = read_counts(*counters)
        ref = {}
        ref_poses = tr.draw_poses(np.random.default_rng(8),
                                  BB_REF["batch_size"])
        for side, d in (("card", dev), ("cpu", cpu)):
            rcfg = dataclasses.replace(ocfg, **BB_REF)
            rt = Trainer(rcfg, ophys, ohfgs, ohfts, device=d)
            rt.model = build_decoder(rcfg, rt.physics_config, dropout=0.0)
            _, ld = rt.train_step(rt.init_state(),
                                  rt.device_batch(ref_batches[0]), K, None,
                                  torch.Generator(device=d).manual_seed(1),
                                  ref_poses)
            ref[side] = {k: float(v) for k, v in ld.items()}
        o_rel = max(abs(ref["card"][k] - v) / max(abs(v), 1e-6)
                    for k, v in ref["cpu"].items())
        options[name] = dict(
            flags=flags, cli_launches=cli_launch,
            ms_per_step=start.elapsed_time(end) / BB_OPTION_TIMED,
            timed_launches=timed_launch,
            losses=[float(v) for v in lds], ref_loss_rel_max=o_rel,
            n_gaussians=int(tr._total_gaussians(K)))
        steps = BB_SCENES // ocfg.batch_size
        if not (cli_launch == dict(k1=steps, k2=steps, k3=0, k4=0)
                and timed_launch == dict(k1=BB_OPTION_TIMED,
                                         k2=BB_OPTION_TIMED, k3=0, k4=0)
                and np.all(np.isfinite(options[name]["losses"]))
                and o_rel <= REF_LOSS_RTOL):
            fail(f"the decoder option {name} failed its checks: "
                 f"{options[name]}")
        del tr, st, obatches
    session, printed = quiet(serve.load_session, img_path, grid=SAAG_GRID,
                             device=dev)
    httpd = serve.make_server(session, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        render_ms, launches = [], None
        for i in range(SERVE_TIMED + 1):
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                    base + f"/render?az=0.3&el=0.1&dist=2.0"
                    f"&size={SERVE_RENDER}", timeout=300) as r:
                st_r, png = r.status, r.read()
            if i:
                render_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_counts(*counters)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    path_launches["viewer_render_depth_anything"] = launches
    arr = np.asarray(Image.open(BytesIO(png)))
    da_session = "depth estimator: depth_anything (" in printed
    log("decoder_options", options=options, loss_rtol=REF_LOSS_RTOL,
        render=dict(status=st_r, depth_anything=da_session,
                    host_ms=render_ms,
                    host_ms_median=statistics.median(render_ms),
                    launches=launches, shape=list(arr.shape),
                    mean=float(arr.mean())),
        phase_seconds=lap("decoder_options"))
    if not (da_session and st_r == 200 and arr.max() > 0
            and arr.shape == (SERVE_RENDER, SERVE_RENDER, 3)
            and launches["k1"] == 1 and launches["k3"] >= 1
            and launches["k2"] == launches["k4"] == 0):
        fail("/render of the Depth-Anything session failed its checks")
    del session, ext, est
    if env_before is None:
        os.environ.pop("FRESNEL_TPU_MODELS", None)
    else:
        os.environ["FRESNEL_TPU_MODELS"] = env_before
    log("backbone_phases", seconds=phase_s,
        total_seconds=sum(phase_s.values()), cap_seconds=BB_PHASES_CAP_S)
    return k_launch


# The wave-optics training routes: cli train over a seeded corpus
# at the TrainingConfig defaults (256^2, batch 4, 37^2 x 384 features, K 4,
# M 256) unless a flag says otherwise; (phase, label, flags, kernels per
# step).  exp4_fourier takes exp4_budget's sidecar config
# (results/exp4_budget_model.msgpack.json: 5 476 spiral points, batch 8,
# M 1 024, surface-init head biases, depth_offset_init -0.128, no
# augmentation).
WAVE_PATHS = (
    ("train_sh_full", "train_sh_full",
     ["--experiment", "2", "--use_fresnel_zones", "--use_edge_aware",
      "--image_size", "256", "--use_phase_blending",
      "--use_phase_retrieval_loss", "--use_frequency_loss"],
     dict(k1=1, k2=1)),
    ("phase_train", "fourier_renderer",
     ["--use_fourier_renderer", "--use_phase_output"],
     dict(k1phi=1, k2phi=1)),
    ("phase_train", "phase_blending",
     ["--use_phase_blending", "--use_phase_output"],
     dict(k1phi=1, k2phi=1)),
    ("qsr_train", "qsr", ["--use_qsr"], dict(k5=1, k6=1)),
    ("physics_train", "physics",
     ["--use_wave_rendering", "--learnable_wavelength",
      "--use_diffraction_placement"], dict(k5=1, k6=1)),
    ("exp4_fourier", "exp4_fourier",
     ["--experiment", "4", "--use_phase_blending", "--n_spiral_points",
      "5476", "--batch_size", "8", "--max_per_tile", "1024",
      "--surface_init", "--depth_offset_init", "-0.128",
      "--no_augmentation"], dict(k5=1, k6=1)),
)
# The routes that launch K5 / K6, held against the plain versions at
# their own launches (kernel_dense).
DENSE_ROUTES = ("qsr", "physics", "exp4_fourier")
WAVE_SCENES, WAVE_WARMUP, WAVE_TIMED, WAVE_PROFILED = 8, 2, 3, 2
# The --ab mode's steps of the train_sh_full route (the corpus's batches
# repeat, epoch after epoch).
AB_TRAIN_STEPS = 20
WAVE_REF = dict(image_size=64, batch_size=2)
WAVE_REF_STEPS = 2
WAVE_PHASES_CAP_S = 90.0
# physics_train: the decoder's wavelength_raw, card against CPU after the
# reference steps, relative.
WAVELENGTH_RTOL = 1e-5
# Operations per pixel-Gaussian pair, counted from csrc/: K1-phi's
# phase_step inside the box (offsets 2, box 4, quadratic form 7, exp 1,
# opacity 1, interference 8 with its cos, clip 3, weight 1, four sums 8,
# acc_alpha 2, transmittance 2, the phase weight 2, the running phase 4);
# K2-phi, the forward's 45 to know each slot's state, the adjoint and the
# chain rule (~44) and 11 adds of the reduction over the tile's pixels.
OPS_PER_EVAL_PHASE = 45
OPS_PER_EVAL_PHASE_BWD = 100
# K5 / K6: the least operations any implementation needs per pixel-Gaussian
# pair within reach (a multiply-add counts 2; exp 1), with C channels (8
# WAVE, 3 ISO) and all that can be done once per Gaussian, row or column
# done so.  K5 WAVE: the quadratic form updated along a row (2 adds, the box
# then walked, never tested), its exp (1) and a multiply-add per channel
# (2C) with the opacity folded into V: 2C + 3 = 19.  K5 ISO: the weight is
# separable, so the row factor times the opacity times V is formed once per
# row and a pair is a multiply-add per channel with the column factor:
# 2C = 6.  K6 WAVE: the forward's weight (3), dw = g_out . V and the g_V
# sums (2C each), k = dw e (1), and two sums of k, along the row and down
# the column, one of them times dx (4), every moment (dx, dy, dx^2, dx dy,
# dy^2) formed from those per row or column: 4C + 8 = 40.  K6 ISO: dw and
# the g_V sums of g_out times one factor (2C each), and dw times the column
# factor summed along the row and times the row factor down the column (2
# each), the rest per row or column: 4C + 4 = 16.
OPS_PER_SPLAT = {0: 19, 1: 6}
OPS_PER_SPLAT_BWD = {0: 40, 1: 16}


def read_all_counts(raster, binning, stream_binning, splat):
    """Every kernel's launches: K1-K4, K1-phi, K2-phi, K5 and K6."""
    return dict(read_counts(raster, binning, stream_binning),
                k1phi=raster.launches_phase, k2phi=raster.launches_phase_bwd,
                k5=splat.launches, k6=splat.launches_bwd)


def splat_reach(torch, params, mode):
    """Each Gaussian's reach in pixels, past which its weight is exactly 0
    (csrc/dense_common.cuh): WAVE, the box's radius; ISO, where the
    exponent passes -110, sqrt(110 (2 sigma^2 + 1e-8)) + 1."""
    if mode == 0:
        return params[..., 5]
    return torch.sqrt(110.0 * (2.0 * params[..., 2] ** 2 + 1e-8)) + 1.0


def splat_pairs(torch, params, H, W, mode):
    """(pairs K5 evaluates with weight, pairs K6 walks): the integer pixels
    within each Gaussian's reach, where its weight can be nonzero; K5 skips
    opacity 0, K6 walks them for the opacity's own gradient."""
    def span(m, r, n):
        lo = torch.clamp(torch.ceil(m - r), min=0)
        hi = torch.clamp(torch.floor(m + r), max=n - 1)
        return torch.clamp(hi - lo + 1, min=0)

    r = splat_reach(torch, params, mode)
    n = (span(params[..., 0], r, W) * span(params[..., 1], r, H)).double()
    return (int(n[params[..., 6] != 0].sum().item()),
            int(n.sum().item()))


def splat_bounds(torch, params, V, H, W, mode):
    B, N = params.shape[:2]
    C = V.shape[-1]
    fwd_pairs, bwd_pairs = splat_pairs(torch, params, H, W, mode)
    io = B * N * (8 + C) * 4
    img = B * H * W * C * 4
    k5 = bound(io + img, fwd_pairs * OPS_PER_SPLAT[mode])
    k6 = bound(io + img + io, bwd_pairs * OPS_PER_SPLAT_BWD[mode])
    return (dict(k5=dict(**k5[2], bound_ms=k5[0], bound_by=k5[1]),
                 k6=dict(**k6[2], bound_ms=k6[0], bound_by=k6[1])),
            dict(k5_pairs=fwd_pairs, k6_pairs=bwd_pairs,
                 all_pairs=B * N * H * W))


def splat_spread(torch, params, mode, pairs):
    """How far the live Gaussians reach: quantiles of the reach in pixels
    and the pixels K6 walks per Gaussian."""
    B, N = params.shape[:2]
    r = splat_reach(torch, params, mode)[params[..., 6] != 0].float()
    q = torch.quantile(r, torch.tensor([0.05, 0.5, 0.95], device=r.device))
    return dict(pairs=pairs, pairs_per_gaussian=pairs["k6_pairs"] / (B * N),
                live=int(r.numel()),
                reach_px=dict(p05=q[0].item(), p50=q[1].item(),
                              p95=q[2].item(), max=r.max().item()))


def dense_times(torch, splat, params, V, H, W, mode, dev):
    """K5 / K6 device times at one launch's inputs, with their bounds and
    the Gaussians' reach (no comparison: the --ab mode times each
    checkout's kernels on the same synthetic inputs, through the launchers
    whose signatures every version of the dense splat keeps)."""
    g_out = torch.randn((params.shape[0], H, W, V.shape[-1]),
                        generator=torch.Generator(device=dev).manual_seed(2),
                        device=dev)
    calls = dict(k5=lambda: splat._launch_fwd(params, V, H, W, mode),
                 k6=lambda: splat._launch_bwd(params, V, g_out, mode))
    out = {}
    bounds, pairs = splat_bounds(torch, params, V, H, W, mode)
    with torch.no_grad():
        for name, fn in calls.items():
            prof = profile_ms(torch, lambda: [fn() for _ in range(10)], 10)
            out[name] = dict(**kernel_times(torch, fn, n=20), **bounds[name],
                             device_ms_by_kernel=prof["top_kernels_ms"])
    return dict(B=params.shape[0], n=params.shape[1], H=H, W=W,
                mode="wave" if mode == 0 else "iso", **out,
                **splat_spread(torch, params, mode, pairs))


# The --ab mode's K5 / K6 inputs.  ISO: 8 clouds of 5 476 at 256^2 whose
# reach matches experiment 4's Fourier route at the state its profile
# starts from (p50 54.85, p95 80.04, max 187.23 px; PERF.md 5): log-normal
# reach, one Gaussian per image at the max, means uniform in a disc of 96
# px about the centre.  WAVE: 4 clouds of 5 476, the box at the 64-px cap
# that QSR's and the physics decoder's clouds reach.
DENSE_AB = dict(iso=dict(B=8, n=5476, size=256, reach_p50=54.85,
                         reach_p95=80.04, reach_max=187.23, disc=96.0),
                wave=dict(B=4, n=5476, size=256, radius=64.0))


def dense_synthetic(torch, dev, mode):
    """(params, V, H, W, mode) of DENSE_AB's ISO (mode 1) or WAVE (mode 0)
    inputs, from a seed."""
    rng = np.random.default_rng(29 + mode)
    cfg = DENSE_AB["iso" if mode else "wave"]
    B, N, S = cfg["B"], cfg["n"], cfg["size"]
    p = np.zeros((B, N, 8), np.float64)
    p[..., 6] = rng.uniform(0.05, 1.0, (B, N))
    if mode:
        rad = cfg["disc"] * np.sqrt(rng.uniform(0, 1, (B, N)))
        ang = rng.uniform(0, 2 * np.pi, (B, N))
        p[..., 0] = S / 2 + rad * np.cos(ang)
        p[..., 1] = S / 2 + rad * np.sin(ang)
        spread = np.log(cfg["reach_p95"] / cfg["reach_p50"]) / 1.6448536
        reach = np.minimum(cfg["reach_p50"] * np.exp(
            spread * rng.standard_normal((B, N))), cfg["reach_max"])
        reach[:, 0] = cfg["reach_max"]
        # reach = sqrt(110 (2 sigma^2 + 1e-8)) + 1 (splat_reach)
        p[..., 2] = np.sqrt(((reach - 1.0) ** 2 / 110.0 - 1e-8) / 2.0)
        V = rng.uniform(0, 1, (B, N, 3))
    else:
        p[..., 0:2] = rng.uniform(0, S, (B, N, 2))
        sx, sy = (rng.uniform(22.0, 32.0, (B, N)) for _ in range(2))
        th = rng.uniform(0, np.pi, (B, N))
        c, s_ = np.cos(th), np.sin(th)
        cxx = c * c * sx * sx + s_ * s_ * sy * sy
        cyy = s_ * s_ * sx * sx + c * c * sy * sy
        cxy = c * s_ * (sx * sx - sy * sy)
        det = cxx * cyy - cxy * cxy
        p[..., 2], p[..., 3], p[..., 4] = cyy / det, -cxy / det, cxx / det
        p[..., 5] = cfg["radius"]
        V = np.concatenate([rng.uniform(-1, 1, (B, N, 6)),
                            rng.uniform(1, 3, (B, N, 1)),
                            np.ones((B, N, 1))], axis=-1)
    return (torch.from_numpy(p.astype(np.float32)).to(dev),
            torch.from_numpy(V.astype(np.float32)).to(dev), S, S, mode)


# The --ab mode's K1-phi / K2-phi inputs: a seeded synthetic pack at the
# phase-blended training pack's shape (4 images x 256 tiles at 256^2, M
# 256, amplitude 0.25, radian phases) and near its statistics as
# kernel_phase logs them (105 872 occupied slots, 103.4 per tile, median
# 9, the largest 256; 50.5 % of pixel-slot pairs and 67.7 % of warp-slots
# inside the boxes): a few hundred tiles at the cap among nearly empty
# ones.  Per image, n Gaussians, a share `disc_share` uniform in a disc
# about a random centre and the rest uniform, log-normal box radii, a
# conic of sigma = radius / 3, depth order; each tile lists the ones whose
# box reaches it, at most M.  Seed 3 gives 103.4 per tile, median 15,
# 334 tiles at the cap, 50.6 % of the pairs and 73.1 % of the warp-slots
# inside the boxes.
PHASE_AB = dict(images=4, size=256, M=256, n=5476, disc_share=0.99,
                disc=70.0, r_median=20.0, r_sigma=0.2, r_max=28.0,
                amplitude=0.25, seed=3)


def phase_synthetic(torch, dev, ts=16):
    """(pack, counts, n_tiles_x, tiles_per_image) of PHASE_AB, binned into
    tiles of ts x ts pixels."""
    cfg = PHASE_AB
    rng = np.random.default_rng(cfg["seed"])
    S, M, n = cfg["size"], cfg["M"], cfg["n"]
    ntx = S // ts
    ti = ntx * ntx
    pack = np.zeros((cfg["images"] * ti, M, 12), np.float32)
    pack[..., 5] = -1.0
    counts = np.zeros(cfg["images"] * ti, np.int32)
    edge = np.arange(ntx) * ts
    for im in range(cfg["images"]):
        nd = int(n * cfg["disc_share"])
        rad = cfg["disc"] * np.sqrt(rng.uniform(0, 1, nd))
        ang = rng.uniform(0, 2 * np.pi, nd)
        centre = rng.uniform(S / 3, 2 * S / 3, 2)
        mean = [np.concatenate([rng.uniform(0, S, n - nd),
                                centre[i] + rad * f(ang)])
                for i, f in enumerate((np.cos, np.sin))]
        r = np.clip(cfg["r_median"] * np.exp(
            cfg["r_sigma"] * rng.standard_normal(n)), 1.5, cfg["r_max"])
        a, c = ((3.0 / r) ** 2 * rng.uniform(0.7, 1.3, n) for _ in range(2))
        b = rng.uniform(-0.3, 0.3, n) * np.sqrt(a * c)
        rows = np.stack([*mean, a, b, c, r, *rng.uniform(0, 1, (3, n)),
                         rng.uniform(0.05, 0.95, n), rng.uniform(1, 4, n),
                         rng.uniform(0, 2 * np.pi, n)], -1)
        rows = rows[rng.permutation(n)].astype(np.float32)
        rows[:, 10] = np.sort(rows[:, 10])
        mx, my, r = rows[:, 0:1], rows[:, 1:2], rows[:, 5:6]
        hit_x = (mx + r >= edge) & (mx - r <= edge + ts - 1)
        hit_y = (my + r >= edge) & (my - r <= edge + ts - 1)
        for t in range(ti):
            idx = np.nonzero(hit_x[:, t % ntx] & hit_y[:, t // ntx])[0][:M]
            counts[im * ti + t] = len(idx)
            pack[im * ti + t, :len(idx)] = rows[idx]
    return (torch.from_numpy(pack).to(dev), torch.from_numpy(counts).to(dev),
            ntx, ti)


def dense_check(torch, splat, params, V, H, W, mode, dev):
    """K5 / K6 through splat.dense_splat at a route's whole launch (B
    images), each image against the plain versions on that image alone:
    K5 relative to the largest plain value, K6 per field; each kernel
    twice, bit for bit.  The plain versions' times are CUDA events summed
    over the B images (after one untimed warm-up), the batch's whole
    work."""
    B, N = params.shape[:2]
    C = V.shape[-1]
    g_out = torch.from_numpy(np.random.default_rng(13).normal(
        size=(B, H, W, C)).astype(np.float32)).to(dev)
    p = params.clone().requires_grad_()
    v = V.clone().requires_grad_()
    got = splat.dense_splat(p, v, H, W, mode)
    gp, gv = torch.autograd.grad(got, (p, v), g_out, retain_graph=True)
    gp2, gv2 = torch.autograd.grad(got, (p, v), g_out)
    got = got.detach()
    rep = bool(torch.equal(gp, gp2) and torch.equal(gv, gv2))
    with torch.no_grad():
        rep_fwd = bool(torch.equal(got, splat._launch_fwd(params, V, H, W,
                                                          mode)))
    del p, v, gp2, gv2
    with torch.no_grad():
        splat.dense_splat_plain(params[:1], V[:1], H, W, mode)
    splat.dense_splat_bwd_plain(params[:1], V[:1], g_out[:1], mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = bwd_ms = 0.0
    f_err = f_ref = 0.0
    names = ([f"params{f}" for f in range(params.shape[-1])]
             + [f"V{f}" for f in range(C)])
    b_err = dict.fromkeys(names, 0.0)
    b_ref = dict.fromkeys(names, 0.0)
    for b in range(B):
        pb, vb, gb = params[b:b + 1], V[b:b + 1], g_out[b:b + 1]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.no_grad():
            ref = splat.dense_splat_plain(pb, vb, H, W, mode)
        ev[1].record()
        ev[2].record()
        rp, rv = splat.dense_splat_bwd_plain(pb, vb, gb, mode)
        ev[3].record()
        torch.cuda.synchronize()
        fwd_ms += ev[0].elapsed_time(ev[1])
        bwd_ms += ev[2].elapsed_time(ev[3])
        f_err = max(f_err, (got[b] - ref[0]).abs().max().item())
        f_ref = max(f_ref, ref.abs().max().item())
        for key, g_, r_ in (("params", gp[b], rp[0]), ("V", gv[b], rv[0])):
            for f in range(g_.shape[-1]):
                n_ = f"{key}{f}"
                b_err[n_] = max(b_err[n_],
                                (g_[..., f] - r_[..., f]).abs().max().item())
                b_ref[n_] = max(b_ref[n_], r_[..., f].abs().max().item())
        del ref, rp, rv
    plain_gb = torch.cuda.max_memory_allocated() / 1e9
    # A field whose plain gradient is 0 everywhere (the radius, the pad, the
    # ISO mode's unused columns) is held by its absolute error.
    b_rel = {n_: b_err[n_] / b_ref[n_] if b_ref[n_] else b_err[n_]
             for n_ in names}
    with torch.no_grad():
        k5 = kernel_times(torch, lambda: splat._launch_fwd(
            params, V, H, W, mode), n=20)
        k6 = kernel_times(torch, lambda: splat._launch_bwd(
            params, V, g_out, mode), n=20)
    bounds, pairs = splat_bounds(torch, params, V, H, W, mode)
    return dict(
        B=B, n=N, H=H, W=W, mode="wave" if mode == 0 else "iso",
        k5=dict(rel_err=f_err / max(f_ref, 1e-30), abs_err=f_err,
                repeat_bitwise_equal=rep_fwd, **k5, plain_ms=fwd_ms,
                **bounds["k5"]),
        k6=dict(rel_err=b_rel, abs_err=max(b_err.values()),
                repeat_bitwise_equal=rep, **k6, plain_ms=bwd_ms,
                plain_peak_mem_gb=plain_gb, **bounds["k6"]),
        **splat_spread(torch, params, mode, pairs))


def dense_ok(d):
    """Whether dense_check found K5 / K6 within their tolerances and each
    bit for bit from run to run."""
    return (d["k5"]["rel_err"] <= KERNEL_TOL
            and max(d["k6"]["rel_err"].values()) <= KERNEL_BWD_TOL
            and d["k5"]["repeat_bitwise_equal"]
            and d["k6"]["repeat_bitwise_equal"])


def wave_phases(torch, dev, path_launches, tmp):
    """Phases 55-62: the wave-optics training routes.  K1-phi / K2-phi at
    the phase-blended training pack and K1 / K2 with the box off; K5 / K6
    at each route's own launch (QSR, physics WAVE; exp4 ISO); paths 1-5
    through cli train, timed steps, profiles and the card against the CPU;
    a physics checkpoint through trainer_from_checkpoint and cli infer.
    Returns the
    four new kernels' numbers for the kernels line."""
    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.render import (
        binning, raster, splat, stream_binning, tile)
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
    from fresnel_tpu_torch.train.harness import (
        Trainer, build_decoder, trainer_from_checkpoint)

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()

    def reset():
        reset_counts(*counters)

    def read():
        return read_all_counts(raster, binning, stream_binning, splat)

    def expected(per_step, n):
        out = dict(k1=0, k2=0, k3=0, k4=0, k1phi=0, k2phi=0, k5=0, k6=0)
        out.update({k: v * n for k, v in per_step.items()})
        return out

    def trainer_of(flags, device, **over):
        argv = ["--output_dir", os.path.join(tmp, "wave_cfg")] + flags
        cfg, phys, hfgs, hfts = tcli.configs_from_args(
            tcli.build_parser().parse_args(argv))
        cfg = dataclasses.replace(cfg, lpips_weight=0.0, **over)
        t = Trainer(cfg, phys, hfgs, hfts, device=device)
        return t

    data_dir = os.path.join(tmp, "corpus_wave")
    synthetic_corpus.generate_corpus(data_dir, n_images=WAVE_SCENES,
                                     image_size=256, seed=0)
    datasets = {}

    def dataset(size, augment):
        key = (size, augment)
        if key not in datasets:
            datasets[key] = ImageDataset(data_dir, image_size=size,
                                         feature_dim=384,
                                         use_augmentation=augment,
                                         device=dev)
        return datasets[key]

    def first_state(flags):
        t = trainer_of(flags, dev)
        st = t.init_state()
        if t.config.depth_offset_init is not None:
            st["params"]["model.depth_offset"] = torch.tensor(
                float(t.config.depth_offset_init), device=dev)
        b = t.device_batch(train_batches(
            dataset(256, "--no_augmentation" not in flags),
            t.config.batch_size, 1)[0])
        return t, st, b

    def first_clouds(flags):
        t, st, b = first_state(flags)
        with torch.no_grad():
            out = t.gaussians(st["params"], b["features"], b["depth"],
                              t.config.gaussians_per_patch)
        return t, out

    def dense_inputs(t, st, b):
        """The (params, V, H, W, mode) of each splat.dense_splat call in one
        training step of trainer t from state st on batch b, as the step
        launches them."""
        seen = []
        real = splat.dense_splat

        def capture(params, V, height, width, mode):
            seen.append((params.detach().contiguous().clone(),
                         V.detach().contiguous().clone(), int(height),
                         int(width), int(mode)))
            return real(params, V, height, width, mode)

        splat.dense_splat = capture
        try:
            t.train_step(st, b, t.config.gaussians_per_patch, None,
                         torch.Generator(device=dev).manual_seed(1))
        finally:
            splat.dense_splat = real
        return seen

    # 55. kernel_phase: K1-phi / K2-phi against their plain versions at the
    # phase-blended training pack (--use_phase_blending --use_phase_output:
    # 4 clouds of 5 476, T 1 024, M 256), then K1 / K2 with the box off.
    kp_s, kmark = lap_timer()
    t, out = first_clouds(WAVE_PATHS[2][2])
    kmark("clouds")
    cfg_t = t.renderer.config
    with torch.no_grad():
        bp = tile.pack_tiles_batched(*[out[k] for k in FIELDS], t.camera,
                                     cfg_t, phases=out["phases"])
    pack, counts, ntx, ti = bp.pack, bp.counts, bp.n_tiles_x, bp.tiles_per_image
    T, M, _ = pack.shape
    amp = cfg_t.phase_amplitude
    with torch.no_grad():
        got = raster._launch_fwd_phase(pack, counts, ntx, amp,
                                       keep_ckpt=True, tiles_per_image=ti)
        ref = raster.composite_tiles_plain(pack, counts, ntx,
                                           tiles_per_image=ti,
                                           phase_amplitude=amp)
    fwd_abs = {n: (g - r).abs().max().item()
               for n, g, r in zip(("color", "depth", "transmittance"),
                                  got[:3], ref)}
    fwd_rel = {n: e / max(r.abs().max().item(), 1e-30)
               for (n, e), r in zip(fwd_abs.items(), ref)}
    crng = np.random.default_rng(12)
    cots = [torch.from_numpy(crng.normal(size=tuple(o.shape)).astype(
        np.float32)).to(dev) for o in ref]
    with torch.no_grad():
        g1 = raster._launch_bwd_phase(pack, counts, ntx, amp, *cots,
                                      ckpt=got[3], tiles_per_image=ti)
        g2 = raster._launch_bwd_phase(pack, counts, ntx, amp, *cots,
                                      ckpt=got[3], tiles_per_image=ti)
    torch.cuda.reset_peak_memory_stats()
    gref = raster.composite_tiles_phase_bwd_plain(pack, counts, ntx, amp,
                                                  *cots, tiles_per_image=ti)
    plain_bwd_gb = torch.cuda.max_memory_allocated() / 1e9
    BWD_PHASE_FIELDS = BWD_FIELDS[:11] + ("phase",)
    babs = {f: (g1[..., i] - gref[..., i]).abs().max().item()
            for i, f in enumerate(BWD_PHASE_FIELDS) if f != "radius"}
    berr = {f: babs[f] / max(gref[..., i].abs().max().item(), 1e-30)
            for i, f in enumerate(BWD_PHASE_FIELDS) if f != "radius"}
    repeat_equal = bool(torch.equal(g1, g2))
    kmark("compare")
    with torch.no_grad():
        k1p_t = kernel_times(torch, lambda: raster._launch_fwd_phase(
            pack, counts, ntx, amp, keep_ckpt=True, tiles_per_image=ti))
        k2p_t = kernel_times(torch, lambda: raster._launch_bwd_phase(
            pack, counts, ntx, amp, *cots, ckpt=got[3], tiles_per_image=ti))
        k1p_plain = cuda_median_ms(torch, lambda: raster.composite_tiles_plain(
            pack, counts, ntx, tiles_per_image=ti, phase_amplitude=amp),
            n=1, warmup=0)
    k2p_plain = cuda_median_ms(
        torch, lambda: raster.composite_tiles_phase_bwd_plain(
            pack, counts, ntx, amp, *cots, tiles_per_image=ti), n=1,
        warmup=0)
    kmark("times")
    occupied = int(counts.sum().item())
    stats = pack_stats(torch, raster, pack, counts, ntx, tiles_per_image=ti)
    kmark("stats")
    ckpt_bytes = math.prod(raster.checkpoint_shape(T, M)) * 4
    # K2-phi reads the cotangents of color, depth and trans (5 floats a
    # pixel where K2 reads 10: it needs no forward outputs) and the carry.
    pb = compositing_bounds(stats, T, M, occupied, names=("k1phi", "k2phi"),
                            ops=(OPS_PER_EVAL_PHASE, OPS_PER_EVAL_PHASE_BWD),
                            bwd_pix=5, carry_bytes=ckpt_bytes)
    # The exact fast paths K1-phi / K2-phi take (cosf, sinf, division)
    # against the library, over their whole ranges.
    fast_paths = raster.phase_fastpath_check(dev)
    # K1 / K2 with the box off (hard_cutoff=False) on the same pack.
    with torch.no_grad():
        nb = raster.composite_tiles_packed(pack, counts, ntx,
                                           tiles_per_image=ti, box=False)
        nb_ref = raster.composite_tiles_plain(pack, counts, ntx,
                                              tiles_per_image=ti, box=False)
        nb_err = max((g - r).abs().max().item() for g, r in zip(nb, nb_ref))
        nb_g = raster.composite_tiles_bwd(pack, counts, ntx, *nb, *cots,
                                          tiles_per_image=ti, box=False)
        nb_gref = raster.composite_tiles_bwd_plain(
            pack, counts, ntx, *nb_ref, *cots, tiles_per_image=ti, box=False)
        _, _, nb_rel = bwd_errors(nb_g, nb_gref)
    kmark("box_off")
    k_phase = dict(T=T, M=M, tiles_per_image=ti, occupied_slots=occupied,
                   amplitude=amp, phases_radians_max=float(
                       out["phases"].max()),
                   k1phi=dict(rel_err=fwd_rel,
                              abs_err=max(fwd_abs.values()), **k1p_t,
                              plain_ms=k1p_plain,
                              **pb["k1phi"]),
                   k2phi=dict(rel_err=berr, abs_err=max(babs.values()),
                              repeat_bitwise_equal=repeat_equal,
                              **k2p_t, plain_ms=k2p_plain,
                              plain_peak_mem_gb=plain_bwd_gb,
                              **pb["k2phi"]),
                   box_off=dict(k1_max_abs_err=nb_err,
                                k2_rel_err=max(nb_rel.values())),
                   box_pixel_pairs=stats["box_pixel_pairs"],
                   counts_max=stats["counts_max"],
                   counts_median=stats["counts_median"],
                   box_warp_share=stats["box_warp_share"],
                   residency=raster.phase_residency(dev),
                   fast_paths=fast_paths,
                   checkpoint_bytes=ckpt_bytes, seconds_by_part=kp_s)
    log("kernel_phase", **k_phase, k1_tol=KERNEL_TOL, k2_tol=KERNEL_BWD_TOL,
        phase_seconds=lap("kernel_phase"))
    if not (max(fwd_rel.values()) <= KERNEL_TOL
            and max(berr.values()) <= KERNEL_BWD_TOL and repeat_equal
            and nb_err <= KERNEL_TOL
            and max(nb_rel.values()) <= KERNEL_BWD_TOL
            and fast_paths["cos_mismatches"] == fast_paths["sin_mismatches"]
            == fast_paths["div_mismatches"] == 0):
        fail(f"K1-phi / K2-phi or the box-off K1 / K2 disagree with their "
             f"plain versions: {k_phase}")
    del t, out, bp, pack, got, ref, g1, g2, gref, nb, nb_ref, nb_g, nb_gref

    # 56. kernel_dense: K5 / K6 at each route's own launch, the inputs its
    # first training step hands splat.dense_splat (QSR: 4 clouds of 5 476,
    # per-RGB phases, WAVE; the physics decoder: 4 clouds, scalar phases,
    # WAVE; exp4's Fourier route: 8 spiral clouds, ISO), each image against
    # the plain versions on that image; K6 bit for bit from run to run.
    k_dense = {}
    for label in DENSE_ROUTES:
        flags = next(f for _, lb, f, _ in WAVE_PATHS if lb == label)
        seen = dense_inputs(*first_state(flags))
        if len(seen) != 1:
            fail(f"{label}'s step called dense_splat {len(seen)} times")
        k_dense[label] = dense_check(torch, splat, *seen[0], dev)
        del seen
    log("kernel_dense", **k_dense, k5_tol=KERNEL_TOL, k6_tol=KERNEL_BWD_TOL,
        phase_seconds=lap("kernel_dense"))
    if not all(dense_ok(d) for d in k_dense.values()):
        fail(f"K5 / K6 disagree with their plain versions: {k_dense}")

    # 57-61. the training paths through cli train, timed steps, profiles
    # and the card against the CPU.
    runs = {}
    ref_ds = None
    for phase, label, flags, per_step in WAVE_PATHS:
        part_s, mark = lap_timer()
        augment = "--no_augmentation" not in flags
        o_dir = os.path.join(tmp, f"wave_{label}")
        argv = (["--data_dir", data_dir, "--output_dir", o_dir, "--epochs",
                 "1", "--device", "cuda"] + flags)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        quiet(cli.main, ["train"] + argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        path_launches[f"wave_{label}"] = cli_launch = read()
        with open(os.path.join(o_dir, "loss_history.json")) as f:
            hist = json.load(f)
        mark("cli")
        tr = trainer_of(flags, dev)
        cfg = tr.config
        steps = WAVE_SCENES // cfg.batch_size
        state = tr.init_state()
        if cfg.depth_offset_init is not None:
            state["params"]["model.depth_offset"] = torch.tensor(
                float(cfg.depth_offset_init), device=dev)
        batches = [tr.device_batch(b) for b in train_batches(
            dataset(256, augment), cfg.batch_size,
            WAVE_WARMUP + WAVE_TIMED)]
        gen = torch.Generator(device=dev).manual_seed(1)
        K = cfg.gaussians_per_patch
        mark("setup")
        for b in batches[:WAVE_WARMUP]:
            state, _ = tr.train_step(state, b, K, None, gen)
        torch.cuda.synchronize()
        mark("warmup")
        torch.cuda.reset_peak_memory_stats()
        reset()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        lds = []
        for b in batches[WAVE_WARMUP:]:
            state, ld = tr.train_step(state, b, K, None, gen)
            lds.append(ld["total"])
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        timed_launch = read()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [float(v) for v in lds]
        mark("timed")

        def profiled():
            st_ = state
            for b in batches[-WAVE_PROFILED:]:
                st_, _ = tr.train_step(st_, b, K, None, gen)
        prof = profile_ms(torch, profiled, WAVE_PROFILED, top=5, cpu=False)
        mark("profile")
        dense_prof = None
        if label in DENSE_ROUTES:
            # Phase 56's check, continued: K5 / K6 against their plain
            # versions at the clouds of the state the profile starts from,
            # where the reach, and with it K6's window, is widest (it
            # grows as the route trains).
            seen = dense_inputs(tr, state, batches[-1])
            dense_prof = dense_check(torch, splat, *seen[0], dev)
            del seen
            mark("dense_at_profile")

        # Card against CPU: 64^2, batch 2, dropout 0, the same init.
        if ref_ds is None:
            ref_ds = ImageDataset(data_dir,
                                  image_size=WAVE_REF["image_size"],
                                  feature_dim=384, use_augmentation=False,
                                  device=dev)
        ref_batches = train_batches(ref_ds, WAVE_REF["batch_size"],
                                    WAVE_REF_STEPS)
        ref_runs, ref_wl = {}, {}
        for name, d in (("card", dev), ("cpu", cpu)):
            rt = trainer_of(flags, d, **WAVE_REF)
            rt.model = build_decoder(rt.config, rt.physics_config,
                                     dropout=0.0)
            st = rt.init_state()
            if rt.config.depth_offset_init is not None:
                st["params"]["model.depth_offset"] = torch.tensor(
                    float(rt.config.depth_offset_init), device=d)
            g_ = torch.Generator(device=d).manual_seed(1)
            ls = []
            for b in ref_batches:
                st, ld = rt.train_step(st, rt.device_batch(b), K, None, g_)
                ls.append({k: float(v) for k, v in ld.items()})
            ref_runs[name] = ls
            mark(f"ref_{name}")
            if "model.wavelength_raw" in st["params"]:
                ref_wl[name] = float(st["params"]["model.wavelength_raw"])
        rel = max(abs(c[k] - v) / max(abs(v), 1e-6)
                  for c, want in zip(ref_runs["card"], ref_runs["cpu"])
                  for k, v in want.items())
        wl_rel = (abs(ref_wl["card"] - ref_wl["cpu"]) / abs(ref_wl["cpu"])
                  if ref_wl else None)
        run = dict(label=label, flags=flags, cli_seconds=cli_s,
                   cli_launches=cli_launch, cli_steps=steps,
                   cli_history=hist.get("total"),
                   renderer=type(tr.renderer).__name__,
                   n_gaussians=int(tr._total_gaussians(K)),
                   ms_per_step=start.elapsed_time(end) / WAVE_TIMED,
                   host_ms_per_step=host_s * 1e3 / WAVE_TIMED,
                   timed_launches=timed_launch, losses=losses,
                   peak_mem_gb=peak_gb, profile=prof,
                   ref_losses_card=[r["total"] for r in ref_runs["card"]],
                   ref_losses_cpu=[r["total"] for r in ref_runs["cpu"]],
                   ref_loss_rel_max=rel, seconds_by_part=part_s,
                   wavelength_raw_card=ref_wl.get(
                       "card"), wavelength_raw_cpu=ref_wl.get("cpu"),
                   wavelength_rel=wl_rel, dense_at_profile=dense_prof)
        ok = (cli_launch == expected(per_step, steps)
              and timed_launch == expected(per_step, WAVE_TIMED)
              and np.all(np.isfinite(losses))
              and np.all(np.isfinite(hist.get("total", [np.nan])))
              and rel <= REF_LOSS_RTOL
              and (wl_rel is None or wl_rel <= WAVELENGTH_RTOL)
              and (dense_prof is None or dense_ok(dense_prof)))
        if label == "physics":
            # The checkpoint cli train wrote rebuilds its physics decoder
            # and runs through cli infer.
            ckpt = os.path.join(o_dir, "final_model.pt")
            back = trainer_from_checkpoint(ckpt, device=dev)
            ply = os.path.join(tmp, "physics_infer.ply")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            quiet(cli.main, ["infer", infer_image(tmp), ply, "--checkpoint",
                             ckpt])
            torch.cuda.synchronize()
            cloud = gio.load_ply(ply)
            run["infer"] = dict(
                decoder=type(back.model).__name__,
                host_ms=(time.perf_counter() - t0) * 1e3,
                rows=cloud.num_gaussians,
                finite=bool(torch.isfinite(cloud.to_flat()).all()))
            ok = ok and (run["infer"]["decoder"]
                         == "PhysicsDirectPatchDecoder"
                         and run["infer"]["rows"] > 0
                         and run["infer"]["finite"])
        runs[label] = run
        log(phase, **run, loss_rtol=REF_LOSS_RTOL,
            wavelength_rtol=WAVELENGTH_RTOL,
            expected_per_step=per_step, phase_seconds=lap(phase))
        if not ok:
            fail(f"the wave-optics route {label} failed its checks: {run}")
        del tr, state, batches

    log("wave_phases", seconds=phase_s, total_seconds=sum(phase_s.values()),
        cap_seconds=WAVE_PHASES_CAP_S)
    def dense_row(kk):
        def route(d):
            return dict(B=d["B"], mode=d["mode"], ms=d[kk]["ms"],
                        plain_ms=d[kk]["plain_ms"],
                        bound_ms=d[kk]["bound_ms"],
                        bound_by=d[kk]["bound_by"],
                        max_abs_err=d[kk]["abs_err"],
                        max_rel_err=(d[kk]["rel_err"] if kk == "k5" else
                                     max(d[kk]["rel_err"].values())))

        routes = {lb: route(d) for lb, d in k_dense.items()}
        at_profile = {lb: route(runs[lb]["dense_at_profile"])
                      for lb in DENSE_ROUTES}
        every = list(routes.values()) + list(at_profile.values())
        head = routes["qsr"]
        return dict(max_abs_err=max(r["max_abs_err"] for r in every),
                    max_rel_err=max(r["max_rel_err"] for r in every),
                    ms=head["ms"], plain_ms=head["plain_ms"],
                    bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                    at="qsr's launch (4 clouds, WAVE); every route's launch "
                       "in routes, the state its profile starts from in "
                       "at_profile",
                    routes=routes, at_profile=at_profile,
                    rel_err_is=("relative to the largest plain value"
                                if kk == "k5" else
                                "relative to each field's largest plain "
                                "value"))

    def phase_row(kk, abs_err):
        return dict(max_abs_err=abs_err,
                    max_rel_err=max(k_phase[kk]["rel_err"].values()),
                    ms=k_phase[kk]["ms"], plain_ms=k_phase[kk]["plain_ms"],
                    bound_ms=k_phase[kk]["bound_ms"],
                    bound_by=k_phase[kk]["bound_by"], at="phase train pack",
                    rel_err_is="relative to each field's largest plain "
                               "value",
                    residency=k_phase["residency"][kk])

    return dict(k1phi=phase_row("k1phi", k_phase["k1phi"]["abs_err"]),
                k2phi=phase_row("k2phi", k_phase["k2phi"]["abs_err"]),
                k5=dense_row("k5"), k6=dense_row("k6"))


# amp_phases: bf16 decoder training (`use_amp`).  amp_reference holds
# TRAIN_REF with use_amp on the card against the CPU over TRAIN_REF_STEPS,
# both within AMP_GAP x the CPU's own bf16-against-float32 difference (each
# loss term's gap floored at REF_LOSS_RTOL of the term); amp_train times
# the flagship config in float32 and in bf16 on the same batches; amp_routes
# takes one bf16 step of each other decoder route at AMP_REF's size.  A
# float32 run would sit 1 x that gap from the bf16 one and pass the bound,
# so every run also records the dtypes its encoder and decoder see
# (`dtype_probe`) and fails unless the amp runs saw bf16 parameters.
AMP_GAP = 2.0
AMP_SCENES, AMP_WARMUP, AMP_TIMED, AMP_PROFILED = 8, 2, 10, 3
AMP_REF = dict(image_size=64, batch_size=2, lpips_weight=0.0)
AMP_ROUTES = (
    ("exp1", ["--experiment", "1"], dict(k1=1, k2=1)),
    ("exp3", ["--experiment", "3"], dict(k1=1, k2=1)),
    ("exp4", ["--experiment", "4", "--n_spiral_points", "377"],
     dict(k1=1, k2=1)),
    ("exp5", ["--experiment", "5", "--n_spiral_points", "55",
              "--nca_steps", "4"], dict(k1=1, k2=1)),
    ("physics", ["--use_wave_rendering", "--learnable_wavelength",
                 "--use_diffraction_placement"], dict(k5=1, k6=1)),
    ("phase_blending", ["--use_phase_blending", "--use_phase_output"],
     dict(k1phi=1, k2phi=1)),
)
AMP_PHASES_CAP_S = 60.0


def amp_gap_ok(got, want, f32, keys=None):
    """Each loss term in `keys` (every term but the overflow telemetry if
    None) of each step: |card - CPU bf16| within AMP_GAP x the larger of
    |CPU bf16 - CPU float32| and REF_LOSS_RTOL of the term.  Returns (ok,
    the largest ratio of a difference to its bound, and that term)."""
    worst, at = 0.0, None
    for g, w, f in zip(got, want, f32):
        for k, v in w.items():
            if (k.startswith("overflow") if keys is None else k not in keys):
                continue
            bound = AMP_GAP * max(abs(v - f[k]), REF_LOSS_RTOL * abs(v))
            r = abs(g[k] - v) / bound if bound else (
                0.0 if g[k] == v else float("inf"))
            if r > worst:
                worst, at = r, k
    return worst <= 1.0, worst, at


def dtype_probe(torch, *modules):
    """Forward hooks on `modules` recording, for each call, the module's
    class, the dtypes of its parameters during the call and of its tensor
    outputs by key (before `amp_apply` casts them back).  Returns (the
    records, a function that removes the hooks)."""
    seen = []

    def hook(m, args, out):
        outs = out if isinstance(out, dict) else {"out": out}
        seen.append((type(m).__name__,
                     sorted({str(p.dtype) for p in m.parameters()}),
                     {k: str(v.dtype) for k, v in outs.items()
                      if torch.is_tensor(v)}))

    handles = [m.register_forward_hook(hook) for m in modules
               if m is not None]
    return seen, lambda: [h.remove() for h in handles]


def dtypes_ok(seen, amp):
    """Every recorded call ran on bf16 parameters (float32 without amp),
    and with amp the ImageEncoder's features and a DirectPatchDecoder's
    scales came out bf16."""
    want = "torch.bfloat16" if amp else "torch.float32"
    for name, params, outs in seen:
        if params != [want]:
            return False
        if name == "ImageEncoder" and outs["out"] != want:
            return False
        if name == "DirectPatchDecoder" and outs["scales"] != want:
            return False
    return bool(seen)


def amp_phases(torch, dev, path_launches, tmp):
    """Phases 63-66: bf16 decoder training (`use_amp`) on the card."""
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.render import (
        binning, raster, splat, stream_binning)
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    matmul = torch.backends.cuda.matmul
    reduced_default = matmul.allow_bf16_reduced_precision_reduction

    def read():
        return read_all_counts(raster, binning, stream_binning, splat)

    def expected(per_step, n):
        out = dict(k1=0, k2=0, k3=0, k4=0, k1phi=0, k2phi=0, k5=0, k6=0)
        out.update({k: v * n for k, v in per_step.items()})
        return out

    data_dir = os.path.join(tmp, "corpus_amp")
    synthetic_corpus.generate_corpus(data_dir, n_images=AMP_SCENES,
                                     image_size=256, seed=0)
    small = ImageDataset(data_dir, image_size=AMP_REF["image_size"],
                         feature_dim=384, use_augmentation=False, device=dev)
    corpus_s = lap("amp_data")

    def steps_of(trainer, state, device, batches, K, masks=None):
        g = torch.Generator(device=device).manual_seed(1)
        losses = []
        for b in batches:
            state, ld = trainer.train_step(
                state, trainer.device_batch(b), K, None, g,
                nca_masks=None if masks is None else masks.to(device))
            losses.append({k: float(v) for k, v in ld.items()})
        return losses, {k: v.cpu() for k, v in state["params"].items()}

    # 63. amp_reference: TRAIN_REF with use_amp, card against CPU.
    ref_batches = train_batches(small, TRAIN_REF["batch_size"],
                                TRAIN_REF_STEPS)
    K_ref = TRAIN_REF["gaussians_per_patch"]
    runs = {}
    for name, d, amp, reduced in (
            ("card", dev, True, reduced_default),
            ("card_no_reduced_reduction", dev, True, False),
            ("cpu", cpu, True, None), ("cpu_f32", cpu, False, None)):
        if reduced is not None:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        trainer, state = train_setup(
            torch, d, dict(TRAIN_REF, use_amp=amp),
            os.path.join(tmp, f"amp_ref_{name}"), dropout=0.0)
        trainer._make_optimizer(TRAIN_REF_STEPS)
        seen, unhook = dtype_probe(torch, trainer.encoder, trainer.model)
        runs[name] = steps_of(trainer, state, d, ref_batches, K_ref)
        unhook()
        if not dtypes_ok(seen, amp):
            fail(f"amp_reference {name}: use_amp {amp} ran on {seen}")
    matmul.allow_bf16_reduced_precision_reduction = reduced_default
    (lc, pc), (lf, pf) = runs["cpu"], runs["cpu_f32"]
    n = sum(v.numel() for v in pc.values())
    gap = sum((pc[k] - pf[k]).abs().sum().item() for k in pc) / n
    ref = {}
    for name in ("card", "card_no_reduced_reduction"):
        lg, pg = runs[name]
        ok, worst, at = amp_gap_ok(lg, lc, lf)
        mean = sum((pg[k] - pc[k]).abs().sum().item() for k in pc) / n
        ref[name] = dict(losses=[r["total"] for r in lg], loss_ok=ok,
                         loss_worst_ratio=worst, loss_worst_term=at,
                         terms_last_step=lg[-1], param_mean_abs=mean,
                         param_mean_ratio=mean / gap if gap else None,
                         param_max_abs=max((pg[k] - pc[k]).abs().max().item()
                                           for k in pc))
    card = ref["card"]
    log("amp_reference", config={k: TRAIN_REF[k] for k in (
        "image_size", "feature_size", "encoder_width", "gaussians_per_patch",
        "max_per_tile", "batch_size")}, steps=TRAIN_REF_STEPS, dropout=0.0,
        allow_bf16_reduced_precision_reduction=reduced_default,
        allow_tf32=matmul.allow_tf32, card=card,
        card_no_reduced_reduction=ref["card_no_reduced_reduction"],
        losses_cpu=[r["total"] for r in lc],
        losses_cpu_f32=[r["total"] for r in lf], terms_cpu_last_step=lc[-1],
        terms_cpu_f32_last_step=lf[-1],
        cpu_param_mean_gap=gap, gap_factor=AMP_GAP,
        phase_seconds=lap("amp_reference"))
    if not (card["loss_ok"] and card["param_mean_abs"] <= AMP_GAP * gap):
        fail("the card's bf16 training steps disagree with the CPU's "
             f"beyond twice the CPU's own bf16 gap: {card}")

    # 64. amp_train: the flagship config, float32 and bf16, same batches.
    big = ImageDataset(data_dir, image_size=TRAIN["image_size"],
                       feature_dim=TRAIN["feature_dim"],
                       use_augmentation=False, device=dev)
    B, K = TRAIN["batch_size"], TRAIN["gaussians_per_patch"]
    host_batches = train_batches(big, B, AMP_WARMUP + AMP_TIMED)
    lap("amp_train_data")
    # Both precisions resident, timed in turns (float32, bf16, bf16,
    # float32: the host's speed drifts within a call), AMP_TIMED / 2 steps
    # a turn, each precision on the same batches in the same order.
    live = {}
    for name, amp in (("float32", False), ("bf16", True)):
        trainer, state = train_setup(torch, dev, dict(TRAIN, use_amp=amp),
                                     os.path.join(tmp, f"amp_{name}"))
        trainer._make_optimizer(TRAIN["epochs"] * max(1, len(big) // B))
        batches = [trainer.device_batch(b) for b in host_batches]
        gen = torch.Generator(device=dev).manual_seed(1)
        seen, unhook = dtype_probe(torch, trainer.encoder, trainer.model)
        for b in batches[:AMP_WARMUP]:
            state, _ = trainer.train_step(state, b, K, None, gen)
        unhook()
        if not dtypes_ok(seen, amp):
            fail(f"amp_train {name}: use_amp {amp} ran on {seen}")
        live[name] = dict(trainer=trainer, state=state, batches=batches,
                          dtypes_seen=seen[:2], gen=gen, ms=[], host_ms=[],
                          losses=[], peak_gb=0.0, step_gb=0.0,
                          launches=expected({}, 0))
    half = AMP_TIMED // 2
    for turn, name in enumerate(("float32", "bf16", "bf16", "float32")):
        r = live[name]
        first = AMP_WARMUP + half * (turn in (2, 3))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*counters)
        events = []
        t0 = time.perf_counter()
        for b in r["batches"][first:first + half]:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            r["state"], ld = r["trainer"].train_step(r["state"], b, K, None,
                                                     r["gen"])
            end.record()
            events.append((start, end))
            r["losses"].append(ld["total"])
        torch.cuda.synchronize()
        r["host_ms"].append((time.perf_counter() - t0) / half * 1e3)
        r["ms"].extend(s_.elapsed_time(e_) for s_, e_ in events)
        peak = torch.cuda.max_memory_allocated() / 1e9
        r["peak_gb"] = max(r["peak_gb"], peak)
        r["step_gb"] = max(r["step_gb"], peak - resident)
        for k, v in read().items():
            r["launches"][k] += v
    train = {}
    for name, amp in (("float32", False), ("bf16", True)):
        r = live.pop(name)
        trainer, state, batches, gen = (r["trainer"], r["state"],
                                        r["batches"], r["gen"])
        launches = r["launches"]
        path_launches[f"amp_train_{name}"] = launches
        losses = torch.stack(r["losses"]).cpu().tolist()
        ms, host_ms = r["ms"], statistics.mean(r["host_ms"])

        def run_steps():
            nonlocal state
            for b in batches[:AMP_PROFILED]:
                state, _ = trainer.train_step(state, b, K, None, gen)

        prof = profile_ms(torch, run_steps, AMP_PROFILED, top=8, cpu=False)
        # The encoder and the decoder alone, forward and backward, on one
        # batch (device ms by torch.profiler: the kernels' sum).
        b0 = batches[0]
        params = {k: v.detach().requires_grad_()
                  for k, v in state["params"].items()}

        def encoder():
            f = trainer._features(params, b0["image"], amp)
            torch.autograd.grad(f.float().sum(), [
                v for k, v in params.items() if k.startswith("encoder.")])

        feats = trainer._features(params, b0["image"], amp).detach()

        def decoder():
            out = trainer.gaussians(params, feats, b0["depth"], K, gen,
                                    amp=amp)
            torch.autograd.grad(sum(out[k].sum() for k in FIELDS), [
                v for k, v in params.items() if k.startswith("model.")])

        if amp:
            # cuBLAS's bf16 reduced-precision reduction on and off, and the
            # same params in float32: loss and gradient of one batch.
            def loss_grad(reduced, use_amp=True):
                matmul.allow_bf16_reduced_precision_reduction = reduced
                trainer.config = dataclasses.replace(trainer.config,
                                                     use_amp=use_amp)
                p = {k: v.detach().requires_grad_() for k, v in
                     state["params"].items()}
                total, _ = trainer.loss(p, b0, K, None,
                                        torch.Generator(device=dev)
                                        .manual_seed(2))
                g = torch.autograd.grad(total, list(p.values()),
                                        allow_unused=True)
                return total.item(), torch.cat([
                    (x if x is not None else torch.zeros_like(v)).flatten()
                    for x, v in zip(g, p.values())])

            lr_on, gr_on = loss_grad(True)
            lr_off, gr_off = loss_grad(False)
            lr_f32, gr_f32 = loss_grad(reduced_default, use_amp=False)
            matmul.allow_bf16_reduced_precision_reduction = reduced_default
            trainer.config = dataclasses.replace(trainer.config, use_amp=True)
            reduction = dict(
                loss_on=lr_on, loss_off=lr_off, loss_f32=lr_f32,
                grad_mean_abs_on_off=(gr_on - gr_off).abs().mean().item(),
                grad_mean_abs_bf16_f32=(gr_off - gr_f32).abs().mean().item(),
                grad_mean_abs_f32=gr_f32.abs().mean().item())
        parts = {}
        for part, fn in (("encoder", encoder), ("decoder", decoder)):
            fn()
            pp = profile_ms(torch, lambda: [fn() for _ in range(3)], 3,
                            top=4, cpu=False)
            parts[part] = dict(device_ms=pp["device_ms"],
                               kernels=pp["kernels"],
                               top_kernels_ms=pp["top_kernels_ms"])
        train[name] = dict(
            ms_per_step_median=statistics.median(ms), ms_per_step=ms,
            host_ms_per_step=host_ms, host_ms_per_turn=r["host_ms"],
            images_per_s=B / (host_ms / 1e3),
            device_ms_per_step=prof["device_ms"],
            device_busy_share=prof["device_busy_share"],
            kernels_per_step=prof["kernels"],
            top_kernels_ms_per_step=prof["top_kernels_ms"],
            fwd_bwd_one_batch=parts, peak_mem_gb=r["peak_gb"],
            peak_mem_step_gb=r["step_gb"], launches=launches,
            losses=losses, dtypes_seen=r["dtypes_seen"],
            **(dict(bf16_reduced_precision_reduction=reduction)
                              if amp else {}))
        if launches != expected(dict(k1=1, k2=1), AMP_TIMED) or \
                not np.all(np.isfinite(losses)):
            fail(f"amp_train {name}: launches {launches}, losses {losses}")
        del trainer, state, batches, params, feats
    log("amp_train", config=TRAIN, hfgs=TRAIN_HFGS, scenes=len(big),
        warmup_steps=AMP_WARMUP, steps=AMP_TIMED,
        turns=["float32", "bf16", "bf16", "float32"],
        profiled_steps=AMP_PROFILED, corpus_seconds=corpus_s, **train,
        bf16_over_float32=dict(
            ms_per_step=train["bf16"]["ms_per_step_median"]
            / train["float32"]["ms_per_step_median"],
            device_ms_per_step=train["bf16"]["device_ms_per_step"]
            / train["float32"]["device_ms_per_step"],
            peak_mem_step=train["bf16"]["peak_mem_step_gb"]
            / train["float32"]["peak_mem_step_gb"]),
        phase_seconds=lap("amp_train"))

    # 65. amp_routes: one bf16 step of each other route, card and CPU.
    routes = {}
    for label, flags, per_step in AMP_ROUTES:
        argv = ["--output_dir", os.path.join(tmp, "amp_cfg"), "--use_amp"]
        cfg, phys, hfgs, hfts = tcli.configs_from_args(
            tcli.build_parser().parse_args(argv + flags))
        host_batch = train_batches(small, AMP_REF["batch_size"], 1)
        masks = None
        if cfg.experiment == 5:
            masks = (torch.rand((cfg.nca_steps, AMP_REF["batch_size"],
                                 cfg.n_spiral_points, 1),
                                generator=torch.Generator().manual_seed(3))
                     < 0.5).float()
        out = {}
        for name, d, amp in (("card", dev, True), ("cpu", cpu, True),
                             ("cpu_f32", cpu, False)):
            c = dataclasses.replace(cfg, use_amp=amp, **AMP_REF)
            t = Trainer(c, phys, hfgs, hfts, device=d)
            t.model = build_decoder(c, t.physics_config, dropout=0.0)
            t._make_optimizer(1)
            st = t.init_state()
            if name == "card":
                torch.cuda.synchronize()
                reset_counts(*counters)
            seen, unhook = dtype_probe(torch, t.encoder, t.model)
            out[name] = steps_of(t, st, d, host_batch,
                                 c.gaussians_per_patch, masks)[0]
            unhook()
            if not dtypes_ok(seen, amp):
                fail(f"amp route {label} {name}: use_amp {amp} ran on "
                     f"{seen}")
            if name == "card":
                torch.cuda.synchronize()
                launches = read()
                renderer = type(t.renderer).__name__
                decoder = type(t.model).__name__
                dtypes = seen[-1]
        path_launches[f"amp_{label}"] = launches
        ok, worst, at = amp_gap_ok(out["card"], out["cpu"], out["cpu_f32"])
        routes[label] = dict(flags=flags, renderer=renderer, decoder=decoder,
                             launches=launches, dtypes_seen=dtypes,
                             loss_card=out["card"][0]["total"],
                             loss_cpu=out["cpu"][0]["total"],
                             loss_cpu_f32=out["cpu_f32"][0]["total"],
                             loss_worst_ratio=worst, loss_worst_term=at,
                             ok=ok)
        finite = all(np.isfinite(v) for v in out["card"][0].values())
        if not (ok and finite and launches == expected(per_step, 1)):
            fail(f"amp route {label}: {routes[label]}")
    log("amp_routes", config=AMP_REF, gap_factor=AMP_GAP,
        loss_floor_rtol=REF_LOSS_RTOL, routes=routes,
        phase_seconds=lap("amp_routes"))
    log("amp_phases", seconds=phase_s, total_seconds=sum(phase_s.values()),
        cap_seconds=AMP_PHASES_CAP_S)


# renderer_phases: the remaining renderers.  kernel_dense_composite holds
# K7 / K8 in both modes at the decoded cloud of the image->3DGS path (5 476
# Gaussians) against their plain versions at 256^2 and at the path's 512^2
# (the plain backward over bands of rows, each no larger than 256^2, where
# it fits, its gradients summed over the bands); renderers drives
# make_renderer("dense" | "simplified" | "asm" | "fourier_true") at the
# path's full width (512^2) forward and through the backward of a mean
# loss, and logs dense against render_tiled(hard_cutoff=False) (K1);
# renderers_reference holds each renderer and both diffractive layers on
# the card against the CPU on a small cloud; depth_sorts holds the
# quantised sorts bit for bit against the CPU's on the render path's
# clouds, and renders one of them with each.
RENDERER_PHASES_CAP_S = 60.0
# K7 against its plain version, per output relative to its largest plain
# value: a sequential product against the chunked cumprod over the
# decoded cloud's 5 476 Gaussians (the depth channel sums w depth over
# them all).  K8 is held at KERNEL_BWD_TOL per field.
COMPOSITE_TOL = 5e-5
COMPOSITE_SIZES = (256, 512)
# The plain backward's pixels per band: ~21 GB of autograd state at the
# decoded cloud on the H100.
COMPOSITE_BAND_PIXELS = 256 * 256
# Operations per pixel-Gaussian pair within reach (DENSE, SIMPLE): K7's
# alpha (offsets, the quadratic form or the boxed distance, the exp, the
# clip), the weight, the colour (and DENSE's depth) sums and the
# transmittance; K8's recomputed alpha and transmittance, dalpha, the
# clip's chain to opacity, mean and conic (or sigma), the colours and the
# reverse recurrence.
OPS_PER_COMPOSITE = {0: 28, 1: 27}
OPS_PER_COMPOSITE_BWD = {0: 60, 1: 52}
RENDERER_NAMES = ("dense", "simplified", "asm", "fourier_true")
RENDERER_LAUNCHES = {"dense": dict(k7=1, k8=1),
                     "simplified": dict(k7=1, k8=1),
                     "asm": dict(k5=1, k6=1), "fourier_true": {}}
RENDERER_TIMED = 3
RENDERERS_REF = dict(n=300, size=96, seed=23)
DEPTH_SORT_N = {"counting": RENDER["n"], "packed": 1 << 20}


def renderer_counts(raster, binning, stream_binning, splat, dcomp):
    """Every kernel's launches, K7 and K8 with them."""
    return dict(read_all_counts(raster, binning, stream_binning, splat),
                k7=dcomp.launches, k8=dcomp.launches_bwd)


def decoded_cloud(torch, models, image):
    """The image->3DGS path's decoded cloud of one image: its five fields
    (N, ...) in float32 on the card."""
    from fresnel_tpu_torch import pipeline

    with torch.no_grad():
        x = pipeline.resize_to_model(image)
        out = models.decoder(models.dino(x), models.depth(x))
    return [out[k][0].float().contiguous() for k in FIELDS]


def composite_pairs(torch, params, H, W, mode):
    """The pixel-Gaussian pairs within each Gaussian's reach
    (csrc/dense_composite_common.cuh): DENSE the ellipse's bounding box
    past which exp(-m / 2) is exactly 0, SIMPLE its box, one pixel more
    on each side; the Gaussians K7 and K8 walk."""
    if mode == 0:
        a, b, c = params[:, 2], params[:, 3], params[:, 4]
        det = a * c - b * b
        rx = torch.sqrt(220.0 * c / det) + 1.0
        ry = torch.sqrt(220.0 * a / det) + 1.0
    else:
        rx = ry = params[:, 5] + 2.0

    def span(m, r, n):
        lo = torch.clamp(torch.ceil(m - r), min=0)
        hi = torch.clamp(torch.floor(m + r), max=n - 1)
        return torch.clamp(hi - lo + 1, min=0)

    n = (span(params[:, 0], rx, W) * span(params[:, 1], ry, H)).double()
    return int(torch.nan_to_num(n, nan=float(H * W)).sum().item())


def composite_bounds(torch, params, H, W, mode):
    """K7's and K8's bounds at one launch: the bytes the function must move
    (K7 reads params and colours and writes out and trans; K8 reads
    params, colours, g_out, g_trans and SIMPLE's least depth and writes
    g_params and g_colors; the checkpoints and lists K7 leaves for K8 are
    the design's, not the function's) and the operations on the pairs
    within reach."""
    N = params.shape[0]
    pairs = composite_pairs(torch, params, H, W, mode)
    io = N * (8 + 3) * 4
    img = H * W * (4 + 1) * 4
    k7 = bound(io + img, pairs * OPS_PER_COMPOSITE[mode])
    k8 = bound(io + img + (H * W * 4 if mode == 1 else 0) + io,
               pairs * OPS_PER_COMPOSITE_BWD[mode])
    return (dict(k7=dict(**k7[2], bound_ms=k7[0], bound_by=k7[1]),
                 k8=dict(**k8[2], bound_ms=k8[0], bound_by=k8[1])),
            dict(pairs=pairs, all_pairs=N * H * W))


def composite_check(torch, dcomp, params, cols, H, W, mode, dev):
    """K7 / K8 at one launch's inputs: device times and bounds, and each
    against its plain version on the same inputs (K7's colour and depth
    channels relative to the largest plain value, the depth channel's +inf
    where nothing passes equal; K8 per field, the plain backward over
    bands of COMPOSITE_BAND_PIXELS pixels summed), the plain versions' ms
    (CUDA events, one call each after a warm-up; K8's over all its bands)
    and the plain backward's peak memory."""
    chunk = dcomp.CHUNK[mode]
    gen = torch.Generator(device=dev).manual_seed(17)
    with torch.no_grad():
        out, trans, ck, aux = dcomp._launch_fwd(params, cols, H, W, mode,
                                                chunk)
        g_out = torch.randn((H, W, 4), device=dev, generator=gen)
        g_t = torch.randn((H, W), device=dev, generator=gen)
        if mode == 1:
            g_out[..., 3] = torch.where(torch.isinf(out[..., 3]), 0.0,
                                        g_out[..., 3])
        k7 = kernel_times(torch, lambda: dcomp._launch_fwd(
            params, cols, H, W, mode, chunk), n=10)
        k8 = kernel_times(torch, lambda: dcomp._launch_bwd(
            params, cols, out, ck, aux, g_out, g_t, mode, chunk), n=10)
    bounds, pairs = composite_bounds(torch, params, H, W, mode)
    N = params.shape[0]
    res = dict(H=H, W=W, n=N, chunk=chunk,
               mode="dense" if mode == 0 else "simple",
               k7=dict(**k7, **bounds["k7"]), k8=dict(**k8, **bounds["k8"]),
               checkpoint_bytes=ck.numel() * 4, aux_bytes=aux.numel() * 4,
               listed=int(aux[2 * N:2 * N + dcomp.n_tiles(H, W)].sum()
                          .item()), **pairs)
    gp, gc = dcomp._launch_bwd(params, cols, out, ck, aux, g_out, g_t, mode,
                               chunk)
    band = max(1, COMPOSITE_BAND_PIXELS // W)
    # Warm-ups: the plain forward, and the backward of one band, which
    # grows the allocator's pool to the band's ~21 GB (in a fresh process
    # the first band's cudaMallocs took seconds).
    with torch.no_grad():
        dcomp.dense_composite_plain(params, cols, H, W, mode)
    h0 = min(band, H)
    dcomp.dense_composite_bwd_plain(params, cols, h0, W, mode, chunk,
                                    g_out[:h0].contiguous(),
                                    g_t[:h0].contiguous())

    def plain_bwd():
        rp, rc = torch.zeros_like(params), torch.zeros_like(cols)
        for y0 in range(0, H, band):
            h = min(band, H - y0)
            bp, bc = dcomp.dense_composite_bwd_plain(
                params, cols, h, W, mode, chunk,
                g_out[y0:y0 + h].contiguous(), g_t[y0:y0 + h].contiguous(),
                row0=y0)
            rp, rc = rp + bp, rc + bc
        return rp, rc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    with torch.no_grad():
        ref, ref_t = dcomp.dense_composite_plain(params, cols, H, W, mode)
    ev[1].record()
    ev[2].record()
    rp, rc = plain_bwd()
    ev[3].record()
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    f_err = {}
    for name, g_, r_ in (("color", out[..., :3], ref[..., :3]),
                         ("depth", out[..., 3], ref[..., 3]),
                         ("trans", trans, ref_t)):
        f = torch.isfinite(r_)
        scale = r_[f].abs().max().item() if f.any() else 1.0
        f_err[name] = ((g_[f] - r_[f]).abs().max().item()
                       / max(scale, 1e-30) if f.any() else 0.0)
    b_err, b_abs = {}, 0.0
    for key, g_, r_ in (("params", gp, rp), ("colors", gc, rc)):
        for f in range(g_.shape[-1]):
            e = (g_[:, f] - r_[:, f]).abs().max().item()
            s = r_[:, f].abs().max().item()
            b_err[f"{key}{f}"] = e / s if s else e
            b_abs = max(b_abs, e)
    res["k7"].update(rel_err=f_err, abs_err=max(
        (out[fin] - ref[fin]).abs().max().item(), (trans - ref_t).abs().max()
        .item()), inf_equal=bool(torch.equal(fin, torch.isfinite(out))),
        plain_ms=ev[0].elapsed_time(ev[1]))
    res["k8"].update(rel_err=b_err, abs_err=b_abs, plain_bands=-(-H // band),
                     plain_ms=ev[2].elapsed_time(ev[3]),
                     plain_peak_mem_gb=torch.cuda.max_memory_allocated()
                     / 1e9)
    return res


def composite_ok(r):
    """Whether composite_check found K7 / K8 within their tolerances."""
    return (max(r["k7"]["rel_err"].values()) <= COMPOSITE_TOL
            and r["k7"]["inf_equal"]
            and max(r["k8"]["rel_err"].values()) <= KERNEL_BWD_TOL)


def renderer_phases(torch, dev, path_launches, cloud):
    """Phases 67-70: the remaining renderers on the card (K7 / K8 in
    dense and simplified, K5 / K6 in asm, cuBLAS and cuFFT in
    fourier_true).  `cloud` is the decoded cloud of the image->3DGS path.
    Returns K7's and K8's numbers for the kernels line."""
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.core.gaussians import GaussianCloud
    from fresnel_tpu_torch.physics import (
        DiffractiveLayer, MultiscaleDiffractiveLayer)
    from fresnel_tpu_torch.render import (
        binning, dense_composite as dcomp, projection, raster, splat,
        stream_binning, tile)
    from fresnel_tpu_torch.render.dense import dense_inputs
    from fresnel_tpu_torch.render.factory import make_renderer
    from fresnel_tpu_torch.render.simplified import simplified_inputs

    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()

    def counts():
        return renderer_counts(raster, binning, stream_binning, splat, dcomp)

    # 67. kernel_dense_composite
    checks = {}
    for size in COMPOSITE_SIZES:
        cam = Camera.default_training(size).to(dev)
        with torch.no_grad():
            ins = {0: dense_inputs(*cloud, cam),
                   1: simplified_inputs(cloud[0], cloud[1], cloud[3],
                                        cloud[4], cam)}
        for mode, (p, c) in ins.items():
            r = composite_check(torch, dcomp, p.contiguous(), c.contiguous(),
                                size, size, mode, dev)
            checks[f"{r['mode']}_{size}"] = r
        del ins
    cmp_ok = all(composite_ok(r) for r in checks.values())
    log("kernel_dense_composite", checks=checks, tol=COMPOSITE_TOL,
        bwd_tol=KERNEL_BWD_TOL, ops_per_pair=OPS_PER_COMPOSITE,
        ops_per_pair_bwd=OPS_PER_COMPOSITE_BWD,
        residency=dcomp.residency(dev),
        phase_seconds=lap("kernel_dense_composite"))
    if not cmp_ok:
        fail("K7 / K8 disagree with their plain versions")

    # 68. renderers: each at full width, forward and backward
    from fresnel_tpu_torch.pipeline import RENDER_SIZE as size
    cam = Camera.default_training(size).to(dev)
    phases = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 2 * np.pi, cloud[0].shape[0]).astype(np.float32)).to(dev)
    runs = {}
    for name in RENDERER_NAMES:
        r = make_renderer(name)
        args = [t.clone().requires_grad_() for t in cloud]

        def step():
            img, depth = r(*args, cam, phases=phases, return_depth=True)
            loss = img.mean() + depth.mean()
            grads = torch.autograd.grad(loss, args, allow_unused=True)
            return img, depth, grads

        step()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(raster, binning, stream_binning)
        events, outs = [], []
        t0 = time.perf_counter()
        for _ in range(RENDERER_TIMED):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            outs.append(step())
            ev[1].record()
            events.append(ev)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / RENDERER_TIMED
        launched = counts()
        path_launches[f"renderer_{name}"] = launched
        peak = torch.cuda.max_memory_allocated() / 1e9
        img, depth, grads = outs[-1]
        finite = (bool(torch.isfinite(img).all())
                  and bool(torch.isfinite(depth).all())
                  and all(bool(torch.isfinite(g).all())
                          for g in grads if g is not None))
        prof = profile_ms(torch, lambda: [step() for _ in range(2)], 2)
        want = {k: 0 for k in launched}
        want.update({k: v * RENDERER_TIMED
                     for k, v in RENDERER_LAUNCHES[name].items()})
        run = dict(ms_per_render=statistics.median(
            s.elapsed_time(e) for s, e in events), host_ms=host_ms,
            device_ms=prof["device_ms"],
            device_busy_share=prof["device_busy_share"],
            kernels_per_render=prof["kernels"],
            top_kernels_ms=prof["top_kernels_ms"], peak_mem_gb=peak,
            launches=launched, expected_launches=want, finite=finite,
            image_mean=img.mean().item(), image_max=img.max().item(),
            grad_abs_max=[None if g is None else g.abs().max().item()
                          for g in grads])
        if name == "dense":
            with torch.no_grad():
                tiled = tile.render_tiled(
                    *cloud, cam, config=tile.TileRendererConfig(
                        hard_cutoff=False))
                run["vs_render_tiled_hard_cutoff_false"] = dict(
                    max_abs=(tiled - img).abs().max().item(),
                    mean_abs=(tiled - img).abs().mean().item())
        runs[name] = run
        if not (finite and launched == want
                and tuple(img.shape) == (3, size, size)):
            fail(f"renderer {name} at full width: {run}")
        del outs, img, depth, grads, args
    log("renderers", n_gaussians=cloud[0].shape[0], size=size,
        timed=RENDERER_TIMED, runs=runs, phase_seconds=lap("renderers"))

    # 69. renderers_reference: card against CPU on a small cloud
    ref = {}
    rng = np.random.default_rng(RENDERERS_REF["seed"])
    n, rs = RENDERERS_REF["n"], RENDERERS_REF["size"]
    small = GaussianCloud.test_cloud(n, seed=RENDERERS_REF["seed"],
                                     spread=0.6, z_offset=-2.0, scale=0.08)
    ph = torch.from_numpy(rng.uniform(0, 2 * np.pi, n).astype(np.float32))
    w_img = torch.from_numpy(rng.normal(size=(3, rs, rs)).astype(np.float32))
    for name in RENDERER_NAMES:
        res = {}
        for d in (cpu, dev):
            args = [t.to(d).requires_grad_() for t in fields(small)]
            phs = ph.to(d).requires_grad_()
            img, depth = make_renderer(name)(
                *args, Camera.default_training(rs).to(d), phases=phs,
                return_depth=True)
            loss = (img * w_img.to(d)).sum() + depth.sum()
            gs = torch.autograd.grad(loss, args + [phs], allow_unused=True)
            res[d.type] = [img.detach().cpu(), depth.detach().cpu()] + [
                None if g is None else g.cpu() for g in gs]
        errs = []
        for i, (a, b) in enumerate(zip(res["cuda"], res["cpu"])):
            if b is None:
                errs.append(0.0 if a is None else float("inf"))
                continue
            s = b.abs().max().item()
            errs.append((a - b).abs().max().item() / s if s else
                        (a - b).abs().max().item())
        ref[name] = dict(image=errs[0], depth=errs[1], grads=errs[2:])
    field = torch.from_numpy((rng.normal(size=(2, 3, 64, 48))
                              + 1j * rng.normal(size=(2, 3, 64, 48))
                              ).astype(np.complex64))
    for cls in (DiffractiveLayer, MultiscaleDiffractiveLayer):
        m = cls(64, 48, generator=torch.Generator().manual_seed(0))
        res = {}
        for d in (cpu, dev):
            md = m.to(d)
            f = field.to(d).requires_grad_()
            o = md(f)
            # A loss that reads the phase (|o| alone does not depend on it).
            loss = (o.real - 0.5 * o.imag).sum()
            if cls is DiffractiveLayer:
                loss = loss + md.regularization_loss()
            gs = torch.autograd.grad(loss, [f] + list(md.parameters()))
            res[d.type] = [o.detach().cpu()] + [g.cpu() for g in gs]
        errs = [(a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(res["cuda"], res["cpu"])]
        ref[cls.__name__] = dict(output=errs[0], grads=errs[1:])
    worst_img = max(max(v.get("image", 0.0), v.get("depth", 0.0),
                        v.get("output", 0.0)) for v in ref.values())
    worst_grad = max(max(v["grads"]) for v in ref.values())
    log("renderers_reference", n=n, size=rs, errors=ref,
        image_tol=KERNEL_TOL, grad_tol=KERNEL_BWD_TOL,
        worst_image=worst_img, worst_grad=worst_grad,
        phase_seconds=lap("renderers_reference"))
    if not (worst_img <= KERNEL_TOL and worst_grad <= KERNEL_BWD_TOL):
        fail("a renderer or diffractive layer on the card disagrees with "
             "the CPU")

    # 70. depth_sorts: the quantised sorts bit for bit, then a render each
    sorts = {}
    rcam = Camera.default_training(RENDER["res"])
    for method, count in DEPTH_SORT_N.items():
        big = render_cloud(1, count)
        proj = projection.project_gaussians(big.positions, big.scales,
                                            big.rotations, rcam)
        want = projection.depth_sort_indices(proj, method=method)
        on_card = proj.replace(depths=proj.depths.to(dev),
                               visible=proj.visible.to(dev))
        got = projection.depth_sort_indices(on_card, method=method)
        torch.cuda.synchronize()
        t_ms = cuda_median_ms(torch, lambda: projection.depth_sort_indices(
            on_card, method=method), n=5)
        exact_ms = cuda_median_ms(torch, lambda: projection.depth_sort_indices(
            on_card), n=5)
        equal = bool(torch.equal(got.cpu(), want))
        cfg = tile.TileRendererConfig(max_per_tile=RENDER["max_per_tile"],
                                      depth_sort=method)
        args = [t.to(dev) for t in fields(big)]
        with torch.no_grad():
            img = tile.render_tiled(*args, rcam.to(dev), config=cfg)
            ref_img = tile.render_tiled(*args, rcam.to(dev),
                                        config=tile.TileRendererConfig(
                                            max_per_tile=RENDER[
                                                "max_per_tile"]))
            render_ms = cuda_median_ms(torch, lambda: tile.render_tiled(
                *args, rcam.to(dev), config=cfg), n=3)
        sorts[method] = dict(
            n=count, permutation_equal=equal, sort_ms=t_ms,
            exact_sort_ms=exact_ms, render_ms=render_ms,
            render_finite=bool(torch.isfinite(img).all()),
            vs_exact_max_abs=(img - ref_img).abs().max().item(),
            vs_exact_mean_abs=(img - ref_img).abs().mean().item())
        if not (equal and sorts[method]["render_finite"]):
            fail(f"depth sort {method}: {sorts[method]}")
        del big, proj, on_card, args, img, ref_img
    log("depth_sorts", sorts=sorts, phase_seconds=lap("depth_sorts"))
    log("renderer_phases", seconds=phase_s,
        total_seconds=sum(phase_s.values()), cap_seconds=RENDERER_PHASES_CAP_S)

    def row(kk):
        head = checks[f"dense_{size}"][kk]
        return dict(
            max_abs_err=max(r[kk]["abs_err"] for r in checks.values()),
            max_rel_err=max(max(r[kk]["rel_err"].values())
                            for r in checks.values()),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            at=f"the decoded cloud, DENSE, {size}^2 (the renderers' "
               "launch); every mode and size in by_check",
            by_check={k: dict(ms=r[kk]["ms"], bound_ms=r[kk]["bound_ms"],
                              bound_by=r[kk]["bound_by"],
                              plain_ms=r[kk]["plain_ms"],
                              max_abs_err=r[kk]["abs_err"],
                              max_rel_err=max(r[kk]["rel_err"].values()))
                      for k, r in checks.items()},
            rel_err_is=("relative to each output's largest plain value"
                        if kk == "k7" else
                        "relative to each field's largest plain value"))

    return dict(k7=row("k7"), k8=row("k8"))


# lpips_phases: the LPIPS term of decoder training, ms_ssim and the Chamfer
# matching loss (no kernel of their own; the term's backward runs through
# K2).  lpips_module writes random lpips-alex files at the published
# shapes (models/backbone_files.py) in both torch namings and as an .npz,
# loads each onto the card and holds the distance and its gradients with
# respect to both images against the CPU at the term's shape (the
# flagship batch of 8 at 128^2); lpips_train drives `cli train` at the
# flagship flags with --lpips_weights, in float32 and with --use_amp,
# holds two steps of a small config card against CPU with the term on,
# and times the flagship step with the term on and off in one call;
# ms_ssim_matching holds ms_ssim at 256^2 and 128^2 and
# gaussian_matching_loss at its default max_match_points card against
# CPU, with the matching loss's ms and peak memory.
LPIPS_PHASES_CAP_S = 75.0
LPIPS_B, LPIPS_SIZE = 8, 128
# Distance within 1e-5 relative, gradients within 1e-4 of their largest
# entry (cuDNN's float32 convolutions, TF32 off, against the CPU's).
LPIPS_TOL, LPIPS_GRAD_TOL = 1e-5, 1e-4
LPIPS_WEIGHT = 0.1            # TrainingConfig's and the CLI's default
LPIPS_SCENES, LPIPS_CLI_EPOCHS = 8, 2
LPIPS_WARMUP, LPIPS_TIMED, LPIPS_PROFILED = 2, 8, 3
LPIPS_REF_STEPS = 2
MS_SSIM_SIZES, MS_SSIM_TOL = (256, 128), 1e-5
# The matching loss at its default max_match_points: a batch of 4, 5 476
# predictions (K 4 over a 37^2 grid) and 16 384 targets, the last 300 and
# 1 000 of each zero-padded, subsampled to 4 096 and 8 192.
MATCH = dict(B=4, n_pred=5476, n_target=16384, pad_pred=300,
             pad_target=1000)
MATCH_RTOL, MATCH_TIMED = 1e-5, 5


def match_inputs(seed):
    """(pred, target, target_mask) float32 / bool numpy for MATCH."""
    rng = np.random.default_rng(seed)

    def rows(n, pad):
        g = np.concatenate([
            rng.uniform(-1, 1, (MATCH["B"], n, 3)),
            rng.uniform(-4, -1, (MATCH["B"], n, 3)),
            rng.normal(size=(MATCH["B"], n, 4)),
            rng.uniform(0, 1, (MATCH["B"], n, 4))], -1).astype(np.float32)
        g[:, n - pad:] = 0.0
        return g

    pred = rows(MATCH["n_pred"], MATCH["pad_pred"])
    target = rows(MATCH["n_target"], MATCH["pad_target"])
    return pred, target, rng.uniform(size=target.shape[:2]) > 0.1


def lpips_phases(torch, dev, path_launches):
    """Phases 71-74: the LPIPS term in decoder training, ms_ssim and the
    matching loss."""
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.losses import lpips as tlp
    from fresnel_tpu_torch.losses.matching import gaussian_matching_loss
    from fresnel_tpu_torch.losses.ssim import ms_ssim
    from fresnel_tpu_torch.models.backbone_files import (
        lpips_checkpoint, save_checkpoint)
    from fresnel_tpu_torch.render import (
        binning, raster, splat, stream_binning)
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lpips_")

    def read():
        return read_all_counts(raster, binning, stream_binning, splat)

    def per_step(launches, n):
        return {k: v / n for k, v in launches.items() if v}

    # 71. lpips_module: the three files, loaded onto the card.
    files = {n: os.path.join(tmp, f"lpips_alex_{n}.pth")
             for n in ("lpips", "torchvision")}
    for naming, path in files.items():
        save_checkpoint(path, lpips_checkpoint(naming, seed=0))
    files["npz"] = os.path.join(tmp, "lpips_alex.npz")
    np.savez(files["npz"], **tlp.convert_torch_lpips(files["lpips"]))
    mods, load_s = {}, {}
    for name, path in files.items():
        t0 = time.perf_counter()
        mods[name] = tlp.load_lpips(path, device=dev)
        torch.cuda.synchronize()
        load_s[name] = time.perf_counter() - t0
    want_sd = mods["lpips"].state_dict()
    same = all(torch.equal(m.state_dict()[k], v) for m in mods.values()
               for k, v in want_sd.items())
    on_card = all(p.device.type == "cuda" and p.dtype == torch.float32
                  and not p.requires_grad
                  for m in mods.values() for p in m.parameters())
    m_cpu = tlp.load_lpips(files["lpips"], device=cpu)
    imgs = np.stack([smooth_image(LPIPS_SIZE, s)
                     for s in range(2 * LPIPS_B)]) * 2 - 1
    a, b = imgs[:LPIPS_B], imgs[LPIPS_B:]

    def dist_grads(m, d):
        x = torch.from_numpy(a).to(d).requires_grad_()
        y = torch.from_numpy(b).to(d).requires_grad_()
        dist = m(x, y)
        gx, gy = torch.autograd.grad(dist.sum(), (x, y))
        return dist.detach().cpu(), gx.cpu(), gy.cpu()

    want = dist_grads(m_cpu, cpu)
    errs = {}
    for name, m in mods.items():
        got = dist_grads(m, dev)
        errs[name] = dict(
            dist_rel=((got[0] - want[0]).abs() / want[0].abs()).max().item(),
            grad1_rel=((got[1] - want[1]).abs().max()
                       / want[1].abs().max()).item(),
            grad2_rel=((got[2] - want[2]).abs().max()
                       / want[2].abs().max()).item())
    x = torch.from_numpy(a).to(dev).requires_grad_()
    y = torch.from_numpy(b).to(dev)
    m = mods["lpips"]
    with torch.no_grad():
        fwd_ms = cuda_median_ms(torch, lambda: m(x, y), n=10)
    fwd_bwd_ms = cuda_median_ms(
        torch, lambda: torch.autograd.grad(m(x, y).sum(), x), n=10)
    prof = profile_ms(torch, lambda: [torch.autograd.grad(
        m(x, y).sum(), x) for _ in range(3)], 3, top=6, cpu=False)
    log("lpips_module", files={n: os.path.getsize(p)
                               for n, p in files.items()},
        load_seconds=load_s, tensors=len(want_sd),
        params=sum(v.numel() for v in want_sd.values()),
        loads_equal=same, float32_frozen_on_card=on_card,
        batch=LPIPS_B, size=LPIPS_SIZE, dist_cpu=want[0].tolist(),
        errors=errs, dist_rtol=LPIPS_TOL, grad_tol=LPIPS_GRAD_TOL,
        allow_tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                        cudnn=torch.backends.cudnn.allow_tf32),
        fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
        fwd_bwd_device_ms=prof["device_ms"],
        fwd_bwd_kernels=prof["kernels"],
        top_kernels_ms=prof["top_kernels_ms"],
        phase_seconds=lap("lpips_module"))
    if not (same and on_card and all(
            e["dist_rel"] <= LPIPS_TOL and e["grad1_rel"] <= LPIPS_GRAD_TOL
            and e["grad2_rel"] <= LPIPS_GRAD_TOL for e in errs.values())):
        fail(f"LPIPS on the card disagrees with the CPU: {errs}")

    # 72. lpips_train: cli train with --lpips_weights, then the step.
    data_dir = os.path.join(tmp, "corpus")
    synthetic_corpus.generate_corpus(data_dir, n_images=LPIPS_SCENES,
                                     image_size=TRAIN["image_size"], seed=0)
    B, K = TRAIN["batch_size"], TRAIN["gaussians_per_patch"]
    steps = LPIPS_CLI_EPOCHS * max(1, LPIPS_SCENES // B)
    cli_runs = {}
    for name, extra in (("float32", []), ("bf16", ["--use_amp"])):
        out_dir = os.path.join(tmp, f"cli_{name}")
        argv = ["--data_dir", data_dir, "--output_dir", out_dir, "--epochs",
                str(LPIPS_CLI_EPOCHS), "--batch_size", str(B), "--lr",
                str(TRAIN["lr"]), "--image_size", str(TRAIN["image_size"]),
                "--gaussians_per_patch", str(K), "--surface_init",
                "--depth_offset_init", str(TRAIN["depth_offset_init"]),
                "--train_encoder", "--feature_size",
                str(TRAIN["feature_size"]), "--encoder_width",
                str(TRAIN["encoder_width"]), "--max_per_tile",
                str(TRAIN["max_per_tile"]), "--no_augmentation",
                "--lpips_weights", files["lpips"], "--lpips_weight",
                str(LPIPS_WEIGHT), "--device", dev.type] + extra
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        (trainer, _), printed = quiet(tcli.main, argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read()
        path_launches[f"lpips_cli_{name}"] = launches
        with open(os.path.join(out_dir, "final_model.pt.json")) as f:
            meta = json.load(f)
        hist = trainer.history
        cli_runs[name] = dict(
            seconds=seconds, launches=launches,
            lpips_loaded=trainer.lpips is not None,
            lpips_device=str(next(trainer.lpips.parameters()).device),
            lpips_dtype=str(next(trainer.lpips.parameters()).dtype),
            history_lpips=hist.get("lpips"), history_total=hist["total"],
            sidecar=dict(lpips_weight=meta["config"]["lpips_weight"],
                         use_amp=meta["config"]["use_amp"]))
        cli_runs[name]["said"] = [ln for ln in printed.splitlines()
                                  if "LPIPS" in ln]
        ok = (trainer.lpips is not None and "lpips" in hist
              and f"LPIPS weights loaded from {files['lpips']}" in printed
              and np.all(np.isfinite(hist["lpips"] + hist["total"]))
              and meta["config"]["lpips_weight"] == LPIPS_WEIGHT
              and meta["config"]["use_amp"] == (name == "bf16")
              and cli_runs[name]["lpips_dtype"] == "torch.float32"
              and launches == dict(k1=steps, k2=steps, k3=0, k4=0,
                                   k1phi=0, k2phi=0, k5=0, k6=0))
        if not ok:
            fail(f"cli train --lpips_weights ({name}): {cli_runs[name]}")
        del trainer
    lap("lpips_cli")

    # Card against CPU: TRAIN_REF with the term, 2 steps from one init.
    small = ImageDataset(data_dir, image_size=TRAIN_REF["image_size"],
                         feature_dim=384, use_augmentation=False, device=dev)
    ref_batches = train_batches(small, TRAIN_REF["batch_size"],
                                LPIPS_REF_STEPS)
    runs = {}
    for name, d, amp in (("card", dev, False), ("cpu", cpu, False),
                         ("card_bf16", dev, True), ("cpu_bf16", cpu, True)):
        trainer, state = train_setup(
            torch, d, dict(TRAIN_REF, lpips_weight=LPIPS_WEIGHT,
                           use_amp=amp),
            os.path.join(tmp, f"ref_{name}"), dropout=0.0,
            lpips=tlp.load_lpips(files["lpips"], device=d))
        trainer._make_optimizer(LPIPS_REF_STEPS)
        gen = torch.Generator(device=d).manual_seed(1)
        losses = []
        for batch in ref_batches:
            state, ld = trainer.train_step(
                state, trainer.device_batch(batch),
                TRAIN_REF["gaussians_per_patch"], None, gen)
            losses.append({k: float(v) for k, v in ld.items()})
        runs[name] = losses
    rel = {k: max(abs(g[k] - w[k]) / abs(w[k])
                  for g, w in zip(runs["card"], runs["cpu"]))
           for k in ("lpips", "total")}
    # bf16: the first step's losses (the same init on both sides) within
    # AMP_GAP x the CPU's own bf16 gap; the second step's ratio is logged
    # (a bf16 update parts the trajectories by about that gap again).
    amp_ok, amp_worst, amp_at = amp_gap_ok(
        runs["card_bf16"][:1], runs["cpu_bf16"][:1], runs["cpu"][:1],
        keys=("lpips", "total"))
    _, amp_worst_2, amp_at_2 = amp_gap_ok(
        runs["card_bf16"][1:], runs["cpu_bf16"][1:], runs["cpu"][1:],
        keys=("lpips", "total"))
    reference = dict(
        steps=LPIPS_REF_STEPS, lpips_card=[r["lpips"] for r in runs["card"]],
        lpips_cpu=[r["lpips"] for r in runs["cpu"]],
        total_card=[r["total"] for r in runs["card"]],
        total_cpu=[r["total"] for r in runs["cpu"]], rel_err=rel,
        rtol=REF_LOSS_RTOL,
        bf16=dict(lpips_card=[r["lpips"] for r in runs["card_bf16"]],
                  lpips_cpu=[r["lpips"] for r in runs["cpu_bf16"]],
                  total_card=[r["total"] for r in runs["card_bf16"]],
                  total_cpu=[r["total"] for r in runs["cpu_bf16"]],
                  worst_ratio_step1=amp_worst, worst_term_step1=amp_at,
                  worst_ratio_step2=amp_worst_2,
                  worst_term_step2=amp_at_2, gap_factor=AMP_GAP))
    if not (max(rel.values()) <= REF_LOSS_RTOL and amp_ok):
        fail(f"lpips_train: the card's steps disagree with the CPU's: "
             f"{reference}")
    lap("lpips_reference")

    # The flagship step with the term on and off, float32 and bf16, in
    # turns (off, on, on, off) on the same batches.
    big = ImageDataset(data_dir, image_size=TRAIN["image_size"],
                       feature_dim=TRAIN["feature_dim"],
                       use_augmentation=False, device=dev)
    host_batches = train_batches(big, B, LPIPS_WARMUP + LPIPS_TIMED)
    half = LPIPS_TIMED // 2
    timing = {}
    for precision, amp in (("float32", False), ("bf16", True)):
        live = {}
        for term in ("off", "on"):
            trainer, state = train_setup(
                torch, dev, dict(TRAIN, use_amp=amp, lpips_weight=(
                    LPIPS_WEIGHT if term == "on" else 0.0)),
                os.path.join(tmp, f"{precision}_{term}"),
                lpips=mods["lpips"] if term == "on" else None)
            trainer._make_optimizer(TRAIN["epochs"])
            batches = [trainer.device_batch(hb) for hb in host_batches]
            gen = torch.Generator(device=dev).manual_seed(1)
            for hb in batches[:LPIPS_WARMUP]:
                state, _ = trainer.train_step(state, hb, K, None, gen)
            live[term] = dict(trainer=trainer, state=state, batches=batches,
                              gen=gen, ms=[], host_ms=[], losses=[],
                              launches={})
        for turn, term in enumerate(("off", "on", "on", "off")):
            r = live[term]
            first = LPIPS_WARMUP + half * (turn in (2, 3))
            torch.cuda.synchronize()
            reset_counts(*counters)
            events = []
            t0 = time.perf_counter()
            for hb in r["batches"][first:first + half]:
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                r["state"], ld = r["trainer"].train_step(
                    r["state"], hb, K, None, r["gen"])
                end.record()
                events.append((start, end))
                r["losses"].append(ld)
            torch.cuda.synchronize()
            r["host_ms"].append((time.perf_counter() - t0) / half * 1e3)
            r["ms"].extend(s_.elapsed_time(e_) for s_, e_ in events)
            for k, v in read().items():
                r["launches"][k] = r["launches"].get(k, 0) + v
        out = {}
        for term in ("off", "on"):
            r = live.pop(term)

            def run_steps():
                for hb in r["batches"][:LPIPS_PROFILED]:
                    r["state"], _ = r["trainer"].train_step(
                        r["state"], hb, K, None, r["gen"])

            prof = profile_ms(torch, run_steps, LPIPS_PROFILED, top=6,
                              cpu=False)
            lpips_seen = all("lpips" in ld for ld in r["losses"])
            totals = [float(ld["total"]) for ld in r["losses"]]
            path_launches[f"lpips_train_{precision}_{term}"] = r["launches"]
            out[term] = dict(
                ms_per_step_median=statistics.median(r["ms"]),
                ms_per_step=r["ms"],
                host_ms_per_step=statistics.mean(r["host_ms"]),
                device_ms_per_step=prof["device_ms"],
                device_busy_share=prof["device_busy_share"],
                kernels_per_step=prof["kernels"],
                top_kernels_ms_per_step=prof["top_kernels_ms"],
                launches_per_step=per_step(r["launches"], LPIPS_TIMED),
                lpips_in_loss=lpips_seen, losses=totals)
            if not (per_step(r["launches"], LPIPS_TIMED)
                    == dict(k1=1.0, k2=1.0)
                    and lpips_seen == (term == "on")
                    and np.all(np.isfinite(totals))):
                fail(f"lpips_train {precision} term {term}: {out[term]}")
            del r
        out["on_minus_off"] = {
            k: out["on"][k] - out["off"][k] for k in (
                "ms_per_step_median", "host_ms_per_step",
                "device_ms_per_step", "kernels_per_step")}
        timing[precision] = out
    log("lpips_train", config=TRAIN, lpips_weight=LPIPS_WEIGHT,
        scenes=LPIPS_SCENES, cli=cli_runs, reference=reference,
        warmup_steps=LPIPS_WARMUP, steps=LPIPS_TIMED,
        turns=["off", "on", "on", "off"], profiled_steps=LPIPS_PROFILED,
        **timing, phase_seconds=lap("lpips_train"))

    # 73. ms_ssim_matching: ms_ssim and the matching loss, card vs CPU.
    ms = {}
    for size in MS_SSIM_SIZES:
        x = np.stack([smooth_image(size, 100 + s) for s in range(LPIPS_B)])
        rng = np.random.default_rng(size)
        y = np.clip(x + rng.normal(scale=0.05, size=x.shape), 0, 1).astype(
            np.float32)
        xc, yc = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        card = ms_ssim(xc, yc).item()
        want = ms_ssim(torch.from_numpy(x), torch.from_numpy(y)).item()
        ms[size] = dict(card=card, cpu=want, abs_err=abs(card - want),
                        ms=cuda_median_ms(torch, lambda: ms_ssim(xc, yc),
                                          n=10))
    pred, target, tmask = match_inputs(73)
    args_cpu = (torch.from_numpy(pred), torch.from_numpy(target))
    args_dev = tuple(t.to(dev) for t in args_cpu)
    tm_cpu = torch.from_numpy(tmask)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = gaussian_matching_loss(*args_dev, target_mask=tm_cpu.to(dev))
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
    match_ms = cuda_median_ms(torch, lambda: gaussian_matching_loss(
        *args_dev, target_mask=tm_cpu.to(dev)), n=MATCH_TIMED, warmup=1)
    t0 = time.perf_counter()
    want = gaussian_matching_loss(*args_cpu, target_mask=tm_cpu)
    cpu_s = time.perf_counter() - t0
    match_rel = {k: abs(got[k].item() - v.item()) / abs(v.item())
                 for k, v in want.items()}
    log("ms_ssim_matching", ms_ssim={str(k): v for k, v in ms.items()},
        ms_ssim_batch=LPIPS_B, ms_ssim_tol=MS_SSIM_TOL, matching=dict(
            MATCH, max_match_points=4096, diff_shape=[MATCH["B"], 4096,
                                                      8192, 3],
            card={k: v.item() for k, v in got.items()},
            cpu={k: v.item() for k, v in want.items()}, rel_err=match_rel,
            rtol=MATCH_RTOL, ms=match_ms, peak_mem_gb=peak_gb,
            cpu_seconds=cpu_s),
        phase_seconds=lap("ms_ssim_matching"))
    if not (all(v["abs_err"] <= MS_SSIM_TOL for v in ms.values())
            and max(match_rel.values()) <= MATCH_RTOL):
        fail("ms_ssim or the matching loss on the card disagrees with the "
             "CPU")
    shutil.rmtree(tmp, ignore_errors=True)
    log("lpips_phases", seconds=phase_s, total_seconds=sum(phase_s.values()),
        cap_seconds=LPIPS_PHASES_CAP_S)


# Phases 75-80: ROADMAP Queue 1, item 10 (the rest of train/, data/ and
# utils/).
ITEM10_PHASES_CAP_S = 150.0
# cloud/train_overnight.sh over a seeded folder of 16 images: its
# preprocessing (DINOv2 ViT-S/14 and Depth-Anything-V2-Small files at the
# published shapes, random from a seed, found under FRESNEL_TPU_MODELS),
# its training flags with the 100 epochs cut to 2 (2 steps each), and its
# eval of the best checkpoint on 8 images.
OVERNIGHT_SCENES, OVERNIGHT_REF_IMAGES, OVERNIGHT_EVAL_IMAGES = 16, 2, 8
OVERNIGHT_FLAGS = ["--experiment", "2", "--batch_size", "8", "--image_size",
                   "256", "--use_fresnel_zones", "--use_edge_aware",
                   "--progressive_schedule", "--epochs", "2"]
OVERNIGHT_TURNS = ("memory", "streaming", "streaming", "memory")
OVERNIGHT_LOSS_RTOL = 1e-6
THIN_MSGPACK = "exp2"            # a committed full float32 checkpoint
TUNER_FLAGS = ["--synthetic", "--trials", "2", "--trial_epochs", "1"]
# train_depth --synthetic at its defaults (128^2, base 32, batch 8, 64
# samples), 2 epochs; 3 steps card against CPU from one init.
DEPTH_EPOCHS, DEPTH_TIMED, DEPTH_REF_STEPS, DEPTH_RTOL = 2, 8, 3, 1e-5
DEPTH_PARAM_MEAN_TOL = 1e-6
DEPTH_ZERO_GRAD = "convs.13.bias"     # the output conv's bias


def item10_phases(torch, dev, path_launches, tmp):
    """Phases 75-80: the overnight launcher's three steps with and without
    --streaming, thin checkpoints, the two tuners, depth training and the
    stage-timed render."""
    import copy
    from pathlib import Path

    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.data import depth_dataset, preprocess
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset, _load_image
    from fresnel_tpu_torch.data.streaming import StreamingImageDataset
    from fresnel_tpu_torch.models import backbone_files as bfiles
    from fresnel_tpu_torch.models import encoders
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import auto_tune, hyperparam_search
    from fresnel_tpu_torch.train import thin_ckpt, train_depth
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
    from fresnel_tpu_torch.train.harness import (
        Trainer, trainer_from_checkpoint)
    from fresnel_tpu_torch.utils import profiling

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    root = os.path.join(tmp, "item10")
    env_before = os.environ.get("FRESNEL_TPU_MODELS")

    def run(fn, argv):
        """fn(argv) on the card, timed and counted: (result, printed,
        seconds, launches)."""
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.perf_counter()
        out, printed = quiet(fn, argv)
        torch.cuda.synchronize()
        return out, printed, time.perf_counter() - t0, read_counts(*counters)

    # 75. overnight: preprocess, train with and without --streaming, eval.
    models = os.path.join(root, "models")
    os.makedirs(models)
    files = {"dinov2": os.path.join(models, "dinov2_small.safetensors"),
             "depth": os.path.join(models,
                                   "depth_anything_v2_small.safetensors")}
    bfiles.save_checkpoint(files["dinov2"],
                           bfiles.dinov2_checkpoint("hf", seed=11))
    bfiles.save_checkpoint(files["depth"],
                           bfiles.depth_anything_checkpoint(seed=12))
    os.environ["FRESNEL_TPU_MODELS"] = models
    try:
        corpus = os.path.join(root, "corpus")
        synthetic_corpus.generate_corpus(corpus, n_images=OVERNIGHT_SCENES,
                                         image_size=256, seed=7)
        data, ref = os.path.join(root, "images"), os.path.join(root, "ref")
        os.makedirs(data)
        os.makedirs(ref)
        pngs = sorted(Path(corpus).glob("*.png"))
        for i, png in enumerate(pngs):
            shutil.copy(png, data)
            if i < OVERNIGHT_REF_IMAGES:
                shutil.copy(png, ref)
        n_card, printed, pre_s, pre_launch = run(preprocess.main, [data])
        n_cpu, printed_cpu, pre_cpu_s, _ = run(
            preprocess.main, [ref, "--device", "cpu"])
        found = ("features: dinov2" in printed
                 and "depth: depth_anything" in printed)
        ext32 = encoders.DINOv2FeatureExtractor(
            files["dinov2"], compute_dtype=torch.float32, device=cpu)
        est32 = encoders.DepthAnythingEstimator(
            files["depth"], compute_dtype=torch.float32, device=cpu)
        cache_errs, sizes_equal = [], True
        for png in pngs[:OVERNIGHT_REF_IMAGES]:
            img = torch.from_numpy(_load_image(png, 518))
            f32 = {"dinov2": ext32(img).float(), "depth": est32(img).float()}
            for kind, shape in (("dinov2", (37, 37, 384)),
                                ("depth", (256, 256))):
                name = f"{png.stem}_{kind}.bin"
                a, b = Path(data) / name, Path(ref) / name
                sizes_equal &= a.stat().st_size == b.stat().st_size == (
                    4 * int(np.prod(shape)))
                card = torch.from_numpy(np.fromfile(a, np.float32)).reshape(
                    shape)
                cpu16 = torch.from_numpy(np.fromfile(b, np.float32)).reshape(
                    shape)
                cache_errs.append(dict(
                    file=name, card_vs_cpu_f32=rel_max(torch, card,
                                                       f32[kind]),
                    cpu_bf16_gap=rel_max(torch, cpu16, f32[kind])))
        del ext32, est32
        log("overnight_preprocess", images=n_card, seconds=pre_s,
            ms_per_image=pre_s * 1e3 / max(n_card, 1),
            backbones_found=found, launches=pre_launch,
            cpu_reference=dict(images=n_cpu, seconds=pre_cpu_s,
                               errors=cache_errs,
                               rule="card bf16 within 2 x the CPU's "
                               "bf16-vs-f32 gap of the CPU's f32"),
            sizes_equal=sizes_equal, phase_seconds=lap("overnight"))
        if not (n_card == OVERNIGHT_SCENES and n_cpu == OVERNIGHT_REF_IMAGES
                and found and sizes_equal
                and all(e["card_vs_cpu_f32"] <= 2 * e["cpu_bf16_gap"]
                        for e in cache_errs)):
            fail(f"overnight preprocessing failed its checks: {cache_errs}")

        # The launcher's training, in turns with and without --streaming.
        cfg, phys, hfgs, hfts = tcli.configs_from_args(
            tcli.build_parser().parse_args(["--data_dir", data]
                                           + OVERNIGHT_FLAGS))
        cfg.lpips_weight = 0.0          # no LPIPS file: the CLI drops it
        steps = OVERNIGHT_SCENES // cfg.batch_size
        runs = []
        for i, mode in enumerate(OVERNIGHT_TURNS):
            out_dir = os.path.join(root, f"train_{i}_{mode}")
            argv = (["--data_dir", data, "--output_dir", out_dir]
                    + OVERNIGHT_FLAGS
                    + (["--streaming"] if mode == "streaming" else []))
            (trainer, state), _, secs, launches = run(tcli.main, argv)
            path_launches[f"overnight_train_{i}_{mode}"] = launches
            runs.append(dict(mode=mode, out_dir=out_dir, seconds=secs,
                             launches=launches, step=int(state["step"]),
                             losses=list(trainer.history["total"])))
            del trainer, state
        first = runs[0]["losses"][0]
        loss_rel = max(abs(r["losses"][0] - first) / abs(first)
                       for r in runs)
        streamed = len(list(Path(data).glob(
            f"*_rgb{cfg.image_size}.bin")))
        # ms per step, device ms, busy share, kernels per step and the
        # host ms waiting for each batch, one epoch per turn (2 steps).
        datasets = {
            "memory": ImageDataset(data, image_size=cfg.image_size,
                                   device=dev),
            "streaming": StreamingImageDataset(
                data, image_size=cfg.image_size, device=dev)}
        tr = Trainer(cfg, phys, hfgs, hfts, device=dev)
        K = hfts.get_gaussians_per_patch(0, cfg.epochs,
                                         cfg.gaussians_per_patch)
        box = [tr.init_state()]
        gen = torch.Generator(device=dev).manual_seed(1)

        def epoch(ds, waits):
            it = ds.batches(cfg.batch_size, np.random.default_rng(0))
            while True:
                t0 = time.perf_counter()
                b = next(it, None)
                if b is None:
                    return
                waits.append((time.perf_counter() - t0) * 1e3)
                box[0], _ = tr.train_step(box[0], tr.device_batch(b), K,
                                          None, gen)

        for ds in datasets.values():                       # warmup
            epoch(ds, [])
        turns = []
        for mode in OVERNIGHT_TURNS:
            waits = []
            prof = profile_ms(torch, lambda: epoch(datasets[mode], waits),
                              steps, top=4, cpu=False)
            turns.append(dict(mode=mode, ms_per_step=prof["wall_ms"],
                              device_ms_per_step=prof["device_ms"],
                              device_busy_share=prof["device_busy_share"],
                              kernels_per_step=prof["kernels"],
                              wait_ms_first_batch=waits[0],
                              wait_ms_next_batches=waits[1:]))
        del datasets, tr, box
        best = os.path.join(runs[0]["out_dir"], "best_model.pt")
        ev_json = os.path.join(root, "eval.json")
        rc, _, ev_s, ev_launch = run(cli.main, [
            "eval", best, "--data_dir", data, "--max_images",
            str(OVERNIGHT_EVAL_IMAGES), "--output_json", ev_json])
        path_launches["overnight_eval"] = ev_launch
        with open(ev_json) as f:
            ev = json.load(f)
        ev_numbers = [v for v in ev.values() if isinstance(v, float)]
        log("overnight", flags=OVERNIGHT_FLAGS, scenes=OVERNIGHT_SCENES,
            runs=[{k: v for k, v in r.items() if k != "out_dir"}
                  for r in runs],
            first_epoch_loss_rel_max=loss_rel,
            loss_rtol=OVERNIGHT_LOSS_RTOL, rgb_caches=streamed,
            steps=turns, eval=dict(rc=rc, seconds=ev_s, launches=ev_launch,
                                   results=ev),
            phase_seconds=lap("overnight"))
        if not (loss_rel <= OVERNIGHT_LOSS_RTOL
                and streamed == OVERNIGHT_SCENES
                and all(r["step"] == 2 * steps
                        and r["launches"] == dict(k1=2 * steps,
                                                  k2=2 * steps, k3=0, k4=0)
                        and np.all(np.isfinite(r["losses"]))
                        for r in runs)
                and rc == 0 and ev_launch["k1"] > 0 and ev_launch["k2"] == 0
                and ev_numbers and np.all(np.isfinite(ev_numbers))):
            fail("the overnight launcher's training or eval failed its "
                 "checks")

        # 76. thin_ckpt: the run's final_model.pt thinned and resumed for
        # one epoch; a committed Flax checkpoint thinned and decoded.
        src = os.path.join(runs[0]["out_dir"], "final_model.pt")
        thin = os.path.join(root, "thin_final.pt")
        rc_thin, thin_line, _, _ = run(thin_ckpt.main, [src, thin])
        ratio = os.path.getsize(thin) / os.path.getsize(src)
        argv = (["--data_dir", data, "--output_dir",
                 os.path.join(root, "resume"), "--resume", thin]
                + OVERNIGHT_FLAGS[:-1] + ["3"])
        (trainer, state), printed, res_s, res_launch = run(tcli.main, argv)
        path_launches["thin_resume"] = res_launch
        resumed = dict(seconds=res_s, launches=res_launch,
                       step=int(state["step"]),
                       losses=list(trainer.history["total"]),
                       thin_message="thin resume from" in printed)
        del trainer, state
        ck = ckpt_path(THIN_MSGPACK)
        thin_flax = os.path.join(root, f"{THIN_MSGPACK}_thin.pt")
        run(thin_ckpt.main, [ck, thin_flax])
        tr = trainer_from_checkpoint(thin_flax, device=dev)
        st_thin, ep = tr.load_checkpoint(thin_flax)
        st_full, _ = tr.load_checkpoint(ck)
        rounded = all(torch.equal(v, st_full["params"][k].to(
            torch.bfloat16).float()) for k, v in st_thin["params"].items())
        png = pngs[0]
        feats = np.fromfile(Path(data) / f"{png.stem}_dinov2.bin",
                            np.float32).reshape(1, 37, 37, 384)
        depth = np.fromfile(Path(data) / f"{png.stem}_depth.bin",
                            np.float32).reshape(1, 256, 256)
        reset_counts(*counters)
        out = tr.decode(st_thin["params"], feats, depth)
        out_full = tr.decode(st_full["params"], feats, depth)
        path_launches["thin_decode"] = read_counts(*counters)
        finite = all(bool(torch.isfinite(v).all()) for v in out.values())
        dec_gap = {k: (out[k] - out_full[k]).abs().max().item()
                   for k in FIELDS}
        log("thin_ckpt", thin_line=thin_line.strip(), size_ratio=ratio,
            resume=resumed, msgpack=dict(
                source=os.path.basename(ck),
                size_ratio=os.path.getsize(thin_flax) / os.path.getsize(ck),
                epoch=ep, params_bf16_rounded=rounded,
                gaussians=int(out["positions"].shape[1]), finite=finite,
                max_abs_vs_full=dec_gap),
            phase_seconds=lap("thin_ckpt"))
        if not (rc_thin == 0 and ratio < 0.25 and resumed["thin_message"]
                and resumed["step"] == 2 * steps + steps
                and len(resumed["losses"]) == 1
                and np.isfinite(resumed["losses"][0])
                and res_launch == dict(k1=steps, k2=steps, k3=0, k4=0)
                and rounded and finite
                and out["positions"].shape[1] == 37 * 37 * 4):
            fail("thin checkpoints failed their checks")
        del tr, st_thin, st_full
    finally:
        if env_before is None:
            os.environ.pop("FRESNEL_TPU_MODELS", None)
        else:
            os.environ["FRESNEL_TPU_MODELS"] = env_before

    # 77. tuners at their CLI defaults (64^2, batch 2, K 1, 4 synthetic
    # scenes), cut to 2 trials of 1 epoch.
    tuners = {}
    for name, mod, extra, result in (
            ("auto_tune", auto_tune, ["--rungs", "2"], "study.json"),
            ("hyperparam_search", hyperparam_search, [], "results.json")):
        out_dir = os.path.join(root, name)
        best_t, _, secs, launches = run(
            mod.main, TUNER_FLAGS + extra + ["--output_dir", out_dir])
        path_launches[name] = launches
        with open(os.path.join(out_dir, result)) as f:
            trials = json.load(f)["trials"]
        score = "score" if name == "auto_tune" else "chamfer"
        tuners[name] = dict(seconds=secs, launches=launches,
                            scores=[t[score] for t in trials],
                            lrs=[t["params"]["lr"] for t in trials])
    log("tuners", flags=TUNER_FLAGS, **tuners,
        phase_seconds=lap("tuners"))
    if not all(len(t["scores"]) == 2 and np.all(np.isfinite(t["scores"]))
               and t["launches"]["k1"] > 0 and t["launches"]["k2"] > 0
               for t in tuners.values()):
        fail(f"the tuners failed their checks: {tuners}")

    # 78. depth_train: train_depth --synthetic at its defaults, 2 epochs;
    # its step timed; 3 steps against the CPU from one init.
    (model, hist), _, depth_s, _ = run(train_depth.main, [
        "--synthetic", "--epochs", str(DEPTH_EPOCHS), "--output_dir",
        os.path.join(root, "depth")])
    dcfg = train_depth.DepthTrainConfig()
    dds = depth_dataset.SyntheticDepthDataset(
        n_samples=64, image_size=dcfg.image_size, seed=dcfg.seed)
    dbatches = list(dds.batches(dcfg.batch_size, np.random.default_rng(0)))

    def depth_steps(device, batches, model=None):
        model = model or train_depth.build_depth_net(
            dcfg.base_channels, dcfg.seed).to(device)
        opt = train_depth.make_optimizer(model, dcfg.lr)
        return model, [float(train_depth.train_step(
            model, opt, torch.from_numpy(b["image"]).to(device),
            torch.from_numpy(b["depth"]).to(device))[0]) for b in batches]

    card_model, _ = depth_steps(dev, dbatches[:2])          # warmup
    opt = train_depth.make_optimizer(card_model, dcfg.lr)
    imgs = [torch.from_numpy(b["image"]).to(dev) for b in dbatches]
    deps = [torch.from_numpy(b["depth"]).to(dev) for b in dbatches]
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    for i in range(DEPTH_TIMED):
        train_depth.train_step(card_model, opt, imgs[i], deps[i])
    end.record()
    torch.cuda.synchronize()
    depth_ms = start.elapsed_time(end) / DEPTH_TIMED
    # Free-running, each side from one init: Adam's first steps are about
    # lr * sign(g), so an entry whose gradient sits at rounding level
    # steps either way and later losses part by more than rounding; that
    # trajectory is logged.  The gate starts the card's every step from
    # the CPU's state (parameters and Adam's moments): its loss within
    # DEPTH_RTOL relative, its updated parameters within
    # DEPTH_PARAM_MEAN_TOL of the CPU's by mean absolute difference, but
    # the output conv's bias: the min-max normalisation removes any
    # constant, so its gradient is rounding noise of either sign and Adam
    # steps it by up to lr either way (held within 2 * lr).
    _, free_card = depth_steps(dev, dbatches[:DEPTH_REF_STEPS])
    cpu_model = train_depth.build_depth_net(dcfg.base_channels, dcfg.seed)
    cpu_opt = train_depth.make_optimizer(cpu_model, dcfg.lr)
    card_model = train_depth.build_depth_net(dcfg.base_channels,
                                             dcfg.seed).to(dev)
    card_opt = train_depth.make_optimizer(card_model, dcfg.lr)
    forced = []
    for b in dbatches[:DEPTH_REF_STEPS]:
        card_model.load_state_dict(cpu_model.state_dict())
        card_opt.load_state_dict(copy.deepcopy(cpu_opt.state_dict()))
        img, dep = torch.from_numpy(b["image"]), torch.from_numpy(b["depth"])
        lg = float(train_depth.train_step(card_model, card_opt, img.to(dev),
                                          dep.to(dev))[0])
        lc = float(train_depth.train_step(cpu_model, cpu_opt, img, dep)[0])
        got = card_model.state_dict()
        means = {k: (got[k].cpu() - v).abs().mean().item()
                 for k, v in cpu_model.state_dict().items()}
        worst = max((k for k in means if k != DEPTH_ZERO_GRAD),
                    key=means.get)
        forced.append(dict(
            loss_card=lg, loss_cpu=lc, loss_rel=abs(lg - lc) / abs(lc),
            param_mean_abs_max=means[worst], worst_leaf=worst,
            zero_grad_leaf_abs=means[DEPTH_ZERO_GRAD]))
    free_cpu = [f["loss_cpu"] for f in forced]
    depth_rel = max(f["loss_rel"] for f in forced)
    log("depth_train", config=dataclasses.asdict(dcfg), epochs=DEPTH_EPOCHS,
        seconds=depth_s, history=hist["total"], ms_per_step=depth_ms,
        timed_steps=DEPTH_TIMED, free_losses_card=free_card,
        free_losses_cpu=free_cpu, free_loss_rel_max=max(
            abs(a - b) / abs(b) for a, b in zip(free_card, free_cpu)),
        from_cpu_state=forced, loss_rtol=DEPTH_RTOL,
        param_mean_tol=DEPTH_PARAM_MEAN_TOL,
        phase_seconds=lap("depth_train"))
    if not (len(hist["total"]) == DEPTH_EPOCHS
            and np.all(np.isfinite(hist["total"]))
            and depth_rel <= DEPTH_RTOL
            and all(f["param_mean_abs_max"] <= DEPTH_PARAM_MEAN_TOL
                    and f["zero_grad_leaf_abs"] <= 2 * dcfg.lr
                    for f in forced)):
        fail("depth training failed its checks")
    del model, card_model, cpu_model, imgs, deps

    # 79. render_stats at the large-cloud render configuration.
    cloud = render_cloud(79).to(dev)
    cam = Camera.default_training(RENDER["res"])
    stats = {}
    for b in ("search", "stream"):
        cfg = tile.TileRendererConfig(max_per_tile=RENDER["max_per_tile"],
                                      binning=b)
        profiling.render_with_stats(*fields(cloud), cam, config=cfg)
        torch.cuda.synchronize()
        reset_counts(*counters)
        img, st = profiling.render_with_stats(*fields(cloud), cam,
                                              config=cfg)
        path_launches[f"render_stats_{b}"] = launches = read_counts(
            *counters)
        _, ovf = tile.render_tiled(*fields(cloud), cam, config=cfg,
                                   return_overflow=True)
        stats[b] = dict(
            dataclasses.asdict(st), launches=launches,
            overflow_equal=ovf.tolist() == [
                st.dropped_pairs, st.total_pairs, st.overflow_tiles,
                st.max_tile_hits],
            finite=bool(torch.isfinite(img).all()))
    trace_dir = os.path.join(root, "trace")
    with profiling.trace(trace_dir):
        profiling.render_with_stats(*fields(cloud), cam,
                                    config=tile.TileRendererConfig(
                                        max_per_tile=RENDER["max_per_tile"]))
    traces = list(Path(trace_dir).glob("*.json"))
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    device_events = sum(1 for e in events if e.get("cat") == "kernel")
    log("render_stats", config=RENDER, stats=stats, trace_files=len(traces),
        trace_kernel_events=device_events,
        phase_seconds=lap("render_stats"))
    if not (all(s["overflow_equal"] and s["finite"]
                and s["num_gaussians"] == RENDER["n"]
                and s["launches"]["k1"] == 1 for s in stats.values())
            and stats["search"]["launches"]["k3"] > 0
            and stats["stream"]["launches"]["k4"] > 0
            and len(traces) == 1 and device_events > 0):
        fail(f"render_with_stats failed its checks: {stats}")
    del cloud
    shutil.rmtree(root, ignore_errors=True)

    # 80. item10_phases
    total = sum(phase_s.values())
    log("item10_phases", seconds=phase_s, total_seconds=total,
        cap_seconds=ITEM10_PHASES_CAP_S)
    if total > ITEM10_PHASES_CAP_S:
        fail(f"phases 75-79 took {total:.1f} s, over their "
             f"{ITEM10_PHASES_CAP_S} s cap")


# Phases 81-84: ROADMAP Queue 1, item 9 (Fresnel v2 distillation).
V2_PHASES_CAP_S = 90.0
# V2Config's defaults: DirectSLatDecoder 1 024 -> 512, 6 blocks of 8 heads,
# 8 Gaussians per voxel; max_coords 4 096, max_gaussians 16 384, batch 2,
# max_match_points 4 096; the render loss at 128^2, M 256.  The samples:
# SyntheticTrellisDataset with 16 384 Gaussians each (so every sample fills
# max_coords and max_gaussians), written in the TRELLIS layout and read
# back by TrellisDistillationDataset.
V2_FULL = dict(feature_dim=1024, hidden_dim=512, num_layers=6, num_heads=8,
               num_gaussians_per_voxel=8, max_coords=4096,
               max_gaussians=16384, batch_size=2, max_match_points=4096)
V2_SAMPLES, V2_PATCHES = 2, 1369
V2_ROUTES = (("float32", {}), ("float32_render", dict(use_render_loss=True)),
             ("bf16", dict(use_amp=True)),
             ("bf16_render", dict(use_amp=True, use_render_loss=True)),
             ("float32_render_ckpt", dict(use_render_loss=True,
                                          use_checkpoint=True)),
             ("bf16_render_ckpt", dict(use_amp=True, use_render_loss=True,
                                       use_checkpoint=True)))
V2_WARMUP, V2_TIMED, V2_PROFILED = 1, 3, 2
# Card against CPU at full width (phase 81): float32 with TF32 off within
# 1e-4 abs of the CPU's outputs (positions in [-1, 1], logits), bf16
# within AMP_GAP x the CPU's own bf16-against-float32 difference.  The
# structure predictor at resolution 64, hidden 256, one image.
V2_REF_TOL = 1e-4
V2_REF_VOXELS = 2048          # the CPU's bf16 reference: one cloud of these
# Phase 84: two steps with the render loss, card against CPU, dropout 0.
V2_SMALL = dict(feature_dim=64, hidden_dim=64, num_layers=2, num_heads=4,
                num_gaussians_per_voxel=4, max_coords=256, max_gaussians=1024,
                batch_size=2, max_match_points=512, use_render_loss=True)
V2_SMALL_DATA = dict(max_coords=256, max_gaussians=1024, n_gaussians=1024,
                     feature_dim=64, num_patches=49)
V2_REF_STEPS = 2


def v2_phases(torch, dev, path_launches, tmp):
    """Phases 81-84: the v2 decoders and the structure predictor against
    the CPU, V2Trainer at full width on TRELLIS-layout files (four routes,
    and the render routes under use_checkpoint), its CLI, and two
    render-loss steps card against CPU.  Returns K1 / K2 at the v2 render
    packs."""
    from fresnel_tpu_torch.data.trellis import (
        SyntheticTrellisDataset, TrellisDistillationDataset)
    from fresnel_tpu_torch.models import slat
    from fresnel_tpu_torch.render import (
        binning, raster, splat, stream_binning, tile)
    from fresnel_tpu_torch.train import train_direct_decoder as v2
    from fresnel_tpu_torch.weights import init_flax_like_

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    root = os.path.join(tmp, "v2")

    def read():
        return read_all_counts(raster, binning, stream_binning, splat)

    def per_step(launches, n):
        return {k: v / n for k, v in launches.items() if v}

    def init(module, seed=0):
        init_flax_like_(module, torch.Generator().manual_seed(seed))
        return module.eval()

    def twin(module, kw, device, dtype=None):
        """`module` (built with `kw`) as a new module on `device`, the same
        weights (the transformer's stack computing in `dtype`, if given)."""
        m = type(module)(**kw, **({} if dtype is None else dict(dtype=dtype)))
        m.load_state_dict(module.state_dict())
        return m.to(device).eval()

    # 81. slat_reference: the models at full width, card against CPU.
    rng = np.random.default_rng(81)
    full = V2_FULL
    feats = rng.normal(size=(2, V2_PATCHES, full["feature_dim"])).astype(
        np.float32)
    coords = np.concatenate([np.zeros((2, full["max_coords"], 1)),
                             rng.integers(0, 64, (2, full["max_coords"], 3))],
                            -1).astype(np.int32)
    cmask = np.ones((2, full["max_coords"]), bool)
    cmask[1, 3000:] = False
    dkw = dict(feature_dim=full["feature_dim"], hidden_dim=full["hidden_dim"],
               num_layers=full["num_layers"], num_heads=full["num_heads"],
               num_gaussians_per_voxel=full["num_gaussians_per_voxel"])
    mkw = dict(feature_dim=full["feature_dim"], hidden_dim=full["hidden_dim"],
               num_gaussians_per_voxel=full["num_gaussians_per_voxel"])
    spkw = dict(feature_dim=full["feature_dim"])
    dec = init(slat.DirectSLatDecoder(**dkw))
    mlp = init(slat.MLPSLatDecoder(**mkw))
    sp = init(slat.DirectStructurePredictor(**spkw))

    def run_model(m, device, args, kw=None):
        with torch.no_grad():
            out = m(*[torch.from_numpy(a).to(device) for a in args],
                    **{k: torch.from_numpy(v).to(device)
                       for k, v in (kw or {}).items()})
        if not isinstance(out, dict):
            out = dict(zip(("occupancy", "logits"), out))
        return {k: v.float().cpu() for k, v in out.items()}

    ref = {}
    t0 = time.perf_counter()
    # Card against CPU on the second cloud (4 096 voxels, the last 1 096
    # masked); the card's forward is timed at batch 2.
    dargs, dkw_in = (feats, coords), dict(coord_mask=cmask)
    one, one_kw = (feats[1:], coords[1:]), dict(coord_mask=cmask[1:])
    card = run_model(twin(dec, dkw, dev), dev, one, one_kw)
    want = run_model(dec, cpu, one, one_kw)
    ref["direct_float32"] = {k: (card[k] - want[k]).abs().max().item()
                             for k in want}
    ms_fwd = {}
    for name, dt in (("float32", None), ("bf16", torch.bfloat16)):
        m = twin(dec, dkw, dev, dt)
        a = [torch.from_numpy(x).to(dev) for x in dargs]
        mk = torch.from_numpy(cmask).to(dev)
        with torch.no_grad():
            ms_fwd[name] = cuda_median_ms(
                torch, lambda: m(*a, coord_mask=mk), n=5, warmup=1)
    # bf16: one cloud of V2_REF_VOXELS (the CPU's bf16 matmuls are slow).
    n = V2_REF_VOXELS
    bargs, bkw = (feats[:1], coords[:1, :n]), dict(coord_mask=cmask[:1, :n])
    b_card = run_model(twin(dec, dkw, dev, torch.bfloat16), dev, bargs, bkw)
    b_cpu = run_model(twin(dec, dkw, cpu, torch.bfloat16), cpu, bargs, bkw)
    f_cpu = run_model(dec, cpu, bargs, bkw)
    # Each output within AMP_GAP x the larger of the CPU's own bf16 gap
    # and one bf16 ulp of its largest float32 value.
    ratios = {}
    for k, v in b_cpu.items():
        gap = max((v - f_cpu[k]).abs().max().item(),
                  2.0 ** -7 * f_cpu[k].abs().max().item())
        ratios[k] = (b_card[k] - v).abs().max().item() / (AMP_GAP * gap)
    bf16_ok = max(ratios.values()) <= 1.0
    ref["direct_bf16"] = dict(ratio_to_bound=ratios, voxels=n,
                              gap_factor=AMP_GAP)
    card = run_model(twin(mlp, mkw, dev), dev, one)
    want = run_model(mlp, cpu, one)
    ref["mlp_float32"] = {k: (card[k] - want[k]).abs().max().item()
                          for k in want}
    t_sp = time.perf_counter()
    card = run_model(twin(sp, spkw, dev), dev, (feats[:1],))
    want = run_model(sp, cpu, (feats[:1],))
    sp_cpu_s = time.perf_counter() - t_sp
    ref["structure_float32"] = {k: (card[k] - want[k]).abs().max().item()
                                for k in want}
    spm = twin(sp, spkw, dev)
    x1 = torch.from_numpy(feats[:1]).to(dev)
    with torch.no_grad():
        sp_ms = cuda_median_ms(torch, lambda: spm(x1), n=5, warmup=1)
    # occupancy_to_coords on the same grid on both devices, as it is and
    # with a tenth of it saturated at exactly 1.0 (ties).
    occ = want["occupancy"][0]
    sat = occ.clone()
    sat.view(-1)[::10] = 1.0
    otc = {}
    for name, grid in (("as_is", occ), ("saturated", sat)):
        c_card, v_card = slat.occupancy_to_coords(grid.to(dev),
                                                  full["max_coords"])
        c_cpu, v_cpu = slat.occupancy_to_coords(grid, full["max_coords"])
        otc[name] = bool(torch.equal(c_card.cpu(), c_cpu)
                         and torch.equal(v_card.cpu(), v_cpu))
    f32_errs = [v for k in ("direct_float32", "mlp_float32",
                            "structure_float32") for v in ref[k].values()]
    log("slat_reference", config=dkw, batch=1, voxels=full["max_coords"],
        patches=V2_PATCHES, errors=ref, tol=V2_REF_TOL,
        occupancy_to_coords_equal=otc,
        allow_tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                        cudnn=torch.backends.cudnn.allow_tf32),
        direct_fwd_ms=ms_fwd, structure=dict(resolution=64, hidden=256,
                                             fwd_ms=sp_ms,
                                             cpu_seconds=sp_cpu_s),
        reference_seconds=time.perf_counter() - t0,
        phase_seconds=lap("slat_reference"))
    if not (max(f32_errs) <= V2_REF_TOL and bf16_ok and all(otc.values())):
        fail(f"slat_reference: the card disagrees with the CPU: {ref} {otc}")
    del dec, mlp, sp, spm

    # 82. v2_train: V2Trainer at full width on TRELLIS-layout files.
    data_dir = os.path.join(root, "trellis")
    t0 = time.perf_counter()
    SyntheticTrellisDataset(
        n_samples=V2_SAMPLES, max_coords=full["max_coords"],
        max_gaussians=full["max_gaussians"],
        n_gaussians=full["max_gaussians"], feature_dim=full["feature_dim"],
        num_patches=V2_PATCHES, seed=0).write(data_dir)
    ds = TrellisDistillationDataset(data_dir,
                                    max_coords=full["max_coords"],
                                    max_gaussians=full["max_gaussians"])
    data_s = time.perf_counter() - t0
    host_batch = next(iter(ds.batches(full["batch_size"],
                                      np.random.default_rng(0))))
    fill = dict(coords=int(host_batch["coord_mask"].sum()),
                gaussians=int(host_batch["gaussian_mask"].sum()))
    routes, packs = {}, {}
    for name, over in V2_ROUTES:
        trainer = v2.V2Trainer(v2.V2Config(output_dir=os.path.join(
            root, name), **full, **over), device=dev)
        state = trainer.init_state()
        batch = trainer.device_batch(host_batch)
        gen = torch.Generator(device=dev).manual_seed(1)
        for _ in range(V2_WARMUP):
            state, _ = trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*counters)
        events, losses = [], []
        t1 = time.perf_counter()
        for _ in range(V2_TIMED):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            state, ld = trainer.train_step(state, batch, gen)
            end.record()
            events.append((start, end))
            losses.append(ld)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t1) / V2_TIMED * 1e3
        launches = read()
        peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
        path_launches[f"v2_train_{name}"] = launches

        def steps():
            nonlocal state
            for _ in range(V2_PROFILED):
                state, _ = trainer.train_step(state, batch, gen)

        # The checkpointed routes are there for their memory and step
        # time; the profile of the others reads the device.
        ckpt = over.get("use_checkpoint", False)
        prof = (dict(device_ms=None, device_busy_share=None, kernels=None,
                     top_kernels_ms=None) if ckpt else
                profile_ms(torch, steps, V2_PROFILED, top=6, cpu=False))
        totals = [float(ld["total"]) for ld in losses]
        ms = [s_.elapsed_time(e_) for s_, e_ in events]
        render = over.get("use_render_loss", False)
        routes[name] = dict(
            ms_per_step=ms, ms_per_step_median=statistics.median(ms),
            host_ms_per_step=host_ms,
            device_ms_per_step=prof["device_ms"],
            device_busy_share=prof["device_busy_share"],
            kernels_per_step=prof["kernels"],
            top_kernels_ms_per_step=prof["top_kernels_ms"],
            peak_mem_gb_above_resident=peak,
            launches_per_step=per_step(launches, V2_TIMED), losses=totals,
            render_terms=[float(losses[-1].get(k, float("nan")))
                          for k in ("render_rgb", "render_ssim")])
        want_l = dict(k1=2.0, k2=1.0) if render else {}
        if not (per_step(launches, V2_TIMED) == want_l
                and np.all(np.isfinite(totals))):
            fail(f"v2_train {name}: {routes[name]}")
        if name == "float32_render":
            # The step's two render packs at this state.
            with torch.no_grad():
                out = trainer.model(batch["features"], batch["coords"],
                                    coord_mask=batch["coord_mask"])
                pm = torch.repeat_interleave(
                    batch["coord_mask"], full["num_gaussians_per_voxel"], 1)
                for key, g, m in (("pred", out["gaussians"], pm),
                                  ("teacher", batch["gaussians"],
                                   batch["gaussian_mask"])):
                    op = torch.where(m, g[..., 13], torch.zeros_like(
                        g[..., 13]))
                    packs[key] = tile.pack_tiles_batched(
                        g[..., 0:3], g[..., 3:6], g[..., 6:10],
                        g[..., 10:13], op, trainer.camera,
                        trainer.render_config)
        del trainer, state, batch
        torch.cuda.empty_cache()
    log("v2_train", config=full, samples=V2_SAMPLES, fill=fill,
        data_seconds=data_s, warmup_steps=V2_WARMUP, steps=V2_TIMED,
        profiled_steps=V2_PROFILED, routes=routes,
        phase_seconds=lap("v2_train"))

    # K1 / K2 at the v2 render packs (the prediction's with K2).
    k12 = {}
    for key in ("pred", "teacher"):
        bp = packs[key]
        k12[key] = pack_kernels(torch, raster, bp.pack, bp.counts,
                                bp.n_tiles_x, bp.tiles_per_image,
                                backward=key == "pred")
    lap("v2_kernels")

    # 83. v2_cli: --synthetic, then --data_dir with the checkpoint and the
    # render loss; then one more step from a written .pt.
    cli = {}
    for name, argv in (
            ("synthetic", ["--synthetic", "--epochs", "2"]),
            ("data_dir", ["--data_dir", data_dir, "--epochs", "1",
                          "--use_checkpoint", "--use_render_loss"])):
        out_dir = os.path.join(root, f"cli_{name}")
        torch.cuda.synchronize()
        reset_counts(*counters)
        t1 = time.perf_counter()
        (trainer, state), printed = quiet(
            v2.main, argv + ["--output_dir", out_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        launches = read()
        path_launches[f"v2_cli_{name}"] = launches
        files = sorted(os.listdir(out_dir))
        with open(os.path.join(out_dir, "final_v2.pt.json")) as f:
            meta = json.load(f)
        with open(os.path.join(out_dir, "loss_history.json")) as f:
            hist = json.load(f)
        steps_run = int(state["step"])
        cli[name] = dict(seconds=seconds, files=files, steps=steps_run,
                         launches=launches, epoch=meta["epoch"],
                         history_total=hist["total"],
                         said=printed.strip().splitlines()[-1])
        render = "--use_render_loss" in argv
        ok = ({"best_v2.pt", "best_v2.pt.json", "final_v2.pt",
               "final_v2.pt.json", "loss_history.json"} <= set(files)
              and np.all(np.isfinite(hist["total"]))
              and meta["config"]["use_render_loss"] == render
              and launches == dict(k1=2 * steps_run if render else 0,
                                   k2=steps_run if render else 0, k3=0,
                                   k4=0, k1phi=0, k2phi=0, k5=0, k6=0))
        if name == "data_dir":
            state2, epoch = trainer.load_checkpoint(
                os.path.join(out_dir, "final_v2.pt"))
            batch = trainer.device_batch(host_batch)
            state2, ld = trainer.train_step(state2, batch)
            cli[name]["resumed"] = dict(epoch=epoch,
                                        step=int(state2["step"]),
                                        total=float(ld["total"]))
            ok = ok and epoch == 0 and int(state2["step"]) == steps_run + 1 \
                and math.isfinite(float(ld["total"]))
        if not ok:
            fail(f"v2_cli {name}: {cli[name]}")
        del trainer, state
        torch.cuda.empty_cache()
    log("v2_cli", runs=cli, phase_seconds=lap("v2_cli"))

    # 84. v2_reference: two render-loss steps at a small config, card
    # against CPU, from one init (dropout 0).
    small = SyntheticTrellisDataset(n_samples=2 * V2_REF_STEPS, seed=84,
                                    **V2_SMALL_DATA)
    sb = list(small.batches(2, np.random.default_rng(0)))
    runs = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        trainer = v2.V2Trainer(v2.V2Config(output_dir=os.path.join(
            root, f"ref_{name}"), **V2_SMALL), device=d)
        trainer.model.dropout = 0.0
        state = trainer.init_state()
        reset_counts(*counters)
        losses = []
        for b in sb:
            state, ld = trainer.train_step(state, trainer.device_batch(b))
            losses.append({k: float(v) for k, v in ld.items()})
        runs[name] = dict(losses=losses, launches=read(),
                          params={k: v.cpu() for k, v in
                                  state["params"].items()})
    rel = {k: max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(
        runs["card"]["losses"], runs["cpu"]["losses"]))
        for k in runs["cpu"]["losses"][0]}
    pmean = max((runs["card"]["params"][k] - v).abs().mean().item()
                for k, v in runs["cpu"]["params"].items())
    card_l = runs["card"]["launches"]
    log("v2_reference", config=V2_SMALL, steps=V2_REF_STEPS,
        losses_card=[r["total"] for r in runs["card"]["losses"]],
        losses_cpu=[r["total"] for r in runs["cpu"]["losses"]],
        rel_err=rel, rtol=REF_LOSS_RTOL, param_mean_abs_max=pmean,
        param_mean_tol=REF_PARAM_MEAN_TOL, launches_card=card_l,
        kernels_at_v2_packs=k12, phase_seconds=lap("v2_reference"))
    if not (max(rel.values()) <= REF_LOSS_RTOL
            and pmean <= REF_PARAM_MEAN_TOL
            and card_l["k1"] == 2 * V2_REF_STEPS
            and card_l["k2"] == V2_REF_STEPS
            and k12["pred"]["k1_max_abs_err"] <= KERNEL_TOL
            and k12["teacher"]["k1_max_abs_err"] <= KERNEL_TOL
            and k12["pred"]["k2_rel_err"] <= KERNEL_BWD_TOL):
        fail(f"v2_reference: the card disagrees with the CPU or K1 / K2 "
             f"with their plain versions: {rel} {pmean} {card_l}")
    shutil.rmtree(root, ignore_errors=True)
    total = sum(phase_s.values())
    log("v2_phases", seconds=phase_s, total_seconds=total,
        cap_seconds=V2_PHASES_CAP_S)
    if total > V2_PHASES_CAP_S:
        fail(f"phases 81-84 took {total:.1f} s, over their "
             f"{V2_PHASES_CAP_S} s cap")
    return k12


# `fresnel-torch smoke`, the binary-protocol bridges and decoder export
# (phases 85-88).  The bridges as the C++ viewer runs them (a process per
# command) on the card, against the same commands on the CPU in this
# process at the CPU tests' tolerances (tests/test_torch_bridges.py):
# features 3e-5, depth 1e-6, Gaussians 1e-5 of each field's largest value
# (quaternions up to sign), the views' mean and coverage 1e-4.  The
# seed-0 decoder (no checkpoint) has no JAX tolerance; its quaternions
# come out of a badly conditioned 6D -> quaternion step at that random
# init (the CPU's own float32 sits 1.3e-5 from float64 there), so they
# are held within 2 x the CPU's float32-vs-float64 gap on the same inputs,
# its other fields at 1e-5.  The processes get NVIDIA_TF32_OVERRIDE=0:
# the encoder-trained checkpoint's convolutions would otherwise run in
# TF32 (cuDNN's default), as this script turns off for itself.
BRIDGE_VIEWS, BRIDGE_SIZE = 8, 256
BRIDGE_FEAT_TOL, BRIDGE_DEPTH_TOL = 3e-5, 1e-6
BRIDGE_FIELD_RTOL, BRIDGE_VIEW_TOL = 1e-5, 1e-4
BRIDGE_FIELDS = {"positions": (0, 3), "scales": (3, 6), "rotations": (6, 10),
                 "colors": (10, 13), "opacities": (13, 14)}
# Each exported file, traced on the card, loaded on the CPU against the
# CPU's eager decoder: 1e-5 of each field's largest value.
EXPORT_CPU_RTOL = 1e-5
ITEM11_PHASES_CAP_S = 45.0


def bridge_fields_err(got, want):
    """Each Gaussian field's largest error between two (N, 14) arrays,
    relative to the field's largest value, quaternions up to sign."""
    got = got.copy()
    got[:, 6:10] *= np.where(np.sum(got[:, 6:10] * want[:, 6:10], -1) < 0,
                             -1, 1)[:, None]
    return {k: float(np.abs(got[:, a:b] - want[:, a:b]).max()
                     / max(np.abs(want[:, a:b]).max(), 1e-12))
            for k, (a, b) in BRIDGE_FIELDS.items()}


def seed0_rotation_gap(torch, feats, depth):
    """The bridge's seed-0 DirectPatchDecoder on the CPU: its rotations in
    float32 against float64 on the same inputs, relative to their largest
    value, up to sign."""
    from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
    from fresnel_tpu_torch.weights import init_flax_like_

    m = DirectPatchDecoder(feature_dim=feats.shape[-1], gaussians_per_patch=4)
    init_flax_like_(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        q32 = m(feats, depth)["rotations"].double()
        q64 = m.double()(feats.double(), depth.double())["rotations"]
    q32 = q32 * torch.sign((q32 * q64).sum(-1, keepdim=True))
    return float((q32 - q64).abs().max() / q64.abs().max())


def bridge_views(text):
    """[(azimuth, mean, coverage)], verdict of test_novel_views' lines (a
    thin checkpoint's load prints its own line first, as in JAX)."""
    lines = text.strip().splitlines()
    rows = [re.fullmatch(r"az=(\d+) mean=([\d.]+) coverage=([\d.]+)", ln)
            for ln in lines if ln.startswith("az=")]
    if len(rows) != BRIDGE_VIEWS or not all(rows) \
            or lines[-1] not in ("PASS", "DARK"):
        fail(f"test_novel_views printed {lines}")
    return [(int(r[1]), float(r[2]), float(r[3])) for r in rows], lines[-1]


def item11_phases(torch, dev, path_launches, tmp):
    """Phases 85-88: `fresnel-torch smoke`, the four bridge commands on the
    card against the CPU, and the seven committed decoders exported on the
    card and run on the CPU.  The bridge processes start first and run
    while this process runs smoke, the CPU's commands and the export."""
    import concurrent.futures

    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.export import export_decoder
    from fresnel_tpu_torch.inference import bridges
    from fresnel_tpu_torch.render import binning, raster, stream_binning

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()

    def quiet_call(fn, *a, **k):
        t0 = time.perf_counter()
        rc, out = quiet(fn, *a, **k)
        return rc, out, time.perf_counter() - t0

    # The bridges' inputs: the image, and the CPU's features and depth,
    # which the decoder reads on both devices.
    img = infer_image(tmp)
    d = os.path.join(tmp, "bridges")
    card_dir, cpu_dir = os.path.join(d, "card"), os.path.join(d, "cpu")
    for p in (card_dir, cpu_dir):
        os.makedirs(p, exist_ok=True)
    f_cpu, d_cpu = os.path.join(cpu_dir, "f.bin"), os.path.join(cpu_dir,
                                                                "d.bin")
    nv = [str(BRIDGE_VIEWS), str(BRIDGE_SIZE)]
    jobs = {
        "dinov2": [img, "{}/f.bin"],
        "depth": [img, "{}/d.bin"],
        "decoder": [f_cpu, d_cpu, "{}/g.bin", ckpt_path("exp2")],
        "decoder_random": [f_cpu, d_cpu, "{}/g0.bin"],
        "test_novel_views": [img, "{}/views", ckpt_path("exp2_k8"), *nv],
    }
    cpu_runs = {}

    def on_cpu(name):
        fn = getattr(bridges, "cmd_" + name.replace("_random", ""))
        argv = [a.format(cpu_dir) for a in jobs[name]]
        rc, out, secs = quiet_call(fn, argv, device=cpu)
        cpu_runs[name] = dict(rc=rc, out=out, seconds=secs)

    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")

    def on_card(name):
        argv = [sys.executable, "-m", "fresnel_tpu_torch.inference.bridges",
                name.replace("_random", ""),
                *[a.format(card_dir) for a in jobs[name]]]
        t0 = time.perf_counter()
        p = subprocess.run(argv, cwd=HERE, env=env, capture_output=True,
                           text=True, timeout=300)
        return dict(rc=p.returncode, out=p.stdout, err=p.stderr[-2000:],
                    seconds=time.perf_counter() - t0)

    on_cpu("dinov2")
    on_cpu("depth")
    t_card = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(len(jobs))
    futures = {n: pool.submit(on_card, n) for n in jobs}
    lap("bridges")

    # 85. smoke: the subcommand on the card (the kernels are built by now,
    # so `_build.build()` loads them), while the bridge processes start.
    torch.cuda.synchronize()
    reset_counts(*counters)
    rc, out, secs = quiet_call(cli.main, ["smoke"])
    path_launches["smoke"] = read_counts(*counters)
    log("smoke", rc=rc, lines=out.splitlines(), seconds=secs,
        launches=path_launches["smoke"], beside_bridge_processes=len(jobs),
        phase_seconds=lap("smoke"))
    if rc != 0 or path_launches["smoke"] != dict(k1=1, k2=0, k3=0, k4=0) \
            or out.count(": OK") < 2 or " OK; " not in out:
        fail(f"smoke exited {rc} or launched {path_launches['smoke']}")

    # 86. bridges: the CPU's commands while the card's processes run.
    for name in ("decoder", "decoder_random", "test_novel_views"):
        on_cpu(name)
    lap("bridges")

    # 87. export, while the bridge processes run on: each committed decoder
    # traced and verified on the card (`export_decoder.main`), the file
    # loaded on the CPU and run against the CPU's eager decoder on a third
    # draw.
    out_dir = os.path.join(tmp, "export")
    os.makedirs(out_dir, exist_ok=True)
    exports = {}
    for name in CKPTS:
        npz = os.path.join(out_dir, f"{name}.npz")
        onnx = os.path.join(out_dir, f"{name}.onnx")
        rc, out, secs = quiet_call(export_decoder.main, [
            ckpt_path(name), "--npz", npz, "--onnx", onnx])
        t0 = time.perf_counter()
        meta = json.loads(open(ckpt_path(name) + ".json").read())
        trainer, _, dec_cpu = export_decoder.load_decoder(ckpt_path(name),
                                                          device=cpu)
        exp = int(meta["config"].get("experiment", 2))
        x = export_decoder._dummy_inputs(meta["config"],
                                         trainer.config.feature_dim, seed=3)
        written = onnx + ".pt"
        if not os.path.exists(written):     # an ONNX file: the trace again
            _, _, dec = export_decoder.load_decoder(ckpt_path(name), dev)
            export_decoder.trace(export_decoder.ExportWrapper(dec, exp),
                                 [t.to(dev) for t in x]).save(written)
        loaded = torch.jit.load(written, map_location="cpu")
        with torch.no_grad():
            err = export_decoder.field_errors(
                loaded(*x), export_decoder.ExportWrapper(dec_cpu, exp)(*x))
        with np.load(npz) as z:
            arrays = len(z.files)
        exports[name] = dict(rc=rc, seconds=secs, lines=out.splitlines(),
                             onnx_written=os.path.exists(onnx),
                             bytes=os.path.getsize(written), arrays=arrays,
                             cpu_err=err,
                             cpu_check_seconds=time.perf_counter() - t0)
    log("export", checkpoints=exports, cpu_rtol=EXPORT_CPU_RTOL,
        phase_seconds=lap("export"))
    if not all(e["rc"] == 0 and any(ln.startswith("ONNX export verified")
                                    for ln in e["lines"])
               and e["cpu_err"] <= EXPORT_CPU_RTOL
               for e in exports.values()):
        fail(f"an export was not verified or its file disagrees on the "
             f"CPU: {exports}")

    # 86. bridges, continued: the card's processes joined, then
    # test_novel_views once more in this process on the card for its K1
    # launches.
    card_runs = {n: f.result() for n, f in futures.items()}
    card_wall = time.perf_counter() - t_card
    pool.shutdown()
    torch.cuda.synchronize()
    reset_counts(*counters)
    rc_ip, out_ip, secs_ip = quiet_call(
        bridges.main, ["test_novel_views", img, os.path.join(d, "in_process"),
                       ckpt_path("exp2_k8"), *nv])
    torch.cuda.synchronize()
    path_launches["bridges"] = read_counts(*counters)

    bad = {n: r for n, r in card_runs.items()
           if r["rc"] != cpu_runs[n]["rc"]
           or r["rc"] != 0 and n != "test_novel_views"}
    if bad:
        fail(f"bridge commands failed on the card: {bad}")
    errs, n_out = {}, {}
    for name, fn in (("dinov2", "f.bin"), ("depth", "d.bin")):
        a, b = (np.fromfile(os.path.join(p, fn), np.float32)
                for p in (card_dir, cpu_dir))
        errs[name] = float(np.abs(a - b).max())
    for name, fn in (("decoder", "g.bin"), ("decoder_random", "g0.bin")):
        n = n_out[name] = int(card_runs[name]["out"])
        a, b = (np.fromfile(os.path.join(p, fn), np.float32).reshape(n, 14)
                for p in (card_dir, cpu_dir))
        errs[name] = bridge_fields_err(a, b)
    gap = seed0_rotation_gap(
        torch, torch.from_numpy(np.fromfile(f_cpu, np.float32).reshape(
            1, 37, 37, -1)),
        torch.from_numpy(np.fromfile(d_cpu, np.float32).reshape(1, 256, 256)))
    rot_tol = max(BRIDGE_FIELD_RTOL, 2 * gap)
    rows_card, verdict_card = bridge_views(
        card_runs["test_novel_views"]["out"])
    rows_cpu, verdict_cpu = bridge_views(cpu_runs["test_novel_views"]["out"])
    rows_ip, verdict_ip = bridge_views(out_ip)
    errs["test_novel_views"] = max(max(abs(a[1] - b[1]), abs(a[2] - b[2]))
                                   for a, b in zip(rows_card, rows_cpu))
    errs["test_novel_views_in_process"] = max(
        max(abs(a[1] - b[1]), abs(a[2] - b[2]))
        for a, b in zip(rows_ip, rows_cpu))
    pngs = [sorted(os.listdir(os.path.join(p, "views")))
            for p in (card_dir, cpu_dir)]
    log("bridges", image=img, views=BRIDGE_VIEWS, size=BRIDGE_SIZE,
        card_seconds={n: r["seconds"] for n, r in card_runs.items()},
        card_wall_seconds=card_wall, card_processes_at_once=len(jobs),
        cpu_seconds={n: r["seconds"] for n, r in cpu_runs.items()},
        card_in_process_seconds=secs_ip,
        lines={n: r["out"].strip().splitlines()[-1]
               for n, r in card_runs.items() if r["out"].strip()},
        n=n_out, max_err=errs, seed0_rotation_f32_gap=gap,
        tol=dict(dinov2=BRIDGE_FEAT_TOL, depth=BRIDGE_DEPTH_TOL,
                 decoder=BRIDGE_FIELD_RTOL, seed0_rotations=rot_tol,
                 test_novel_views=BRIDGE_VIEW_TOL),
        views_card=rows_card, views_cpu=rows_cpu, verdict=verdict_card,
        pngs=pngs[0], launches=path_launches["bridges"],
        phase_seconds=lap("bridges"))
    rnd = errs["decoder_random"]
    if not (card_runs["dinov2"]["out"] == cpu_runs["dinov2"]["out"]
            == "37 37 384\n"
            and errs["dinov2"] <= BRIDGE_FEAT_TOL
            and errs["depth"] <= BRIDGE_DEPTH_TOL
            and n_out["decoder"] == int(cpu_runs["decoder"]["out"])
            and n_out["decoder_random"] == 5476
            and max(errs["decoder"].values()) <= BRIDGE_FIELD_RTOL
            and max(v for k, v in rnd.items() if k != "rotations")
            <= BRIDGE_FIELD_RTOL and rnd["rotations"] <= rot_tol
            and errs["test_novel_views"] <= BRIDGE_VIEW_TOL
            and errs["test_novel_views_in_process"] <= BRIDGE_VIEW_TOL
            and verdict_card == verdict_cpu == verdict_ip
            and rc_ip == card_runs["test_novel_views"]["rc"]
            and [r[0] for r in rows_card] == [r[0] for r in rows_cpu]
            and pngs[0] == pngs[1] and len(pngs[0]) == BRIDGE_VIEWS):
        fail(f"the card's bridge outputs disagree with the CPU's: {errs}")
    if path_launches["bridges"] != dict(k1=BRIDGE_VIEWS, k2=0, k3=0, k4=0):
        fail(f"test_novel_views launched {path_launches['bridges']}")

    total = sum(phase_s.values())
    log("item11_phases", seconds=phase_s, total_seconds=total,
        cap_seconds=ITEM11_PHASES_CAP_S)
    if total > ITEM11_PHASES_CAP_S:
        fail(f"phases 85-87 took {total:.1f} s, over their "
             f"{ITEM11_PHASES_CAP_S} s cap")


# item5_phases: tile sizes other than 16 (TileRendererConfig.tile_size)
# through K1 / K2 and K1-phi / K2-phi, and K3 / K4 binning for them, on the
# slice's full-width packs: the image->3DGS path's decoded cloud at 512^2,
# the refine init (256^2, M 1 024), PHASE_AB and the large-cloud render
# (10^6 Gaussians at 512^2, M 256), each at ITEM5_TILE_SIZES.
ITEM5_TILE_SIZES = (8, 32)
ITEM5_PHASES_CAP_S = 45.0
# The card's render of the decoded cloud against the CPU's at the same tile
# size, by mean absolute difference (test_render_on_card_matches_cpu's
# bound: projection rounds differently on the card).
ITEM5_IMAGE_MEAN_TOL = 1e-5


def phase_pack_kernels(torch, raster, pack, counts, ntx, ti, amp, ts):
    """K1-phi and K2-phi against their plain versions on one pack of tile
    size ts, the cotangents from a seed: K1-phi's error relative to each
    output's largest plain value, K2-phi's per field, K2-phi's repeat from
    run to run, times and bounds."""
    kw = dict(tiles_per_image=ti, tile_size=ts)
    T, M = pack.shape[:2]
    with torch.no_grad():
        got = raster._launch_fwd_phase(pack, counts, ntx, amp,
                                       keep_ckpt=True, **kw)
        ref = raster.composite_tiles_plain(pack, counts, ntx,
                                           phase_amplitude=amp, **kw)
    fwd_abs = max((g - r).abs().max().item() for g, r in zip(got[:3], ref))
    fwd_rel = max((g - r).abs().max().item() / max(r.abs().max().item(),
                                                   1e-30)
                  for g, r in zip(got[:3], ref))
    crng = np.random.default_rng(12)
    cots = [torch.from_numpy(crng.normal(size=tuple(o.shape)).astype(
        np.float32)).to(pack.device) for o in ref]
    with torch.no_grad():
        g1 = raster._launch_bwd_phase(pack, counts, ntx, amp, *cots,
                                      ckpt=got[3], **kw)
        g2 = raster._launch_bwd_phase(pack, counts, ntx, amp, *cots,
                                      ckpt=got[3], **kw)
    gref = raster.composite_tiles_phase_bwd_plain(pack, counts, ntx, amp,
                                                  *cots, **kw)
    fields_ = [i for i in range(12) if i != 5]
    babs = max((g1[..., i] - gref[..., i]).abs().max().item()
               for i in fields_)
    brel = max((g1[..., i] - gref[..., i]).abs().max().item()
               / max(gref[..., i].abs().max().item(), 1e-30) for i in fields_)
    with torch.no_grad():
        k1p_t = kernel_times(torch, lambda: raster._launch_fwd_phase(
            pack, counts, ntx, amp, keep_ckpt=True, **kw))
        k2p_t = kernel_times(torch, lambda: raster._launch_bwd_phase(
            pack, counts, ntx, amp, *cots, ckpt=got[3], **kw))
        k1p_plain = cuda_median_ms(torch, lambda: raster.composite_tiles_plain(
            pack, counts, ntx, phase_amplitude=amp, **kw), n=1, warmup=0)
    k2p_plain = cuda_median_ms(
        torch, lambda: raster.composite_tiles_phase_bwd_plain(
            pack, counts, ntx, amp, *cots, **kw), n=1, warmup=0)
    occupied = int(counts.sum().item())
    stats = pack_stats(torch, raster, pack, counts, ntx, tiles_per_image=ti,
                       tile_size=ts)
    pb = compositing_bounds(
        stats, T, M, occupied, names=("k1phi", "k2phi"),
        ops=(OPS_PER_EVAL_PHASE, OPS_PER_EVAL_PHASE_BWD), bwd_pix=5,
        carry_bytes=math.prod(raster.checkpoint_shape(T, M, ts)) * 4,
        pix=ts * ts)
    return dict(T=T, M=M, tile_size=ts, tiles_per_image=ti,
                occupied_slots=occupied, counts_max=stats["counts_max"],
                tiles_at_cap=stats["tiles_at_cap"],
                box_pixel_share=stats["box_pixel_share"],
                k1phi=dict(max_abs_err=fwd_abs, max_rel_err=fwd_rel, **k1p_t,
                           plain_ms=k1p_plain, **pb["k1phi"]),
                k2phi=dict(max_abs_err=babs, max_rel_err=brel,
                           repeat_bitwise_equal=bool(torch.equal(g1, g2)),
                           **k2p_t, plain_ms=k2p_plain, **pb["k2phi"]),
                residency=raster.phase_residency(pack.device, ts))


def item5_phases(torch, dev, path_launches, dec_cloud):
    """Phases 89-93: tile sizes 8 and 32 on the slice's path at full width.
    Returns {kernel: {"at_ts<size>_<pack>_pack": numbers}} for K1, K2,
    K1-phi, K2-phi, K3 and K4, and each kernel's largest error there."""
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.models.decoders import head_transform
    from fresnel_tpu_torch.render import (binning, raster, splat,
                                          stream_binning, tile)
    from fresnel_tpu_torch.train import fit_teacher

    counters = (raster, binning, stream_binning)
    cpu = torch.device("cpu")
    phase_s, lap = lap_timer()
    res = {k: {} for k in ("k1", "k2", "k1phi", "k2phi", "k3", "k4")}
    errs = {k: 0.0 for k in res}

    def keep(kernel, key, numbers, err):
        res[kernel][key] = numbers
        errs[kernel] = max(errs[kernel], err)

    # 89. tile_size_image: the decoded cloud at 512^2 through render_tiled,
    # plain and phase-blended (phases from a seed), each with a gradient.
    cam = Camera.default_training(512)
    n_dec = dec_cloud[0].shape[0]
    phases = torch.from_numpy(np.random.default_rng(89).uniform(
        0, 1, n_dec).astype(np.float32)).to(dev)
    rows = {}
    for ts in ITEM5_TILE_SIZES:
        cfg = tile.TileRendererConfig(tile_size=ts)
        cfg_p = dataclasses.replace(cfg, use_phase_blending=True)
        torch.cuda.synchronize()
        reset_counts(*counters)
        with torch.no_grad():
            img = tile.render_tiled(*dec_cloud, cam, config=cfg)
        leaves = [f.detach().requires_grad_() for f in dec_cloud]
        img_g = tile.render_tiled(*leaves, cam, config=cfg)
        grads = torch.autograd.grad(img_g.square().sum(), leaves)
        img_p = tile.render_tiled(*leaves, cam, phases=phases, config=cfg_p)
        grads_p = torch.autograd.grad(img_p.square().sum(), leaves)
        torch.cuda.synchronize()
        launches = read_all_counts(raster, binning, stream_binning, splat)
        path_launches[f"image_ts{ts}"] = launches
        img_cpu = tile.render_tiled(*[f.cpu() for f in dec_cloud], cam,
                                    config=cfg)
        mean_err = (img.cpu() - img_cpu).abs().mean().item()
        finite = all(bool(torch.isfinite(x).all())
                     for x in (img, img_p, *grads, *grads_p))
        with torch.no_grad():
            tp = tile.pack_tiles(*dec_cloud, cam, cfg)
        kp = pack_kernels(torch, raster, tp.pack, tp.counts, tp.n_tiles_x,
                          None, backward=False, tile_size=ts)
        keep("k1", f"at_ts{ts}_image_pack",
             dict(kp["k1"], T=kp["T"], M=kp["M"]), kp["k1_max_abs_err"])
        rows[ts] = dict(launches=launches, image_mean_abs_err_vs_cpu=mean_err,
                        phase_image_mean=img_p.mean().item(), finite=finite,
                        pack=kp)
        want = dict(k1=2, k2=1, k3=0, k4=0, k1phi=1, k2phi=1, k5=0, k6=0)
        if not (launches == want and finite
                and tuple(img.shape) == (3, 512, 512)
                and mean_err <= ITEM5_IMAGE_MEAN_TOL
                and kp["k1_max_abs_err"] <= KERNEL_TOL):
            fail(f"the decoded cloud at tile size {ts}: {rows[ts]}")
    log("tile_size_image", n_gaussians=n_dec, size=512, by_tile_size=rows,
        tol=dict(image_mean=ITEM5_IMAGE_MEAN_TOL, k1=KERNEL_TOL),
        phase_seconds=lap("tile_size_image"))

    # 90. tile_size_refine: a refine step's forward and backward at full
    # width (render_raw + photometric_loss), card against the CPU's loss;
    # K1 / K2 against their plain versions at the init's pack.
    scene, depth, cam_r, cfg_r, raw0, _ = refine_init(torch, dev)
    rows = {}
    for ts in ITEM5_TILE_SIZES:
        cfg = dataclasses.replace(cfg_r, tile_size=ts)
        losses = {}
        for d in (dev, cpu):
            torch.cuda.synchronize()
            reset_counts(*counters)
            raw = torch.from_numpy(raw0.copy()).to(d).requires_grad_()
            do = torch.tensor(REFINE["depth_offset_init"],
                              device=d).requires_grad_()
            img = fit_teacher.render_raw(
                raw, torch.from_numpy(depth).to(d)[None], do, cam_r.to(d),
                cfg)
            loss = fit_teacher.photometric_loss(
                img, torch.from_numpy(scene).to(d))
            loss.backward()
            losses[d.type] = (loss.item(), bool(torch.isfinite(
                raw.grad).all()))
            if d == dev:
                torch.cuda.synchronize()
                launches = read_counts(*counters)
                path_launches[f"refine_ts{ts}"] = launches
        with torch.no_grad():
            head = head_transform(torch.from_numpy(raw0).to(dev),
                                  torch.from_numpy(depth).to(dev)[None],
                                  torch.tensor(REFINE["depth_offset_init"],
                                               device=dev))
            tp = tile.pack_tiles(*[head[k][0] for k in FIELDS], cam_r.to(dev),
                                 cfg)
        kp = pack_kernels(torch, raster, tp.pack, tp.counts, tp.n_tiles_x,
                          None, backward=True, tile_size=ts)
        keep("k1", f"at_ts{ts}_refine_pack",
             dict(kp["k1"], T=kp["T"], M=kp["M"]), kp["k1_max_abs_err"])
        keep("k2", f"at_ts{ts}_refine_pack",
             dict(kp["k2"], T=kp["T"], M=kp["M"],
                  max_rel_err=kp["k2_rel_err"]), kp["k2_max_abs_err"])
        loss_rel = abs(losses["cuda"][0] - losses["cpu"][0]) / abs(
            losses["cpu"][0])
        rows[ts] = dict(launches=launches, loss_card=losses["cuda"][0],
                        loss_cpu=losses["cpu"][0], loss_rel=loss_rel,
                        pack=kp)
        if not (launches == dict(k1=1, k2=1, k3=0, k4=0)
                and losses["cuda"][1] and losses["cpu"][1]
                and loss_rel <= REFINE_LOSS_RTOL
                and kp["k1_max_abs_err"] <= KERNEL_TOL
                and kp["k2_rel_err"] <= KERNEL_BWD_TOL
                and kp["k2_repeat_bitwise_equal"]):
            fail(f"the refine step at tile size {ts}: {rows[ts]}")
    log("tile_size_refine", config=REFINE, by_tile_size=rows,
        tol=dict(loss_rel=REFINE_LOSS_RTOL, k1=KERNEL_TOL,
                 k2=KERNEL_BWD_TOL), phase_seconds=lap("tile_size_refine"))

    # 91. tile_size_phase: K1-phi / K2-phi on PHASE_AB binned at each size.
    rows = {}
    for ts in ITEM5_TILE_SIZES:
        pack, counts, ntx, ti = phase_synthetic(torch, dev, ts)
        kp = phase_pack_kernels(torch, raster, pack, counts, ntx, ti,
                                PHASE_AB["amplitude"], ts)
        for kk in ("k1phi", "k2phi"):
            keep(kk, f"at_ts{ts}_phase_ab_pack",
                 dict(kp[kk], T=kp["T"], M=kp["M"],
                      residency=kp["residency"][kk]), kp[kk]["max_abs_err"])
        rows[ts] = kp
        if not (kp["k1phi"]["max_rel_err"] <= KERNEL_TOL
                and kp["k2phi"]["max_rel_err"] <= KERNEL_BWD_TOL
                and kp["k2phi"]["repeat_bitwise_equal"]):
            fail(f"K1-phi / K2-phi at tile size {ts}: {kp}")
        del pack, counts
    log("tile_size_phase", pack=PHASE_AB, by_tile_size=rows,
        tol=dict(k1phi=KERNEL_TOL, k2phi=KERNEL_BWD_TOL),
        phase_seconds=lap("tile_size_phase"))

    # 92. tile_size_render: the large-cloud render under the search (K3)
    # and stream (K4) binnings; K3 / K4 tables against their plain
    # versions, K1 / K2 at the render pack.
    cloud = render_cloud(10).to(dev)
    cam = Camera.default_training(RENDER["res"])
    M = RENDER["max_per_tile"]
    n = RENDER["n"]
    rows = {}
    for ts in ITEM5_TILE_SIZES:
        ntx = nty = RENDER["res"] // ts
        groups = tile.search_groups(n, ntx, nty)
        row = {}
        for b in ("search", "stream"):
            cfg = tile.TileRendererConfig(max_per_tile=M, tile_size=ts,
                                          binning=b)
            torch.cuda.synchronize()
            reset_counts(*counters)
            with torch.no_grad():
                img = tile.render_tiled(*fields(cloud), cam, config=cfg)
            torch.cuda.synchronize()
            launches = read_counts(*counters)
            path_launches[f"render_{b}_ts{ts}"] = launches
            want = dict(k1=1, k2=0, k3=groups if b == "search" else 0,
                        k4=int(b == "stream"))
            row[b] = dict(launches=launches, image_mean=img.mean().item())
            if launches != want or not bool(torch.isfinite(img).all()):
                fail(f"the render at tile size {ts}, {b}: {row[b]}")
        cfg = tile.TileRendererConfig(max_per_tile=M, tile_size=ts)
        with torch.no_grad():
            sp = tile.project_sorted(*fields(cloud), cam, cfg)
            xlo, xhi, ylo, yhi, vis, n2 = tile._padded_intervals(
                sp.means2d, sp.radii, sp.visible, ts)
            bnd = (xlo, torch.where(vis, xhi, -1), ylo,
                   torch.where(vis, yhi, -1))
            nty_g = -(-nty // groups)
            k3_equal = True
            for g in range(groups):
                got = binning.build_rank_table(*bnd, ntx, nty_g, n2,
                                               y_offset=g * nty_g)
                ref = binning.build_rank_table_plain(*bnd, ntx, nty_g, n2,
                                                     y_offset=g * nty_g)
                k3_equal &= bool(torch.equal(got[0], ref[0])
                                 and torch.equal(got[1], ref[1]))
                del got, ref
            k3_t = kernel_times(torch, lambda: binning.build_rank_table(
                *bnd, ntx, nty_g, n2) and None, n=20)
            k3_plain = cuda_median_ms(
                torch, lambda: binning.build_rank_table_plain(
                    *bnd, ntx, nty_g, n2) and None, n=3, warmup=1)
            Tg = ntx * nty_g
            k3_bound, k3_by, _ = bound(
                Tg * n2 * 2 + Tg * (n2 // 256) * 4 + 4 * n2 * 4,
                Tg * n2 * OPS_PER_TEST)
            sorted_in = (sp.means2d, sp.radii, sp.visible)
            k4_got = stream_binning.bin_gaussians_stream(*sorted_in, ntx,
                                                         nty, ts, M)
            k4_ref = stream_binning.bin_gaussians_stream_plain(
                *sorted_in, ntx, nty, ts, M)
            k4_equal = tables_equal(torch, k4_got, k4_ref)
            iv = stream_binning.stream_intervals(*sorted_in, ntx, nty, ts)
            k4_t = kernel_times(torch, lambda: stream_binning._launch(
                iv, ntx, nty, M), n=20)
            k4_plain = cuda_median_ms(
                torch, lambda: stream_binning.bin_gaussians_stream_plain(
                    *sorted_in, ntx, nty, ts, M), n=3, warmup=1)
            kept = int(k4_ref[1].sum().item())
            k4_bound, k4_by, _ = bound(
                n * (2 * 4 + 4 + 1) + ntx * nty * M * (4 + 1),
                (n + kept) * OPS_PER_TEST)
            del k4_got, k4_ref, iv
            tp = tile.pack_tiles(*fields(cloud), cam, cfg)
        keep("k3", f"at_ts{ts}_render",
             dict(**k3_t, plain_ms=k3_plain, bound_ms=k3_bound,
                  bound_by=k3_by, groups=groups, T_group=Tg, n2=n2),
             0.0 if k3_equal else float("inf"))
        keep("k4", f"at_ts{ts}_render",
             dict(**k4_t, plain_ms=k4_plain, bound_ms=k4_bound,
                  bound_by=k4_by, T=ntx * nty), 0.0 if k4_equal
             else float("inf"))
        kp = pack_kernels(torch, raster, tp.pack, tp.counts, tp.n_tiles_x,
                          None, backward=True, tile_size=ts)
        keep("k1", f"at_ts{ts}_render_pack",
             dict(kp["k1"], T=kp["T"], M=kp["M"]), kp["k1_max_abs_err"])
        keep("k2", f"at_ts{ts}_render_pack",
             dict(kp["k2"], T=kp["T"], M=kp["M"],
                  max_rel_err=kp["k2_rel_err"]), kp["k2_max_abs_err"])
        rows[ts] = dict(row, groups=groups, k3_bitwise_equal=k3_equal,
                        k4_bitwise_equal=k4_equal, pack=kp,
                        k3=res["k3"][f"at_ts{ts}_render"],
                        k4=res["k4"][f"at_ts{ts}_render"])
        del tp, sp, bnd, sorted_in
        if not (k3_equal and k4_equal and kp["k1_max_abs_err"] <= KERNEL_TOL
                and kp["k2_rel_err"] <= KERNEL_BWD_TOL
                and kp["k2_repeat_bitwise_equal"]):
            fail(f"K3 / K4 / K1 / K2 at the render, tile size {ts}: "
                 f"{rows[ts]}")
    del cloud
    log("tile_size_render", n_gaussians=n, size=RENDER["res"], M=M,
        by_tile_size=rows, phase_seconds=lap("tile_size_render"))

    # 93. item5_phases
    total = sum(phase_s.values())
    log("item5_phases", seconds=phase_s, total_seconds=total,
        cap_seconds=ITEM5_PHASES_CAP_S)
    if total > ITEM5_PHASES_CAP_S:
        fail(f"phases 89-92 took {total:.1f} s, over their "
             f"{ITEM5_PHASES_CAP_S} s cap")
    return res, errs


# Phases 94-97 (parallel/): one start-up of two gloo ranks on card 0
# (NCCL refuses two ranks on one card), the single-process references in
# this process, and NCCL at world size 1.
PARALLEL_PHASES_CAP_S = 90.0
PARALLEL_RANKS = 2
PARALLEL_STEPS = 3           # one step an epoch: 8 scenes at batch 8
PARALLEL_TRAIN = dict(TRAIN, epochs=PARALLEL_STEPS, save_interval=1000)
PARALLEL_SCENES = 8
# World 2 against world 1 (one process, the same seeds): the first step's
# loss (relative) and the global batch's gradient at the init (relative,
# by its global norm).  cuDNN and cuBLAS pick other algorithms for 4
# images than for 8, so the card's world-2 gradient parts from world 1's
# by about 2e-4 where the CPU tests read 7.0e-7; it is held at 1e-3.
# Adam divides by the gradient's scale and turns that rounding on
# near-zero entries into steps of either sign, so from the second step
# the states differ; the later losses are held at 1e-3 relative, beside
# a second world-1 run.
PARALLEL_LOSS_RTOL = 1e-4
PARALLEL_GRAD_RTOL = 1e-3
PARALLEL_LATER_LOSS_RTOL = 1e-3
# NCCL at world size 1 against the single-process fit, bit for bit.  By
# default the card's fit does not repeat itself bit for bit (two plain
# fits: losses 3.1e-7 apart, leaf means 9.6e-8: library backward kernels
# whose sums run in a varying order), so both fits of that phase run
# under torch's deterministic algorithms (`deterministic_algorithms`).
# The sharded renders against render_tiled (tests/test_parallel.py's
# bounds: the batch is per-image work, the slab fold and the bands
# reassociate).
PARALLEL_RENDER_TOL = {"batch": 1e-5, "gaussian": 2e-3, "pixel": 2e-3}
PARALLEL_RENDER_REPEATS = 3
# tests/test_parallel.py's network and bounds (loss relative, gradients
# absolute).
TP_NET = dict(d_in=64, d_hidden=256, d_out=8, batch=8, min_elems=1024)
TP_TOL = 1e-5


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """torch's deterministic algorithms, cuDNN's among them, for a block;
    an op with no deterministic version warns (the warnings are yielded)
    and runs as it is.  New tensors are not filled (the mode's default
    fills torch.empty with NaN, which is not the run being checked).  The
    settings and cuBLAS's workspace variable are restored after."""
    import torch.utils.deterministic as tdet

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            tdet.fill_uninitialized_memory)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    tdet.fill_uninitialized_memory = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]
        tdet.fill_uninitialized_memory = prev[5]
        if prev[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev[4]


def parallel_phases(torch, dev, path_launches, clouds, tmp):
    """Phases 94-97: `parallel/` on the card.  Two gloo ranks on card 0,
    started once (`parallel.launch.run_job`), run the data-parallel
    flagship fit, the three sharded renders and the tensor-parallel step;
    this process runs their single-process references, the fit at world
    size 1 over NCCL and the `--num_devices 2` refusal.  `clouds` are two
    decoded clouds (five fields each, on the card)."""
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.parallel import jobs, launch
    from fresnel_tpu_torch.render import projection, tile
    from fresnel_tpu_torch.render.tile import TileRendererConfig
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli

    phase_s, lap = lap_timer()
    n = PARALLEL_RANKS
    data_dir = os.path.join(tmp, "corpus")
    synthetic_corpus.generate_corpus(data_dir, n_images=PARALLEL_SCENES,
                                     image_size=TRAIN["image_size"], seed=0)
    ds = dict(kind="image", data_dir=data_dir,
              image_size=TRAIN["image_size"],
              feature_dim=TRAIN["feature_dim"], use_augmentation=False)
    ImageDataset(device=dev, **{k: v for k, v in ds.items()
                                if k != "kind"})    # the caches, once
    fit = {"task": "fit", "dataset": ds, "allreduce_timed": True,
           "mesh": True,
           "configs": {"config": dict(PARALLEL_TRAIN,
                                      output_dir=os.path.join(tmp, "dp")),
                       "hfgs": TRAIN_HFGS}}
    grad = dict(fit, task="gradients")

    # The render inputs: two decoded clouds; the first depth-sorted, with
    # capacity for every tile's list; the 10^6 cloud.
    cam = Camera.default_training(RENDER["res"]).to(dev)
    batch = [torch.stack([a, b]).cpu() for a, b in zip(*clouds)]
    proj = projection.project_gaussians(*clouds[0][:3], cam)
    proj = dataclasses.replace(proj, visible=proj.visible
                               & (clouds[0][4] > 0))
    order = projection.depth_sort_indices(proj)
    slab = [f[order].cpu() for f in clouds[0]]
    ntx = -(-RENDER["res"] // 16)
    totals = tile._tile_totals(proj.means2d, proj.radii, proj.visible, ntx,
                               ntx, 16)
    m_slab = int(totals.max().item())
    big = [f.contiguous() for f in fields(render_cloud(0))]
    m = RENDER["max_per_tile"]
    renders = [("batch", batch, TileRendererConfig(max_per_tile=m)),
               ("gaussian", slab, TileRendererConfig(max_per_tile=m_slab)),
               ("pixel_search", big, TileRendererConfig(
                   max_per_tile=m, binning="search")),
               ("pixel_stream", big, TileRendererConfig(
                   max_per_tile=m, binning="stream"))]
    tasks = [fit, grad] + [{"task": "render", "kind": kind.split("_")[0],
                      "fields": f, "camera": cam.to("cpu"), "config": cfg,
                      "repeats": PARALLEL_RENDER_REPEATS}
                     for kind, f, cfg in renders]
    rng = np.random.default_rng(0)
    net = {"w1": (rng.normal(size=(TP_NET["d_in"], TP_NET["d_hidden"]))
                  * 0.1).astype(np.float32),
           "b1": np.zeros(TP_NET["d_hidden"], np.float32),
           "w2": (rng.normal(size=(TP_NET["d_hidden"], TP_NET["d_out"]))
                  * 0.1).astype(np.float32)}
    x = rng.normal(size=(TP_NET["batch"], TP_NET["d_in"])).astype(np.float32)
    tasks.append({"task": "tp_step", "params": net, "x": x, "shape": (1, n),
                  "min_elems": TP_NET["min_elems"],
                  "trainer": {"configs": fit["configs"]}})
    lap("inputs")
    t0 = time.perf_counter()
    res = launch.run_job(tasks, n, os.path.join(tmp, "job"), device="cuda:0",
                         backend="gloo", timeout=PARALLEL_PHASES_CAP_S)
    job_s = time.perf_counter() - t0
    lap("ranks")

    # 94. parallel_train: the world-2 fit against the single-process one
    # (twice, for the card's own spread), and the first batch's gradient.
    def world1(task, name):
        return getattr(jobs, task["task"])(dict(task, mesh=False, configs={
            **task["configs"], "config": dict(
                PARALLEL_TRAIN, output_dir=os.path.join(tmp, name))}), dev)

    one, again, g1 = (world1(fit, "one"), world1(fit, "again"),
                      world1(grad, "grad"))
    two = [r[0] for r in res]
    g2 = res[0][1]["grads"]
    loss_rel = [abs(a - b) / abs(b) for a, b in
                zip(two[0]["step_loss"], one["step_loss"])]
    again_rel = [abs(a - b) / abs(b) for a, b in
                 zip(again["step_loss"], one["step_loss"])]
    norm = math.sqrt(sum(float((g1["grads"][k] ** 2).sum())
                         for k in g1["grads"]))
    grad_rel = math.sqrt(sum(float(((g2[k] - g1["grads"][k]) ** 2).sum())
                             for k in g1["grads"])) / norm
    leaf_rel = sorted(((k, ((g2[k] - g).norm() / g.norm()).item())
                       for k, g in g1["grads"].items()
                       if g.norm() > 0 and not re.search(REF_ZERO_GRAD, k)),
                      key=lambda kv: -kv[1])[:3]

    def mean_gaps(a):
        gaps = {k: (a["params"][k] - v).abs().mean().item()
                for k, v in one["params"].items()
                if not re.search(REF_ZERO_GRAD, k)}
        return dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:3])
    ar = two[0]["allreduce"]
    launches = {k: sum(t["launches"][k] for t in two)
                for k in ("k1", "k2", "k3", "k4")}
    path_launches["parallel_train"] = launches
    log("parallel_train", ranks=n, backend="gloo", device="cuda:0",
        config={k: PARALLEL_TRAIN[k] for k in (
            "experiment", "gaussians_per_patch", "feature_size",
            "encoder_width", "image_size", "max_per_tile", "batch_size")},
        batch_per_rank=PARALLEL_TRAIN["batch_size"] // n, dropout=0.1,
        steps=PARALLEL_STEPS, losses_world2=two[0]["step_loss"],
        losses_world1=one["step_loss"], losses_world1_again=again[
            "step_loss"], loss_rel=loss_rel, loss_rel_world1_again=again_rel,
        loss_rtol_first=PARALLEL_LOSS_RTOL,
        loss_rtol_later=PARALLEL_LATER_LOSS_RTOL, grad_rel=grad_rel,
        grad_rtol=PARALLEL_GRAD_RTOL, grad_rel_worst_leaves=dict(leaf_rel),
        grad_losses_world2=res[0][1]["losses"],
        grad_losses_world1=g1["losses"],
        param_mean_gap_worst=mean_gaps(two[0]),
        param_mean_gap_world1_again=mean_gaps(again),
        sha256_by_rank=[t["sha256"] for t in two],
        ms_per_step_world2=two[0]["step_ms"],
        ms_per_step_world1=one["step_ms"],
        allreduce_calls=ar["calls"], allreduce_bytes=ar["bytes"],
        allreduce_ms_per_call=1e3 * ar["seconds"] / max(ar["calls"], 1),
        launches_by_rank=[t["launches"] for t in two],
        note="gloo on one card: the all-reduce goes through host copies; "
             "not what NCCL across cards would take")
    if len({t["sha256"] for t in two}) != 1:
        fail("the ranks' parameters differ after the data-parallel fit")
    if not (loss_rel[0] <= PARALLEL_LOSS_RTOL
            and max(loss_rel) <= PARALLEL_LATER_LOSS_RTOL
            and grad_rel <= PARALLEL_GRAD_RTOL):
        fail(f"the world-2 fit disagrees with world 1: losses {loss_rel}, "
             f"gradient {grad_rel}")
    if any(t["launches"] != dict(k1=PARALLEL_STEPS, k2=PARALLEL_STEPS,
                                 k3=0, k4=0) for t in two) \
            or ar["calls"] != PARALLEL_STEPS:
        fail(f"the data-parallel fit launched {[t['launches'] for t in two]}"
             f", all-reduced {ar['calls']} times in {PARALLEL_STEPS} steps")
    lap("parallel_train")

    # 95. parallel_nccl: the same fit at world size 1 over NCCL, against
    # the plain fit, both under the deterministic algorithms.
    with deterministic_algorithms(torch) as caught:
        plain = world1(fit, "plain_det")
        launch.init_distributed(0, 1, launch.file_init(tmp), dev)
        from torch import distributed as tdist
        backend = tdist.get_backend()
        nccl = jobs.fit(dict(fit, configs={**fit["configs"], "config": dict(
            PARALLEL_TRAIN, output_dir=os.path.join(tmp, "nccl"))}), dev)
        launch.shutdown()
    undetermined = sorted({str(w.message).split("\n")[0][:200]
                           for w in caught
                           if "deterministic" in str(w.message)})
    path_launches["parallel_nccl"] = nccl["launches"]
    want_refusal = torch.cuda.device_count() < n
    refusal = None
    if want_refusal:
        try:
            tcli.main(["--synthetic", "--epochs", "1", "--device", "cuda",
                       "--num_devices", str(n), "--output_dir",
                       os.path.join(tmp, "refused")])
        except ValueError as e:
            refusal = str(e)
    bitwise = (nccl["sha256"] == plain["sha256"]
               and nccl["step_loss"] == plain["step_loss"])
    log("parallel_nccl", backend=backend, world=1, bitwise_equal=bitwise,
        sha256=[nccl["sha256"], plain["sha256"]],
        losses_nccl=nccl["step_loss"], losses_plain=plain["step_loss"],
        param_mean_gap_worst=mean_gaps(nccl),
        deterministic_algorithms=True, warned_not_deterministic=undetermined,
        ms_per_step_nccl=nccl["step_ms"], ms_per_step_plain=plain["step_ms"],
        allreduce_calls=nccl["allreduce"]["calls"],
        allreduce_ms_per_call=1e3 * nccl["allreduce"]["seconds"]
        / max(nccl["allreduce"]["calls"], 1),
        launches=nccl["launches"], num_devices_refusal=refusal,
        device_count=torch.cuda.device_count())
    if not (backend == "nccl" and bitwise):
        fail("the world-1 NCCL fit is not the plain fit bit for bit")
    if nccl["launches"] != dict(k1=PARALLEL_STEPS, k2=PARALLEL_STEPS, k3=0,
                                k4=0) \
            or nccl["allreduce"]["calls"] != PARALLEL_STEPS:
        fail(f"the world-1 NCCL fit launched {nccl['launches']}, "
             f"all-reduced {nccl['allreduce']['calls']} times")
    if want_refusal and not refusal:
        fail(f"--num_devices {n} on {torch.cuda.device_count()} card(s) "
             "did not raise ValueError")
    lap("parallel_nccl")

    # 96. parallel_render: each against render_tiled in this process.
    out, render_launches = {}, {"k1": 0, "k2": 0, "k3": 0, "k4": 0}
    for i, (kind, f, cfg) in enumerate(renders, start=2):
        got = [r[i]["image"] for r in res]
        t = [a.to(dev) for a in f]
        with torch.no_grad():
            if kind == "batch":
                ref = torch.stack([tile.render_tiled(
                    *[a[b] for a in t], cam, config=cfg) for b in range(2)])
            else:
                ref = tile.render_tiled(*t, cam, config=cfg)
            ovf = (tile.render_tiled(*t, cam, config=cfg,
                                     return_overflow=True)[1].tolist()
                   if kind != "batch" else None)
            t0 = time.perf_counter()
            for _ in range(PARALLEL_RENDER_REPEATS):
                if kind == "batch":
                    tile.render_tiled_batched(*t, cam, config=cfg)
                else:
                    tile.render_tiled(*t, cam, config=cfg)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3 \
                / PARALLEL_RENDER_REPEATS
        err = (got[0] - ref.cpu()).abs().max().item()
        tol = PARALLEL_RENDER_TOL[kind.split("_")[0]]
        for k in render_launches:
            render_launches[k] += sum(r[i]["launches"][k] for r in res)
        out[kind] = dict(max_abs_err=err, tol=tol, M=cfg.max_per_tile,
                         ranks_equal=all(torch.equal(g, got[0])
                                         for g in got),
                         ms_by_rank=[r[i]["ms"] for r in res],
                         one_process_ms=plain_ms, overflow=ovf,
                         launches_by_rank=[r[i]["launches"] for r in res])
        if not (err <= tol and out[kind]["ranks_equal"]):
            fail(f"the {kind} sharded render disagrees: {out[kind]}")
    path_launches["parallel_render"] = render_launches
    log("parallel_render", ranks=n, size=RENDER["res"],
        n_gaussians={"batch": 2 * clouds[0][0].shape[0],
                     "gaussian": slab[0].shape[0], "pixel": RENDER["n"]},
        renders=out, launches=render_launches)
    if out["gaussian"]["overflow"][0] != 0:
        fail(f"the slab render dropped pairs: {out['gaussian']['overflow']}")
    if not (render_launches["k3"] >= n and render_launches["k4"] >= n):
        fail(f"the pixel-sharded renders launched {render_launches}")
    lap("parallel_render")

    # 97. parallel_tp: against the replicated step on the card.
    p = {k: torch.from_numpy(v).to(dev).requires_grad_() for k, v in
         net.items()}
    h = torch.tanh(torch.from_numpy(x).to(dev) @ p["w1"] + p["b1"])
    loss = torch.mean((h @ p["w2"]) ** 2)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    tps = [r[-1] for r in res]
    loss_gap = max(abs(r["loss"] - loss.item()) / abs(loss.item())
                   for r in tps)
    grad_gap = max((r["grads"][k] - g.cpu()).abs().max().item()
                   for r in tps for k, g in grads.items())
    log("parallel_tp", mesh=(1, n), axes=("data", "model"),
        specs=tps[0]["specs"], loss_rel=loss_gap, grad_max_abs=grad_gap,
        tol=TP_TOL, sharded_fraction=tps[0]["fraction"],
        grad_placements=tps[0]["grad_placements"],
        flagship_state_sharded_fraction=tps[0]["trainer_fraction"])
    if not (loss_gap <= TP_TOL and grad_gap <= TP_TOL
            and tps[0]["fraction"] > 0.9
            and tps[0]["trainer_fraction"] > 0.9):
        fail(f"the tensor-parallel step disagrees: {loss_gap} {grad_gap}")
    lap("parallel_tp")

    total = sum(phase_s.values())
    log("parallel_phases", seconds=phase_s, ranks_job_seconds=job_s,
        total_seconds=total, cap_seconds=PARALLEL_PHASES_CAP_S)
    if total > PARALLEL_PHASES_CAP_S:
        fail(f"phases 94-97 took {total:.1f} s, over their "
             f"{PARALLEL_PHASES_CAP_S} s cap")


def pack_kernels(torch, raster, pack, counts, ntx, ti, backward,
                 tile_size=16):
    """K1 (and with `backward` K2, cotangents from a seed) against their
    plain versions on one pack of tile size `tile_size`: errors, K2's
    repeat from run to run, times and bounds."""
    kw = dict(tiles_per_image=ti, tile_size=tile_size)
    with torch.no_grad():
        fwd = raster.composite_tiles_packed(pack, counts, ntx, **kw)
        ref = raster.composite_tiles_plain(pack, counts, ntx, **kw)
        ferr = max((g - r).abs().max().item() for g, r in zip(fwd, ref))
        k1_t = kernel_times(torch, lambda: raster._launch_fwd(
            pack, counts, ntx, keep_prefix=backward, **kw))
        k1_plain = cuda_median_ms(torch, lambda: raster.composite_tiles_plain(
            pack, counts, ntx, **kw), n=5, warmup=1)
        T, M = pack.shape[:2]
        occupied = int(counts.sum().item())
        stats = pack_stats(torch, raster, pack, counts, ntx,
                           tiles_per_image=ti, tile_size=tile_size)
        bnds = compositing_bounds(stats, T, M, occupied,
                                  pix=tile_size * tile_size)
        out = dict(T=T, M=M, tiles_per_image=ti or T, tile_size=tile_size,
                   occupied_slots=occupied, k1_max_abs_err=ferr,
                   k1=dict(**k1_t, plain_ms=k1_plain, **bnds["k1"]),
                   counts_max=stats["counts_max"],
                   counts_median=stats["counts_median"],
                   tiles_at_cap=stats["tiles_at_cap"],
                   segment_length=stats["segment_length"],
                   box_pixel_share=stats["box_pixel_share"])
        if not backward:
            return out
        crng = np.random.default_rng(4)
        cots = [torch.from_numpy(crng.normal(size=tuple(o.shape)).astype(
            np.float32)).to(pack.device) for o in fwd]
        prefix = raster._launch_fwd(pack, counts, ntx, keep_prefix=True,
                                    **kw)[3]
        got = raster._launch_bwd(pack, counts, ntx, *fwd, *cots,
                                 prefix=prefix, **kw)
        again = raster._launch_bwd(pack, counts, ntx, *fwd, *cots,
                                   prefix=prefix, **kw)
        bref = raster.composite_tiles_bwd_plain(pack, counts, ntx, *fwd,
                                                *cots, **kw)
        berr, _, rel = bwd_errors(got, bref)
        k2_t = kernel_times(torch, lambda: raster._launch_bwd(
            pack, counts, ntx, *fwd, *cots, prefix=prefix, **kw))
        k2_plain = cuda_median_ms(
            torch, lambda: raster.composite_tiles_bwd_plain(
                pack, counts, ntx, *fwd, *cots, **kw),
            n=3, warmup=1)
    out.update(k2_max_abs_err=max(berr.values()), k2_rel_err=max(rel.values()),
               k2_repeat_bitwise_equal=bool(torch.equal(got, again)),
               k2=dict(**k2_t, plain_ms=k2_plain, **bnds["k2"]))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, HERE)
    from fresnel_tpu_torch import _build, cli, pipeline
    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import fit_teacher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    cpu = torch.device("cpu")
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    # 1. device
    log("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])

    # 2. build, all eight kernels at once
    counters = (raster, binning, stream_binning)
    t0 = time.perf_counter()
    built = _build.build()
    log("build", seconds=time.perf_counter() - t0,
        libraries={k: os.path.relpath(p, HERE) for k, (p, _) in built.items()},
        ptxas={k: ptxas_lines(out) for k, (_, out) in built.items()})

    # 3. kernel (K1), at the image->3DGS path's shapes
    rng = np.random.default_rng(0)
    images = [torch.from_numpy(rng.uniform(size=(512, 512, 3)).astype(
        np.float32)).to(dev) for _ in range(N_IMAGES)]
    camera = Camera.default_training(pipeline.RENDER_SIZE)
    models = pipeline.build_models(seed=0, device=dev)
    tp, n_decoded = decoded_pack(torch, models, images[0])
    dec_cloud = decoded_cloud(torch, models, images[0])
    dec_cloud2 = decoded_cloud(torch, models, images[1])
    pack, counts = tp.pack, tp.counts
    T, M, _ = pack.shape
    with torch.no_grad():
        got = raster.composite_tiles_packed(pack, counts, tp.n_tiles_x)
    ref = raster.composite_tiles_plain(pack, counts, tp.n_tiles_x)
    torch.cuda.synchronize()
    errs = {name: (g - r).abs().max().item()
            for name, g, r in zip(("color", "depth", "transmittance"),
                                  got, ref)}
    max_err = max(errs.values())
    with torch.no_grad():
        k1_t = kernel_times(
            torch, lambda: raster.composite_tiles_packed(pack, counts,
                                                         tp.n_tiles_x))
        plain_ms = cuda_median_ms(
            torch, lambda: raster.composite_tiles_plain(pack, counts,
                                                        tp.n_tiles_x))
    occupied = int(counts.sum().item())
    totals = tile._tile_totals(tp.means2d, tp.radii, tp.visible,
                               tp.n_tiles_x, tp.n_tiles_y, 16)
    stats = pack_stats(torch, raster, pack, counts, tp.n_tiles_x)
    b1 = compositing_bounds(stats, T, M, occupied)["k1"]
    log("kernel", name="raster_fwd", T=T, M=M, n_gaussians=n_decoded,
        max_abs_err=errs, tol=KERNEL_TOL, **k1_t, plain_ms=plain_ms,
        occupied_slots=occupied, counts_mean=occupied / T, **stats,
        total_pairs=int(totals.sum().item()),
        dropped_pairs=int(torch.clamp(totals - M, min=0).sum().item()),
        **b1)
    if not max_err <= KERNEL_TOL:
        fail(f"kernel disagrees with its plain version: {errs}")
    k1 = dict(max_abs_err=max_err, ms=k1_t["ms"], plain_ms=plain_ms,
              bound_ms=b1["bound_ms"], bound_by=b1["bound_by"])

    # 4. main path, through the entry point a user calls
    for img in images[:2]:                                   # warmup
        pipeline.image_to_3dgs(models, img, camera, device=dev)
    torch.cuda.synchronize()
    reset_counts(*counters)
    events = []
    outs = []
    t0 = time.perf_counter()
    for img in images:
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        outs.append(pipeline.image_to_3dgs(models, img, camera, device=dev))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / len(images) * 1e3
    path_launches = {"image_to_3dgs": read_counts(*counters)}
    e2e = [s.elapsed_time(e) for s, e in events]
    for pos, img in outs:
        if tuple(pos.shape) != (1, 5476, 3) or not torch.isfinite(pos).all():
            fail(f"bad positions {tuple(pos.shape)}")
        if tuple(img.shape) != (3, 512, 512) or not torch.isfinite(img).all() \
                or img.min().item() < 0.0 or img.max().item() > 1.0:
            fail(f"bad image {tuple(img.shape)}")
    if path_launches["image_to_3dgs"] != dict(k1=len(images), k2=0, k3=0,
                                              k4=0):
        fail(f"kernels launched {path_launches['image_to_3dgs']} times in "
             f"{len(images)} calls")
    log("main_path", images=len(images),
        launches=path_launches["image_to_3dgs"]["k1"],
        e2e_ms_median=statistics.median(e2e), e2e_ms=e2e,
        host_ms_per_image=host_ms,
        image_mean=[o[1].mean().item() for o in outs],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 5. stages
    names = ("resize_dinov2", "depth_anything", "decoder",
             "project_sort_bin_gather", "raster_fwd")
    per_stage = {n: [] for n in names}
    with torch.no_grad():
        for img in images:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            x = pipeline.resize_to_model(img)
            feats = models.dino(x)
            ev[1].record()
            depth = models.depth(x)
            ev[2].record()
            out = models.decoder(feats, depth)
            ev[3].record()
            tp_i = tile.pack_tiles(*[out[k][0] for k in (
                "positions", "scales", "rotations", "colors", "opacities")],
                camera)
            ev[4].record()
            raster.composite_tiles_packed(tp_i.pack, tp_i.counts,
                                          tp_i.n_tiles_x)
            ev[5].record()
            torch.cuda.synchronize()
            for i, n in enumerate(names):
                per_stage[n].append(ev[i].elapsed_time(ev[i + 1]))
    log("stages", ms_median={n: statistics.median(v)
                             for n, v in per_stage.items()})

    # 6. reference: float32 on the card against float32 on the CPU
    m_cpu = pipeline.build_models(seed=0, device=cpu, dtype=torch.float32)
    m_gpu = pipeline.build_models(seed=0, device=dev, dtype=torch.float32)
    pos_c, img_c = pipeline.image_to_3dgs(m_cpu, images[1].cpu(), camera,
                                          device=cpu)
    pos_g, img_g = pipeline.image_to_3dgs(m_gpu, images[1], camera,
                                          device=dev)
    pos_err = (pos_g.cpu() - pos_c).abs().max().item()
    img_err = (img_g.cpu() - img_c).abs()
    bf16_pos_err = (outs[1][0] - pos_g).abs().max().item()
    log("reference", pos_max_abs=pos_err, pos_tol=REF_POS_TOL,
        img_mean_abs=img_err.mean().item(), img_max_abs=img_err.max().item(),
        img_mean_tol=REF_IMG_MEAN_TOL, bf16_vs_f32_pos_max_abs=bf16_pos_err)
    if not (pos_err <= REF_POS_TOL and img_err.mean().item() <= REF_IMG_MEAN_TOL):
        fail("the card's float32 path disagrees with the CPU's")
    del m_cpu, m_gpu

    # 7. profile: the device's busy share over the image->3DGS path
    n_prof = 4
    prof = profile_ms(torch, lambda: [
        pipeline.image_to_3dgs(models, img, camera, device=dev)
        for img in images[:n_prof]], n_prof)
    log("profile", images=n_prof, wall_ms_per_image=prof["wall_ms"],
        device_ms_per_image=prof["device_ms"],
        device_busy_share=prof["device_busy_share"],
        kernels_per_image=prof["kernels"],
        top_kernels_ms_per_image=prof["top_kernels_ms"])
    del models

    # 8. kernel_bwd (K2), at the refine path's shapes: the full-width init
    scene, depth, cam_r, cfg_r, raw0, tp = refine_init(torch, dev)
    pack, counts = tp.pack, tp.counts
    T, M, _ = pack.shape
    with torch.no_grad():
        fwd = raster.composite_tiles_packed(pack, counts, tp.n_tiles_x)
        fwd_ref = raster.composite_tiles_plain(pack, counts, tp.n_tiles_x)
        fwd_errs = {name: (g - r).abs().max().item() for name, g, r in zip(
            ("color", "depth", "transmittance"), fwd, fwd_ref)}
        crng = np.random.default_rng(1)
        cots = [torch.from_numpy(crng.normal(size=tuple(o.shape)).astype(
            np.float32)).to(dev) for o in fwd]
        got = raster.composite_tiles_bwd(pack, counts, tp.n_tiles_x, *fwd,
                                         *cots)
        again = raster.composite_tiles_bwd(pack, counts, tp.n_tiles_x, *fwd,
                                           *cots)
        ref = raster.composite_tiles_bwd_plain(pack, counts, tp.n_tiles_x,
                                               *fwd, *cots)
        torch.cuda.synchronize()
        ferr, scale, rel = bwd_errors(got, ref)
        routes = k2_routes(torch, raster, pack, counts, tp.n_tiles_x, fwd,
                           cots)
        bwd_plain_ms = cuda_median_ms(
            torch, lambda: raster.composite_tiles_bwd_plain(
                pack, counts, tp.n_tiles_x, *fwd, *cots), n=10)
        # K1 as the refine step launches it: leaving the segment prefixes.
        fwd_t = kernel_times(torch, lambda: raster._launch_fwd(
            pack, counts, tp.n_tiles_x, keep_prefix=True))
        fwd_plain_ms_refine = cuda_median_ms(
            torch, lambda: raster.composite_tiles_plain(pack, counts,
                                                        tp.n_tiles_x), n=10)
    occupied = int(counts.sum().item())
    stats = pack_stats(torch, raster, pack, counts, tp.n_tiles_x)
    bounds_r = compositing_bounds(stats, T, M, occupied)
    repeat_equal = bool(torch.equal(got, again))
    log("kernel_bwd", name="raster_bwd", T=T, M=M, n_gaussians=raw0.size // 16,
        max_abs_err=ferr, field_scale=scale, rel_err=rel,
        tol=KERNEL_BWD_TOL, repeat_bitwise_equal=repeat_equal,
        **routes["handed"],
        routes_bitwise_equal=routes["routes_bitwise_equal"],
        ms_alone=routes["alone"]["ms"],
        call_ms_alone=routes["alone"]["call_ms"],
        plain_ms=bwd_plain_ms, occupied_slots=occupied,
        counts_mean=occupied / T, **stats, **bounds_r["k2"],
        k1_at_refine_shapes=dict(max_abs_err=fwd_errs, tol=KERNEL_TOL,
                                 keep_prefix=True, **fwd_t,
                                 plain_ms=fwd_plain_ms_refine,
                                 **bounds_r["k1"]))
    if not max(fwd_errs.values()) <= KERNEL_TOL:
        fail(f"K1 disagrees with its plain version at the refine shapes: "
             f"{fwd_errs}")
    if not (max(rel.values()) <= KERNEL_BWD_TOL
            and routes["routes_bitwise_equal"]):
        fail(f"K2 disagrees with its plain version or across its routes: "
             f"{rel}")
    if not repeat_equal:
        fail("K2 does not repeat bit for bit")
    k1_small, k2_small = kernel_small_m(torch, dev)
    k1["max_abs_err"] = max(k1["max_abs_err"], max(fwd_errs.values()),
                            k1_small)
    k2 = dict(max_abs_err=max(max(ferr.values()), k2_small),
              ms=routes["handed"]["ms"],
              plain_ms=bwd_plain_ms, bound_ms=bounds_r["k2"]["bound_ms"],
              bound_by=bounds_r["k2"]["bound_by"])

    # 9. refine_grad: loss and gradient at the init, card against CPU
    def loss_and_grad(device):
        raw = torch.from_numpy(raw0.copy()).to(device).requires_grad_()
        do = torch.tensor(REFINE["depth_offset_init"],
                          device=device).requires_grad_()
        img = fit_teacher.render_raw(
            raw, torch.from_numpy(depth).to(device)[None], do,
            cam_r.to(device), cfg_r)
        loss = fit_teacher.photometric_loss(
            img, torch.from_numpy(scene).to(device))
        loss.backward()
        return loss.item(), raw.grad.cpu(), do.grad.cpu()

    lg, rg, dg = loss_and_grad(dev)
    lg2, rg2, dg2 = loss_and_grad(dev)
    lc, rc, dc = loss_and_grad(cpu)
    raw_err = (rg - rc).abs()
    raw_rel = raw_err.max().item() / rc.abs().max().item()
    do_rel = abs(dg.item() - dc.item()) / abs(dc.item())
    log("refine_grad", loss_card=lg, loss_cpu=lc,
        loss_rel=abs(lg - lc) / abs(lc), loss_rtol=REFINE_LOSS_RTOL,
        raw_grad_max_abs=rc.abs().max().item(),
        raw_err_max=raw_err.max().item(), raw_err_mean=raw_err.mean().item(),
        raw_rel=raw_rel, do_grad_card=dg.item(), do_grad_cpu=dc.item(),
        do_rel=do_rel, tol=REFINE_GRAD_TOL,
        card_repeat_raw_max_abs=(rg - rg2).abs().max().item(),
        card_repeat_loss_abs=abs(lg - lg2))
    if not (abs(lg - lc) <= REFINE_LOSS_RTOL * abs(lc)
            and raw_rel <= REFINE_GRAD_TOL and do_rel <= REFINE_GRAD_TOL):
        fail("the refine gradient on the card disagrees with the CPU's")

    # 10. refine_path: fit_scene at full width
    fit_kw = dict(REFINE, device=dev)
    init_t, _ = fit_teacher.fit_scene(scene, depth, steps=0, **fit_kw)
    fit_teacher.fit_scene(scene, depth, steps=5, **fit_kw)      # warmup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*counters)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    teacher, metrics = fit_teacher.fit_scene(scene, depth,
                                             steps=REFINE_STEPS, **fit_kw)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    path_launches["refine"] = read_counts(*counters)
    losses = metrics["losses"]
    log("refine_path", steps=REFINE_STEPS, config=REFINE,
        launches_k1=raster.launches, launches_k2=raster.launches_bwd,
        ms_per_step=start.elapsed_time(end) / REFINE_STEPS,
        host_ms_per_step=host_ms / REFINE_STEPS,
        ssim_init=float(init_t["ssim"]), ssim=metrics["ssim"],
        psnr_init=float(init_t["psnr"]), psnr=metrics["psnr"],
        loss_first=losses[0], loss_last=losses[-1],
        depth_offset=float(teacher["depth_offset"]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if path_launches["refine"] != dict(k1=REFINE_STEPS + 1, k2=REFINE_STEPS,
                                       k3=0, k4=0):
        fail(f"refine launched K1, K2 {path_launches['refine']} times in "
             f"{REFINE_STEPS} steps")
    if len(losses) != REFINE_STEPS or not np.all(np.isfinite(losses)):
        fail("a refine loss is not finite")
    if not metrics["ssim"] > float(init_t["ssim"]):
        fail("SSIM did not rise over the fit")

    # 11. refine_reference: 3 steps on the card and on the CPU, same init
    n_ref = 3
    ref_kw = dict(REFINE, steps=n_ref)
    tg, mg = fit_teacher.fit_scene(scene, depth, device=dev, **ref_kw)
    tc, mc = fit_teacher.fit_scene(scene, depth, device=cpu, **ref_kw)
    raw_d = np.abs(tg["raw"] - tc["raw"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mg["losses"],
                                                       mc["losses"]))
    log("refine_reference", steps=n_ref, losses_card=mg["losses"],
        losses_cpu=mc["losses"], loss_rel_max=loss_rel,
        loss_rtol=REF_LOSS_RTOL, raw_max_abs=float(raw_d.max()),
        raw_mean_abs=float(raw_d.mean()), raw_mean_tol=REF_RAW_MEAN_TOL,
        raw_max_bound=2 * REFINE["lr"] * n_ref,
        depth_offset_card=float(tg["depth_offset"]),
        depth_offset_cpu=float(tc["depth_offset"]))
    if not (loss_rel <= REF_LOSS_RTOL and raw_d.mean() <= REF_RAW_MEAN_TOL
            and raw_d.max() <= 2 * REFINE["lr"] * n_ref):
        fail("the card's refine trajectory disagrees with the CPU's")

    # 12. cli: the function under `refine`, writing and reading a PLY
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cloud, cm = cli.refine(scene.transpose(1, 2, 0), steps=20,
                               size=REFINE["res"], device=dev)
        path = os.path.join(tmp, "out.ply")
        gio.save_ply(path, cloud)
        back = gio.load_ply(path)
        flat = back.to_flat()
        log("cli", steps=20, seconds=time.perf_counter() - t0,
            rows=back.num_gaussians, finite=bool(torch.isfinite(flat).all()),
            ssim=cm["ssim"], psnr=cm["psnr"],
            depth_estimator=cm["depth_estimator"],
            ply_bytes=os.path.getsize(path))
        if back.num_gaussians != 5476 or not torch.isfinite(flat).all():
            fail("the refined PLY is not 5 476 finite rows")

    # 13. refine_profile
    n_prof = 5
    prof = profile_ms(torch, lambda: fit_teacher.fit_scene(
        scene, depth, steps=n_prof, **fit_kw), n_prof)
    log("refine_profile", steps=n_prof, wall_ms_per_step=prof["wall_ms"],
        device_ms_per_step=prof["device_ms"],
        device_busy_share=prof["device_busy_share"],
        kernels_per_step=prof["kernels"],
        indexing_backward_ms_per_step=prof["indexing_backward_ms"],
        top_kernels_ms_per_step=prof["top_kernels_ms"])

    # 14-20. the large-cloud render path (K3, K4, K1)
    k3, k4 = render_phases(torch, dev, k1, k2, path_launches)

    # 21-24. decoder training at the flagship config (K1, K2)
    k1_train, k2_train = train_phases(torch, dev, path_launches)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_train["max_abs_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_train["max_abs_err"])
    k1["at_train_pack"], k2["at_train_pack"] = k1_train, k2_train

    # 25-31. the committed trained checkpoints (K1 in eval, K1 + K2 in
    # resumed and view-aware training)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    k1_eval, k12_view = checkpoint_phases(torch, dev, path_launches, tmp)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_eval["k1_max_abs_err"],
                            k12_view["k1_max_abs_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"], k12_view["k2_max_abs_err"])
    k1["at_eval_pack"] = dict(k1_eval["k1"], T=k1_eval["T"], M=k1_eval["M"])
    k1["at_view_pack"] = dict(k12_view["k1"], T=k12_view["T"],
                              M=k12_view["M"])
    k2["at_view_pack"] = dict(k12_view["k2"], T=k12_view["T"],
                              M=k12_view["M"])

    # 32-37. experiment 4, distillation, the 74^2 decoders (K1 in eval,
    # K1 + K2 in the teacher fits and distilled training)
    k_m384, k_train4 = exp4_phases(torch, dev, path_launches, tmp)
    # 38-43. the CVS family (K1 in its datasets, K1 + K2 in the 3DGS fit)
    k_teacher, k_fit = cvs_phases(torch, dev, path_launches, tmp)
    # 44-48. the SAAG path, the viewer server (K3 + K1 at /render) and
    # experiments 1, 3 and 5 (K1 + K2 in training)
    k_saag, k_exp135 = saag_phases(torch, dev, path_launches, tmp)
    # 49-54. DINOv2 and Depth-Anything from a local path (no K1-K4 in
    # infer; K1 + K2 in refine and training; K3 + K1 at /render) and the
    # decoder options (K1 + K2 per step)
    k_launcher = backbone_phases(torch, dev, path_launches, tmp)
    # 55-62. the wave-optics training routes (K1 + K2 on train.sh full's,
    # K1-phi + K2-phi on the phase-blended, K5 + K6 on the wave and
    # Fourier routes)
    k_wave = wave_phases(torch, dev, path_launches, tmp)
    # 63-66. bf16 decoder training, use_amp (K1 + K2 on the flagship and
    # experiments 1, 3, 4, 5; K5 + K6 on the physics decoder; K1-phi +
    # K2-phi on phase blending)
    amp_phases(torch, dev, path_launches, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    # 67-70. the remaining renderers (K7 + K8 in dense and simplified, K5 +
    # K6 in asm), the diffractive layers and the quantised depth sorts
    k_render = renderer_phases(torch, dev, path_launches, dec_cloud)
    # 71-74. the LPIPS term in decoder training (K1 + K2 per step, with the
    # term on and off), ms_ssim and the Chamfer matching loss
    lpips_phases(torch, dev, path_launches)
    # 75-80. the overnight launcher (preprocessing, training with and
    # without --streaming, eval; K1 + K2 per step, K1 in eval), thin
    # checkpoints, the tuners (K1 + K2), depth training and the
    # stage-timed render (K3 or K4, K1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_item10_")
    item10_phases(torch, dev, path_launches, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    # 81-84. Fresnel v2 distillation: the decoders and the structure
    # predictor, V2Trainer at full width (K1 twice and K2 once per
    # render-loss step), its CLI, card against CPU
    tmp = tempfile.mkdtemp(prefix="chip_smoke_v2_")
    k_v2 = v2_phases(torch, dev, path_launches, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    # 85-88. `fresnel-torch smoke` (K1 once), the bridges (K1 per orbit
    # view of test_novel_views) and decoder export
    tmp = tempfile.mkdtemp(prefix="chip_smoke_item11_")
    item11_phases(torch, dev, path_launches, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    # 89-93. tile sizes 8 and 32: the decoded cloud (K1, K2, K1-phi,
    # K2-phi), the refine step (K1 + K2), PHASE_AB (K1-phi, K2-phi) and the
    # large-cloud render (K3 or K4, K1)
    k_ts, ts_err = item5_phases(torch, dev, path_launches, dec_cloud)
    # 94-97. parallel/: the data-parallel flagship fit on two gloo ranks
    # (K1 + K2 per rank and step) against one process, the same at world
    # size 1 over NCCL, the three sharded renders (K1; K3 or K4 per band
    # at 10^6) and tensor-parallel state sharding
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    parallel_phases(torch, dev, path_launches, (dec_cloud, dec_cloud2), tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    for kk, row in (("k1", k1), ("k2", k2), ("k3", k3), ("k4", k4),
                    ("k1phi", k_wave["k1phi"]), ("k2phi", k_wave["k2phi"])):
        row.update(k_ts[kk])
        row["max_abs_err"] = max(row["max_abs_err"], ts_err[kk])
    for key, pack in (("at_v2_pred_pack", k_v2["pred"]),
                      ("at_v2_teacher_pack", k_v2["teacher"])):
        k1["max_abs_err"] = max(k1["max_abs_err"], pack["k1_max_abs_err"])
        k1[key] = dict(pack["k1"], T=pack["T"], M=pack["M"])
        if "k2" in pack:
            k2["max_abs_err"] = max(k2["max_abs_err"],
                                    pack["k2_max_abs_err"])
            k2[key] = dict(pack["k2"], T=pack["T"], M=pack["M"])
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            k_saag["k1"]["k1_max_abs_err"])
    k1["at_saag_render_pack"] = dict(k_saag["k1"]["k1"], T=k_saag["k1"]["T"],
                                     M=k_saag["k1"]["M"])
    k3["at_saag_render_pack"] = {k: k_saag["k3"][k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "n2", "T",
        "groups")}
    for exp, pack in k_exp135.items():
        for kk, name in (("k1", k1), ("k2", k2)):
            name["max_abs_err"] = max(name["max_abs_err"],
                                      pack[f"{kk}_max_abs_err"])
            name[f"at_exp{exp}_train_pack"] = dict(pack[kk], T=pack["T"],
                                                   M=pack["M"])
    for key, pack in (("at_m384_pack", k_m384), ("at_exp4_train_pack",
                                                  k_train4),
                      ("at_cvs_teacher_pack", k_teacher),
                      ("at_cvs_fit_pack", k_fit),
                      ("at_launcher_train_pack", k_launcher)):
        k1["max_abs_err"] = max(k1["max_abs_err"], pack["k1_max_abs_err"])
        k1[key] = dict(pack["k1"], T=pack["T"], M=pack["M"])
        if "k2" in pack:
            k2["max_abs_err"] = max(k2["max_abs_err"],
                                    pack["k2_max_abs_err"])
            k2[key] = dict(pack["k2"], T=pack["T"], M=pack["M"])

    print(smi, flush=True)

    def entry(key, name, replaces, numbers):
        return {"name": name, "route": "cuda",
                "source": f"fresnel_tpu_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": sum(v.get(key, 0)
                                for v in path_launches.values()),
                "launches_by_path": {p: v[key]
                                     for p, v in path_launches.items()
                                     if key in v},
                **numbers, "library_ms": None}

    print(json.dumps({"kernels": [
        entry("k1", "raster_fwd", "fresnel_tpu/render/pallas_raster.py:135",
              k1),
        entry("k2", "raster_bwd", "fresnel_tpu/render/pallas_raster.py:179",
              k2),
        entry("k3", "bin_table", "fresnel_tpu/render/pallas_binning.py:44",
              k3),
        entry("k4", "bin_stream",
              "fresnel_tpu/render/pallas_stream_binning.py:56", k4),
        entry("k1phi", "raster_phase_fwd",
              "fresnel_tpu/render/tile.py:672", k_wave["k1phi"]),
        entry("k2phi", "raster_phase_bwd",
              "fresnel_tpu/render/tile.py:672", k_wave["k2phi"]),
        entry("k5", "dense_fwd", "fresnel_tpu/render/wave.py:63",
              dict(k_wave["k5"],
                   also_replaces="fresnel_tpu/render/fourier.py:85")),
        entry("k6", "dense_bwd", "fresnel_tpu/render/wave.py:63",
              dict(k_wave["k6"],
                   also_replaces="fresnel_tpu/render/fourier.py:85")),
        entry("k7", "dense_composite_fwd", "fresnel_tpu/render/dense.py:84",
              dict(k_render["k7"],
                   also_replaces="fresnel_tpu/render/simplified.py:61")),
        entry("k8", "dense_composite_bwd", "fresnel_tpu/render/dense.py:84",
              dict(k_render["k8"],
                   also_replaces="fresnel_tpu/render/simplified.py:61"))]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def ab_measure(root):
    """The kernels of the checkout at `root`: K1 and K2 on this script's
    image, refine and render packs, K3 and K4 on the render path's million
    depth-sorted Gaussians (T = 1024, M = 256), K5 and K6 on DENSE_AB's
    ISO and WAVE clouds; a dict of device ms, call ms and device ms by
    kernel name (the --ab mode)."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from fresnel_tpu_torch import _build, pipeline
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import (
        binning, dense_composite, raster, splat, stream_binning, tile)
    from fresnel_tpu_torch.train import fit_teacher

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    built = _build.build(["raster_fwd", "raster_bwd", "bin_table",
                          "bin_stream", "dense_fwd", "dense_bwd",
                          "raster_phase_fwd", "raster_phase_bwd",
                          "dense_composite_fwd", "dense_composite_bwd"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    image = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(512, 512, 3)).astype(np.float32)).to(dev)
    models = pipeline.build_models(seed=0, device=dev)
    packs = dict(image=decoded_pack(torch, models, image)[0])
    dec_cloud = decoded_cloud(torch, models, image)
    del models
    scene, depth, cam_r, _, raw0, packs["refine"] = refine_init(torch, dev)
    cam = Camera.default_training(RENDER["res"])
    cfg = tile.TileRendererConfig(max_per_tile=RENDER["max_per_tile"])
    with torch.no_grad():
        cloud = render_cloud(10).to(dev)
        packs["render"] = tile.pack_tiles(*fields(cloud), cam, cfg)
        sp = tile.project_sorted(*fields(cloud), cam, cfg)
        del cloud
    ntx = nty = RENDER["res"] // 16
    M = RENDER["max_per_tile"]
    xlo, xhi, ylo, yhi, vis, n2 = tile._padded_intervals(
        sp.means2d, sp.radii, sp.visible, 16)
    bounds = (xlo, torch.where(vis, xhi, -1), ylo, torch.where(vis, yhi, -1))
    sorted_in = (sp.means2d, sp.radii, sp.visible)
    iv = stream_binning.stream_intervals(*sorted_in, ntx, nty, 16)
    result = dict(root=root, device=torch.cuda.get_device_name(0),
                  ptxas={k: [ln.split("info    : ")[-1].strip()
                             for ln in out.splitlines()
                             if "registers" in ln or "spill" in ln]
                         for k, (_, out) in built.items()},
                  kernels={})
    for name, tp in packs.items():
        pack, counts, ntx = tp.pack, tp.counts, tp.n_tiles_x

        def k1():
            with torch.no_grad():
                return raster.composite_tiles_packed(pack, counts, ntx)

        calls = dict(k1=k1)
        if name != "image":
            outs = k1()
            rng = np.random.default_rng(1)
            cots = [torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(
                np.float32)).to(dev) for o in outs]

            def k2():
                return raster.composite_tiles_bwd(pack, counts, ntx, *outs,
                                                  *cots)

            def k1_k2():
                """A refine step's pair: K1 on a pack that needs a
                gradient, then K2 through autograd."""
                p = pack.detach().requires_grad_()
                torch.autograd.backward(
                    raster.composite_tiles_packed(p, counts, ntx), cots)

            calls.update(k2=k2, k1_k2_autograd=k1_k2)
        for kernel, fn in calls.items():
            # K1's and K2's outputs are the same bits in every version.
            out = fn()
            sha = None if out is None else hashlib.sha256(b"".join(
                t.detach().cpu().numpy().tobytes() for t in (
                    out if isinstance(out, tuple) else (out,)))).hexdigest()
            prof = profile_ms(torch, lambda: [fn() for _ in range(10)], 10)
            result["kernels"][f"{kernel}_{name}"] = dict(
                **kernel_times(torch, fn),
                occupied_slots=int(counts.sum().item()),
                output_sha256=None if sha is None else sha[:16],
                device_ms_by_kernel=prof["top_kernels_ms"])
    with torch.no_grad():
        calls = dict(
            k3=lambda: binning.build_rank_table(*bounds, ntx, nty, n2),
            k4=lambda: stream_binning.bin_gaussians_stream(
                *sorted_in, ntx, nty, 16, M),
            k4_launch=lambda: stream_binning._launch(iv, ntx, nty, M))
        for kernel, fn in calls.items():
            # Each result is dropped at once: K3's table is 2 GB.
            prof = profile_ms(torch, lambda: [fn() and None
                                              for _ in range(10)], 10)
            result["kernels"][f"{kernel}_render"] = dict(
                **kernel_times(torch, fn, n=20 if kernel == "k4" else 50),
                n_gaussians=RENDER["n"], n2=n2,
                device_ms_by_kernel=prof["top_kernels_ms"])
    # K5 / K6 on DENSE_AB's synthetic clouds, through the launchers.
    del packs, sp, iv, bounds, sorted_in
    for mode in (1, 0):
        d = dense_times(torch, splat, *dense_synthetic(torch, dev, mode), dev)
        result["kernels"][f"dense_{d['mode']}"] = d
    # K1-phi / K2-phi on PHASE_AB's pack, through the launchers, with the
    # sha256 of their outputs (K1-phi's are the same bits in every version).
    pack, counts, ntx, ti = phase_synthetic(torch, dev)
    amp = PHASE_AB["amplitude"]
    T, M = pack.shape[:2]
    with torch.no_grad():
        fwd = raster._launch_fwd_phase(pack, counts, ntx, amp,
                                       keep_ckpt=True, tiles_per_image=ti)
    rng = np.random.default_rng(12)
    cots = [torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(
        np.float32)).to(dev) for o in fwd[:3]]
    grad = raster._launch_bwd_phase(pack, counts, ntx, amp, *cots,
                                    ckpt=fwd[3], tiles_per_image=ti)
    stats = pack_stats(torch, raster, pack, counts, ntx, tiles_per_image=ti)
    occupied = int(counts.sum().item())
    bounds = compositing_bounds(
        stats, T, M, occupied, names=("k1phi", "k2phi"),
        ops=(OPS_PER_EVAL_PHASE, OPS_PER_EVAL_PHASE_BWD), bwd_pix=5,
        carry_bytes=math.prod(raster.checkpoint_shape(T, M)) * 4)
    calls = dict(
        k1phi=lambda: raster._launch_fwd_phase(
            pack, counts, ntx, amp, keep_ckpt=True, tiles_per_image=ti),
        k2phi=lambda: raster._launch_bwd_phase(
            pack, counts, ntx, amp, *cots, ckpt=fwd[3], tiles_per_image=ti))
    sha = dict(k1phi=hashlib.sha256(b"".join(
        o.cpu().numpy().tobytes() for o in fwd[:3])).hexdigest()[:16],
        k2phi=hashlib.sha256(grad.cpu().numpy().tobytes()).hexdigest()[:16])
    for kernel, fn in calls.items():
        with torch.no_grad():
            prof = profile_ms(torch, lambda: [fn() for _ in range(10)], 10)
            result["kernels"][f"{kernel}_phase"] = dict(
                **kernel_times(torch, fn), T=T, M=M, occupied_slots=occupied,
                bound_ms=bounds[kernel]["bound_ms"],
                bound_by=bounds[kernel]["bound_by"], output_sha256=sha[kernel],
                device_ms_by_kernel=prof["top_kernels_ms"])
    result["phase_pack"] = {k: stats[k] for k in (
        "counts_max", "counts_median", "tiles_at_cap", "box_pixel_pairs",
        "box_pixel_share", "box_warp_share")}
    if hasattr(raster, "phase_residency"):
        result["phase_residency"] = raster.phase_residency(dev)
    del pack, counts, fwd, cots, grad
    # K1, K2, K1-phi and K2-phi at tile sizes 8 and 32, where the
    # checkout's kernels take a tile size.
    if "tile_size" in inspect.signature(raster._launch_fwd).parameters:
        result["kernels"].update(tile_size_times(torch, dev, dec_cloud,
                                                 cam_r, raw0, depth))
    result["kernels"].update(composite_times(torch, dev, dec_cloud))
    if hasattr(dense_composite, "residency"):
        result["composite_residency"] = dense_composite.residency(dev)
    del dec_cloud
    # The refine step at full width: fit_scene's ms per step (CUDA events
    # around one call of 20 steps, after a warmup call) and its device ms
    # per step (torch.profiler over 5 steps).
    fit_kw = dict(REFINE, device=dev)
    fit_teacher.fit_scene(scene, depth, steps=3, **fit_kw)
    n_steps = 20
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    fit_teacher.fit_scene(scene, depth, steps=n_steps, **fit_kw)
    end.record()
    torch.cuda.synchronize()
    prof = profile_ms(torch, lambda: fit_teacher.fit_scene(
        scene, depth, steps=5, **fit_kw), 5)
    result["refine_step"] = dict(
        e2e_ms_per_step=start.elapsed_time(end) / n_steps,
        device_ms_per_step=prof["device_ms"],
        wall_ms_per_step=prof["wall_ms"], kernels_per_step=prof["kernels"],
        indexing_backward_ms_per_step=prof["indexing_backward_ms"],
        top_kernels_ms_per_step=prof["top_kernels_ms"])
    result["train_sh_full_step"] = train_route_times(
        torch, dev, WAVE_PATHS[0][2])
    return result


def tile_size_times(torch, dev, cloud, cam_r, raw0, depth):
    """K1 on the decoded cloud's pack, K2 on the refine init's (handed
    K1's prefixes, cotangents from a seed) and K1-phi / K2-phi on
    PHASE_AB, at each of ITEM5_TILE_SIZES: device ms and call ms."""
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.models.decoders import head_transform
    from fresnel_tpu_torch.render import raster, tile

    with torch.no_grad():
        head = head_transform(torch.from_numpy(raw0).to(dev),
                              torch.from_numpy(depth).to(dev)[None],
                              torch.tensor(REFINE["depth_offset_init"],
                                           device=dev))
    amp = PHASE_AB["amplitude"]
    res = {}
    for ts in ITEM5_TILE_SIZES:
        kw = dict(tile_size=ts)
        rng = np.random.default_rng(ts)
        with torch.no_grad():
            ip = tile.pack_tiles(*cloud, Camera.default_training(512),
                                 tile.TileRendererConfig(tile_size=ts))
            rp = tile.pack_tiles(
                *[head[k][0] for k in FIELDS], cam_r.to(dev),
                tile.TileRendererConfig(max_per_tile=REFINE["max_per_tile"],
                                        tile_size=ts))
            fwd = raster._launch_fwd(rp.pack, rp.counts, rp.n_tiles_x,
                                     keep_prefix=True, **kw)
            cots = [torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(
                np.float32)).to(dev) for o in fwd[:3]]
            pack, counts, ntx, ti = phase_synthetic(torch, dev, ts)
            pf = raster._launch_fwd_phase(pack, counts, ntx, amp,
                                          keep_ckpt=True, tiles_per_image=ti,
                                          **kw)
            pcots = [torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(
                np.float32)).to(dev) for o in pf[:3]]
            calls = {
                f"k1_image_ts{ts}": lambda: raster._launch_fwd(
                    ip.pack, ip.counts, ip.n_tiles_x, **kw),
                f"k2_refine_ts{ts}": lambda: raster._launch_bwd(
                    rp.pack, rp.counts, rp.n_tiles_x, *fwd[:3], *cots,
                    prefix=fwd[3], **kw),
                f"k1phi_phase_ts{ts}": lambda: raster._launch_fwd_phase(
                    pack, counts, ntx, amp, keep_ckpt=True,
                    tiles_per_image=ti, **kw),
                f"k2phi_phase_ts{ts}": lambda: raster._launch_bwd_phase(
                    pack, counts, ntx, amp, *pcots, ckpt=pf[3],
                    tiles_per_image=ti, **kw)}
            for name, fn in calls.items():
                res[name] = kernel_times(torch, fn)
    return res


def composite_times(torch, dev, cloud):
    """K7 / K8 on the decoded cloud in DENSE and SIMPLE mode at each of
    COMPOSITE_SIZES, through `_launch_fwd` / `_launch_bwd` (every version
    of the kernels takes them), the cotangents from a seed: device ms, call
    ms, bounds, and the sha256 of K7's outputs (the same between runs of
    one version)."""
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import dense_composite as dcomp
    from fresnel_tpu_torch.render.dense import dense_inputs
    from fresnel_tpu_torch.render.simplified import simplified_inputs

    res = {}
    for size in COMPOSITE_SIZES:
        cam = Camera.default_training(size).to(dev)
        with torch.no_grad():
            ins = {0: dense_inputs(*cloud, cam),
                   1: simplified_inputs(cloud[0], cloud[1], cloud[3],
                                        cloud[4], cam)}
        for mode, (p, c) in ins.items():
            p, c = p.contiguous(), c.contiguous()
            chunk = dcomp.CHUNK[mode]
            with torch.no_grad():
                out, trans, ck, aux = dcomp._launch_fwd(p, c, size, size,
                                                        mode, chunk)
            rng = np.random.default_rng(13)
            g_out = torch.from_numpy(rng.normal(size=(size, size, 4)).astype(
                np.float32)).to(dev)
            g_t = torch.from_numpy(rng.normal(size=(size, size)).astype(
                np.float32)).to(dev)
            if mode == 1:
                g_out[..., 3] = torch.where(torch.isinf(out[..., 3]), 0.0,
                                            g_out[..., 3])
            bounds, pairs = composite_bounds(torch, p, size, size, mode)
            sha = hashlib.sha256(out.cpu().numpy().tobytes()
                                 + trans.cpu().numpy().tobytes()).hexdigest()
            name = f"{'dense' if mode == 0 else 'simple'}_{size}"
            with torch.no_grad():
                res[f"k7_{name}"] = dict(
                    **kernel_times(torch, lambda: dcomp._launch_fwd(
                        p, c, size, size, mode, chunk), n=20),
                    bound_ms=bounds["k7"]["bound_ms"],
                    bound_by=bounds["k7"]["bound_by"],
                    output_sha256=sha[:16], **pairs)
                res[f"k8_{name}"] = dict(
                    **kernel_times(torch, lambda: dcomp._launch_bwd(
                        p, c, out, ck, aux, g_out, g_t, mode, chunk), n=20),
                    bound_ms=bounds["k8"]["bound_ms"],
                    bound_by=bounds["k8"]["bound_by"])
            del out, trans, ck, aux
    return res


def train_route_times(torch, dev, flags):
    """One training route's step, built as wave_phases builds it (a seeded
    corpus of WAVE_SCENES at 256^2, lpips off): ms per step (CUDA events
    around AB_TRAIN_STEPS steps after WAVE_WARMUP), host ms per step, and
    device ms, busy share and kernels per step (torch.profiler over
    WAVE_PROFILED steps)."""
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
    from fresnel_tpu_torch.train.harness import Trainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ab_train_")
    try:
        data_dir = os.path.join(tmp, "corpus")
        synthetic_corpus.generate_corpus(data_dir, n_images=WAVE_SCENES,
                                         image_size=256, seed=0)
        cfg, phys, hfgs, hfts = tcli.configs_from_args(
            tcli.build_parser().parse_args(
                ["--output_dir", os.path.join(tmp, "cfg")] + flags))
        cfg = dataclasses.replace(cfg, lpips_weight=0.0)
        tr = Trainer(cfg, phys, hfgs, hfts, device=dev)
        state = tr.init_state()
        ds = ImageDataset(data_dir, image_size=256, feature_dim=384,
                          use_augmentation="--no_augmentation" not in flags,
                          device=dev)
        batches = [tr.device_batch(b) for b in train_batches(
            ds, cfg.batch_size, WAVE_WARMUP + AB_TRAIN_STEPS)]
        gen = torch.Generator(device=dev).manual_seed(1)
        K = cfg.gaussians_per_patch
        for b in batches[:WAVE_WARMUP]:
            state, _ = tr.train_step(state, b, K, None, gen)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        start.record()
        for b in batches[WAVE_WARMUP:]:
            state, _ = tr.train_step(state, b, K, None, gen)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0

        def profiled():
            st_ = state
            for b in batches[-WAVE_PROFILED:]:
                st_, _ = tr.train_step(st_, b, K, None, gen)
        prof = profile_ms(torch, profiled, WAVE_PROFILED, top=5, cpu=False)
        return dict(flags=flags, steps=AB_TRAIN_STEPS,
                    ms_per_step=start.elapsed_time(end) / AB_TRAIN_STEPS,
                    host_ms_per_step=host_s * 1e3 / AB_TRAIN_STEPS,
                    device_ms_per_step=prof["device_ms"],
                    device_busy_share=prof["device_busy_share"],
                    kernels_per_step=prof["kernels"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ab(roots):
    """The --ab mode: ab_measure of each root in a process of its own, in
    the order given; one JSON line per root."""
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--ab-measure", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            fail(f"{root}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab-measure"] and len(sys.argv) == 3:
        print(json.dumps(ab_measure(sys.argv[2])), flush=True)
    elif sys.argv[1:2] == ["--ab"] and len(sys.argv) > 2:
        ab(sys.argv[2:])
    elif len(sys.argv) > 1:
        raise SystemExit(__doc__)
    else:
        main()
