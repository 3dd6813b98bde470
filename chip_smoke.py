#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab ROOT [ROOT ...]

Four main paths run through the entry points a user calls:
`pipeline.image_to_3dgs` (image -> 3DGS, bench.py's path),
`train.fit_teacher.fit_scene` (`fresnel refine`: per-scene Adam fit through
the rasterizer), `render.tile.render_tiled` / `cli.render` / `cli.orbit`
on a cloud of a million Gaussians (`fresnel render` and `orbit`), and
decoder training, `train.harness.Trainer` and its CLI
(`fresnel-torch train`), at the flagship trained model's config.  Phases,
each printing one JSON line; any failure raises and the script exits
non-zero:
   1. device      the card, torch and CUDA versions (CUDA must be present);
   2. build       compile the four kernels from fresnel_tpu_torch/csrc/
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
                  load_checkpoint bit for bit, encode (8, 37, 37, 384).
Then the card's name and power limit as nvidia-smi gives them, the kernel
table as one JSON line, and as the last line {"ok": true, "device": {...}}.

With `--ab`, each ROOT is a checkout of this repository (a parent commit
unpacked with `git archive` into a git-ignored directory, or `.`), given
in turns (`.archive/parent . . .archive/parent`) so that drift on the card
shows.  For each root in order, a subprocess imports that checkout's
`fresnel_tpu_torch` (building its four kernels into its `build/`),
builds this script's image, refine and render packs with it, and times
through the functions every version has: K1 at all three, K2 with
cotangents from a seed and K1 + K2 through autograd (a refine step's pair)
at the refine and render packs; K3 (`build_rank_table`), K4
(`bin_gaussians_stream`) and K4's launch alone (`_launch`) on the render
path's million depth-sorted Gaussians.  Each as `ms` on the device,
`call_ms` per call and the device ms of each kernel by name
(torch.profiler), with ptxas's registers and spills of all four kernels;
and the refine step at full width (`fit_scene`: ms per step over 20
steps, device ms per step and top kernels over 5); one JSON line per
root.

Imports torch, numpy and fresnel_tpu_torch only.
"""

import dataclasses
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


def profile_ms(torch, fn, n, top=8):
    """torch.profiler over fn(): wall ms, device ms, kernels and the `top`
    kernels by device time, each per unit of n."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    raster.launches = raster.launches_bwd = 0
    binning.launches = stream_binning.launches = 0


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


def pack_stats(torch, raster, pack, counts, ntx, tiles_per_image=None):
    """A pack's count distribution, the (tile, segment) units K1 and K2 run
    for it (the segment length L they choose, the units, the blocks
    launched, the tiles that need a fold, the heaviest unit's slots, the
    scratch bytes) and the pixel-slot pairs inside the slots' boxes (the
    rest K1 skips, and K2 where a whole warp is outside)."""
    T, M = pack.shape[:2]
    ti = T if tiles_per_image is None else tiles_per_image
    resident = raster.resident_blocks(pack.device.index)
    L = raster.segment_length(counts, M, resident)
    c = counts.long()
    pix = torch.arange(raster.PIX, device=pack.device)
    pairs_in = warps_in = 0
    for t0 in range(0, T, 64):
        t = torch.arange(t0, min(T, t0 + 64),
                         device=pack.device)[:, None] % ti
        g = pack[t0:t0 + 64]
        r = g[..., 5, None]
        px = (t % ntx * 16 + pix % 16).float()[:, None, :]
        py = (t // ntx * 16 + pix // 16).float()[:, None, :]
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
                scratch_bytes=(math.prod(raster.scratch_shape(T, M)) * 4
                               + T * 4),
                box_pixel_pairs=pairs_in,
                box_pixel_share=pairs_in / (occupied * raster.PIX),
                box_warp_share=warps_in / (occupied * raster.PIX // 32))


def compositing_bounds(stats, T, M, occupied):
    """The bounds of K1 and K2 on a pack: the bytes the function moves and
    the operations it does on the pixel-slot pairs inside the slots' boxes
    (plus each slot's box), beside the count over all pairs
    (`all_pairs_ops`: every pair, as if no term were 0)."""
    box_ops = occupied * OPS_PER_SLOT_BOX
    out = {}
    for name, per_pair, bytes_moved in (
            ("k1", OPS_PER_EVAL,
             occupied * PACK_BYTES + T * 4 + T * PIX_F * 5 * 4),
            ("k2", OPS_PER_EVAL_BWD,
             occupied * PACK_BYTES + T * 4 + T * PIX_F * 10 * 4
             + T * M * PACK_BYTES)):
        ms, by, work = bound(bytes_moved,
                             stats["box_pixel_pairs"] * per_pair + box_ops)
        all_pairs = occupied * PIX_F * per_pair
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


def train_setup(torch, dev, cfg_kw, tmp, dropout=None):
    """A Trainer of config `cfg_kw` on `dev` (decoder dropout 0 when
    `dropout` is 0) and its init state with depth_offset_init applied."""
    from fresnel_tpu_torch.train import config as tconfig
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder

    cfg = tconfig.TrainingConfig(output_dir=tmp, **cfg_kw)
    trainer = Trainer(cfg, tconfig.PhysicsConfig(),
                      tconfig.HFGSConfig(**TRAIN_HFGS), tconfig.HFTSConfig(),
                      device=dev)
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

    # 2. build, all four kernels at once
    counters = (raster, binning, stream_binning)
    t0 = time.perf_counter()
    built = _build.build()
    log("build", seconds=time.perf_counter() - t0,
        libraries={k: os.path.relpath(p, HERE) for k, (p, _) in built.items()},
        ptxas={k: [ln.strip() for ln in out.splitlines()
                   if "registers" in ln or "spill" in ln]
               for k, (_, out) in built.items()})

    # 3. kernel (K1), at the image->3DGS path's shapes
    rng = np.random.default_rng(0)
    images = [torch.from_numpy(rng.uniform(size=(512, 512, 3)).astype(
        np.float32)).to(dev) for _ in range(N_IMAGES)]
    camera = Camera.default_training(pipeline.RENDER_SIZE)
    models = pipeline.build_models(seed=0, device=dev)
    tp, n_decoded = decoded_pack(torch, models, images[0])
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

    print(smi, flush=True)

    def entry(key, name, replaces, numbers):
        return {"name": name, "route": "cuda",
                "source": f"fresnel_tpu_torch/csrc/{name}.cu",
                "replaces": replaces,
                "launches": sum(v[key] for v in path_launches.values()),
                "launches_by_path": {p: v[key]
                                     for p, v in path_launches.items()},
                **numbers, "library_ms": None}

    print(json.dumps({"kernels": [
        entry("k1", "raster_fwd", "fresnel_tpu/render/pallas_raster.py:135",
              k1),
        entry("k2", "raster_bwd", "fresnel_tpu/render/pallas_raster.py:179",
              k2),
        entry("k3", "bin_table", "fresnel_tpu/render/pallas_binning.py:44",
              k3),
        entry("k4", "bin_stream",
              "fresnel_tpu/render/pallas_stream_binning.py:56", k4)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def ab_measure(root):
    """The four kernels of the checkout at `root`: K1 and K2 on this
    script's image, refine and render packs, K3 and K4 on the render
    path's million depth-sorted Gaussians (T = 1024, M = 256); a dict of
    device ms, call ms and device ms by kernel name (the --ab mode)."""
    import torch

    sys.path.insert(0, os.path.abspath(root))
    from fresnel_tpu_torch import _build, pipeline
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import binning, raster, stream_binning, tile
    from fresnel_tpu_torch.train import fit_teacher

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    built = _build.build(["raster_fwd", "raster_bwd", "bin_table",
                          "bin_stream"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    image = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(512, 512, 3)).astype(np.float32)).to(dev)
    models = pipeline.build_models(seed=0, device=dev)
    packs = dict(image=decoded_pack(torch, models, image)[0])
    del models
    scene, depth, *_, packs["refine"] = refine_init(torch, dev)
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
            prof = profile_ms(torch, lambda: [fn() for _ in range(10)], 10)
            result["kernels"][f"{kernel}_{name}"] = dict(
                **kernel_times(torch, fn),
                occupied_slots=int(counts.sum().item()),
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
    # The refine step at full width: fit_scene's ms per step (CUDA events
    # around one call of 20 steps, after a warmup call) and its device ms
    # per step (torch.profiler over 5 steps).
    del packs, sp, iv, bounds, sorted_in
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
    return result


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
