#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Two main paths run through the entry points a user calls:
`pipeline.image_to_3dgs` (image -> 3DGS, bench.py's path) and
`train.fit_teacher.fit_scene` (`fresnel refine`: per-scene Adam fit through
the rasterizer).  Phases, each printing one JSON line; any failure raises
and the script exits non-zero:
   1. device      the card, torch and CUDA versions (CUDA must be present);
   2. build       compile both compositing kernels from
                  fresnel_tpu_torch/csrc/ into build/ (one nvcc each, run
                  together, sm_90a), with ptxas's registers, shared memory
                  and spills;
   3. kernel      K1 against its plain PyTorch version at the image->3DGS
                  path's shapes (the pack of a decoded 5 476-Gaussian cloud,
                  T = 1024 tiles, M = 256), max abs error <= 1e-5, and the
                  median time of each over >= 20 launches (CUDA events);
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
                  largest plain value; K1 on that pack too, max abs error
                  <= 1e-5; median times; occupancy; bound;
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
  13. refine_profile  torch.profiler over 5 refine steps.
Then the card's name and power limit as nvidia-smi gives them, the kernel
table as one JSON line, and as the last line {"ok": true, "device": {...}}.

Imports torch, numpy and fresnel_tpu_torch only.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 8
N_TIMED = 30
KERNEL_TOL = 1e-5
# K2 per field, relative to the field's largest plain value: the kernel and
# the plain version differ in summation order only (sequential suffix sums
# and a shuffle tree against cumsum and torch.sum), in float32.
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
REFINE = dict(grid=37, K=4, res=256, max_per_tile=1024, lr=1e-2,
              depth_offset_init=-0.13)
REFINE_STEPS = 100
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# One pixel-Gaussian evaluation in K1: offsets, quadratic form, box test,
# alpha, weights, four sums and the transmittance update (~20 FLOP) and one
# exp.
OPS_PER_EVAL = 21
# One pixel-slot evaluation in K2 (counted from csrc/raster_bwd.cu): K1's
# alpha (~17), the weight and four suffix updates (9), the clamp and
# reciprocal (3), dalpha (~23 with its gate), the chain into ten gradient
# terms (~26), the transmittance update (2) and ten adds of the reduction
# over the tile's pixels (10).
OPS_PER_EVAL_BWD = 90
PACK_BYTES = 12 * 4


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


def profile_ms(torch, fn, n):
    """torch.profiler over fn(): wall ms, device ms, kernels and the top
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_ms / n, device_ms=device_ms / n,
                device_busy_share=device_ms / wall_ms if device_ms else None,
                kernels=sum(e.count for e in kernels) / n,
                top_kernels_ms=dict(top))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, HERE)
    from fresnel_tpu_torch import cli, pipeline
    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.models.decoders import head_transform
    from fresnel_tpu_torch.models.encoders import gradient_depth_estimate
    from fresnel_tpu_torch.render import raster, tile
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

    # 2. build, both kernels at once
    t0 = time.perf_counter()
    built = raster.build()
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
    with torch.no_grad():
        x = pipeline.resize_to_model(images[0])
        out = models.decoder(models.dino(x), models.depth(x))
        args = [out[k][0] for k in
                ("positions", "scales", "rotations", "colors", "opacities")]
        tp = tile.pack_tiles(*args, camera)
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
        kernel_ms = cuda_median_ms(
            torch, lambda: raster.composite_tiles_packed(pack, counts,
                                                         tp.n_tiles_x))
        plain_ms = cuda_median_ms(
            torch, lambda: raster.composite_tiles_plain(pack, counts,
                                                        tp.n_tiles_x))
    occupied = int(counts.sum().item())
    totals = tile._tile_totals(tp.means2d, tp.radii, tp.visible,
                               tp.n_tiles_x, tp.n_tiles_y, 16)
    bound_ms, bound_by, work = bound(
        occupied * PACK_BYTES + T * 4 + T * raster.PIX * 5 * 4,
        occupied * raster.PIX * OPS_PER_EVAL)
    log("kernel", name="raster_fwd", T=T, M=M, n_gaussians=int(args[0].shape[0]),
        max_abs_err=errs, tol=KERNEL_TOL, ms=kernel_ms, plain_ms=plain_ms,
        occupied_slots=occupied, counts_mean=occupied / T,
        counts_max=int(counts.max().item()),
        tiles_at_cap=int((counts == M).sum().item()),
        total_pairs=int(totals.sum().item()),
        dropped_pairs=int(torch.clamp(totals - M, min=0).sum().item()),
        **work, bound_ms=bound_ms, bound_by=bound_by)
    if not max_err <= KERNEL_TOL:
        fail(f"kernel disagrees with its plain version: {errs}")
    k1 = dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
              bound_ms=bound_ms, bound_by=bound_by)

    # 4. main path, through the entry point a user calls
    for img in images[:2]:                                   # warmup
        pipeline.image_to_3dgs(models, img, camera, device=dev)
    torch.cuda.synchronize()
    raster.launches = raster.launches_bwd = 0
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
    path_launches = {"image_to_3dgs": (raster.launches, raster.launches_bwd)}
    e2e = [s.elapsed_time(e) for s, e in events]
    for pos, img in outs:
        if tuple(pos.shape) != (1, 5476, 3) or not torch.isfinite(pos).all():
            fail(f"bad positions {tuple(pos.shape)}")
        if tuple(img.shape) != (3, 512, 512) or not torch.isfinite(img).all() \
                or img.min().item() < 0.0 or img.max().item() > 1.0:
            fail(f"bad image {tuple(img.shape)}")
    if path_launches["image_to_3dgs"] != (len(images), 0):
        fail(f"kernels launched {path_launches['image_to_3dgs']} times in "
             f"{len(images)} calls")
    log("main_path", images=len(images),
        launches=path_launches["image_to_3dgs"][0],
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
    scene = smooth_image(REFINE["res"], 0)
    depth = gradient_depth_estimate(
        torch.from_numpy(scene.transpose(1, 2, 0).copy()).to(dev),
        REFINE["res"]).cpu().numpy()
    cam_r = Camera.default_training(REFINE["res"])
    cfg_r = tile.TileRendererConfig(max_per_tile=REFINE["max_per_tile"])
    raw0 = fit_teacher.init_raw(scene, depth, cam_r, grid=REFINE["grid"],
                                K=REFINE["K"])
    with torch.no_grad():
        hout = head_transform(torch.from_numpy(raw0).to(dev),
                              torch.from_numpy(depth).to(dev)[None],
                              torch.tensor(REFINE["depth_offset_init"],
                                           device=dev))
        tp = tile.pack_tiles(*[hout[k][0] for k in (
            "positions", "scales", "rotations", "colors", "opacities")],
            cam_r.to(dev), cfg_r)
        pack, counts = tp.pack, tp.counts
        T, M, _ = pack.shape
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
        fields = ("mx", "my", "ca", "cb", "cc", "radius", "R", "G", "B",
                  "opacity", "depth", "pad")
        scale = {f: ref[..., i].abs().max().item()
                 for i, f in enumerate(fields)}
        ferr = {f: (got[..., i] - ref[..., i]).abs().max().item()
                for i, f in enumerate(fields)}
        rel = {f: ferr[f] / scale[f] if scale[f] else ferr[f] for f in fields}
        bwd_ms = cuda_median_ms(torch, lambda: raster.composite_tiles_bwd(
            pack, counts, tp.n_tiles_x, *fwd, *cots))
        bwd_plain_ms = cuda_median_ms(
            torch, lambda: raster.composite_tiles_bwd_plain(
                pack, counts, tp.n_tiles_x, *fwd, *cots), n=10)
        fwd_ms_refine = cuda_median_ms(
            torch, lambda: raster.composite_tiles_packed(pack, counts,
                                                         tp.n_tiles_x))
        fwd_plain_ms_refine = cuda_median_ms(
            torch, lambda: raster.composite_tiles_plain(pack, counts,
                                                        tp.n_tiles_x), n=10)
    occupied = int(counts.sum().item())
    bwd_bound_ms, bwd_bound_by, bwd_work = bound(
        occupied * PACK_BYTES + T * 4 + T * raster.PIX * 10 * 4
        + T * M * PACK_BYTES,
        occupied * raster.PIX * OPS_PER_EVAL_BWD)
    fwd_bound_refine, _, _ = bound(
        occupied * PACK_BYTES + T * 4 + T * raster.PIX * 5 * 4,
        occupied * raster.PIX * OPS_PER_EVAL)
    log("kernel_bwd", name="raster_bwd", T=T, M=M, n_gaussians=raw0.size // 16,
        max_abs_err=ferr, field_scale=scale, rel_err=rel,
        tol=KERNEL_BWD_TOL, repeat_bitwise_equal=bool(torch.equal(got, again)),
        ms=bwd_ms, plain_ms=bwd_plain_ms,
        occupied_slots=occupied, counts_mean=occupied / T,
        counts_max=int(counts.max().item()),
        tiles_at_cap=int((counts == M).sum().item()),
        **bwd_work, bound_ms=bwd_bound_ms, bound_by=bwd_bound_by,
        k1_at_refine_shapes=dict(max_abs_err=fwd_errs, tol=KERNEL_TOL,
                                 ms=fwd_ms_refine,
                                 plain_ms=fwd_plain_ms_refine,
                                 bound_ms=fwd_bound_refine))
    if not max(fwd_errs.values()) <= KERNEL_TOL:
        fail(f"K1 disagrees with its plain version at the refine shapes: "
             f"{fwd_errs}")
    if not max(rel.values()) <= KERNEL_BWD_TOL:
        fail(f"K2 disagrees with its plain version: {rel}")
    k1["max_abs_err"] = max(k1["max_abs_err"], max(fwd_errs.values()))
    k2 = dict(max_abs_err=max(ferr.values()), ms=bwd_ms,
              plain_ms=bwd_plain_ms, bound_ms=bwd_bound_ms,
              bound_by=bwd_bound_by)

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
    raster.launches = raster.launches_bwd = 0
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    start.record()
    teacher, metrics = fit_teacher.fit_scene(scene, depth,
                                             steps=REFINE_STEPS, **fit_kw)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    path_launches["refine"] = (raster.launches, raster.launches_bwd)
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
    if path_launches["refine"] != (REFINE_STEPS + 1, REFINE_STEPS):
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
        top_kernels_ms_per_step=prof["top_kernels_ms"])

    print(smi, flush=True)
    total = {p: sum(v[i] for v in path_launches.values())
             for i, p in enumerate(("k1", "k2"))}
    print(json.dumps({"kernels": [
        {"name": "raster_fwd", "route": "cuda",
         "source": "fresnel_tpu_torch/csrc/raster_fwd.cu",
         "replaces": "fresnel_tpu/render/pallas_raster.py:135",
         "launches": total["k1"],
         "launches_by_path": {p: v[0] for p, v in path_launches.items()},
         **k1, "library_ms": None},
        {"name": "raster_bwd", "route": "cuda",
         "source": "fresnel_tpu_torch/csrc/raster_bwd.cu",
         "replaces": "fresnel_tpu/render/pallas_raster.py:179",
         "launches": total["k2"],
         "launches_by_path": {p: v[1] for p, v in path_launches.items()},
         **k2, "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
