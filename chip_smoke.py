#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's image->3DGS path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:
  1. device     the card, torch and CUDA versions (CUDA must be present);
  2. build      compile the compositing kernel from
                fresnel_tpu_torch/csrc/ into build/ (nvcc, sm_90a);
  3. kernel     the kernel against its plain PyTorch version on the card at
                the main path's shapes (the pack of a decoded 5 476-Gaussian
                cloud, T = 1024 tiles, M = 256), max abs error <= 1e-5, and
                the median time of each over >= 20 launches (CUDA events);
  4. main_path  fresnel_tpu_torch.pipeline.image_to_3dgs at full width
                (ViT-S/14 x 2 at 518^2 in bf16, decoder K = 4, 512^2 render)
                over 8 distinct images after warmup, with the kernel's launch
                count reset just before and read just after;
  5. stages     the median ms of each stage of that path (CUDA events);
  6. reference  the same path in float32 on the card and on the CPU, same
                weights and image: positions within 1e-4, image within a
                mean absolute error of 1e-4;
  7. profile    torch.profiler over 4 calls of the main path: device time
                per image, the device's busy share and the top kernels.
Then the card's name and power limit as nvidia-smi gives them, the kernel
table as one JSON line, and as the last line
{"ok": true, "device": {...}}.

Imports torch, numpy and fresnel_tpu_torch only.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_IMAGES = 8
N_TIMED = 30
KERNEL_TOL = 1e-5
REF_POS_TOL = 1e-4
REF_IMG_MEAN_TOL = 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# One pixel-Gaussian evaluation: offsets, quadratic form, box test, alpha,
# weights, four sums and the transmittance update (~20 FLOP) and one exp.
OPS_PER_EVAL = 21
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    sys.path.insert(0, HERE)
    from fresnel_tpu_torch import pipeline
    from fresnel_tpu_torch.core.camera import Camera
    from fresnel_tpu_torch.render import raster, tile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
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

    # 2. build
    t0 = time.perf_counter()
    lib_path, build_log = raster.build()
    log("build", seconds=time.perf_counter() - t0,
        library=os.path.relpath(lib_path, HERE), ptxas=build_log.strip())

    # 3. kernel, at the main path's shapes
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
    got = raster.composite_tiles_packed(pack, counts, tp.n_tiles_x)
    ref = raster.composite_tiles_plain(pack, counts, tp.n_tiles_x)
    torch.cuda.synchronize()
    errs = {name: (g - r).abs().max().item()
            for name, g, r in zip(("color", "depth", "transmittance"),
                                  got, ref)}
    max_err = max(errs.values())
    kernel_ms = cuda_median_ms(
        torch, lambda: raster.composite_tiles_packed(pack, counts,
                                                     tp.n_tiles_x))
    plain_ms = cuda_median_ms(
        torch, lambda: raster.composite_tiles_plain(pack, counts,
                                                    tp.n_tiles_x))
    occupied = int(counts.sum().item())
    totals = tile._tile_totals(tp.means2d, tp.radii, tp.visible,
                               tp.n_tiles_x, tp.n_tiles_y, 16)
    bytes_moved = occupied * PACK_BYTES + T * 4 + T * raster.PIX * 5 * 4
    ops = occupied * raster.PIX * OPS_PER_EVAL
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log("kernel", name="raster_fwd", T=T, M=M, n_gaussians=int(args[0].shape[0]),
        max_abs_err=errs, tol=KERNEL_TOL, ms=kernel_ms, plain_ms=plain_ms,
        occupied_slots=occupied, counts_mean=occupied / T,
        counts_max=int(counts.max().item()),
        tiles_at_cap=int((counts == M).sum().item()),
        total_pairs=int(totals.sum().item()),
        dropped_pairs=int(torch.clamp(totals - M, min=0).sum().item()),
        bytes=bytes_moved, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    if not max_err <= KERNEL_TOL:
        fail(f"kernel disagrees with its plain version: {errs}")

    # 4. main path, through the entry point a user calls
    for img in images[:2]:                                   # warmup
        pipeline.image_to_3dgs(models, img, camera, device=dev)
    torch.cuda.synchronize()
    raster.launches = 0
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
    launches = raster.launches
    e2e = [s.elapsed_time(e) for s, e in events]
    for pos, img in outs:
        if tuple(pos.shape) != (1, 5476, 3) or not torch.isfinite(pos).all():
            fail(f"bad positions {tuple(pos.shape)}")
        if tuple(img.shape) != (3, 512, 512) or not torch.isfinite(img).all() \
                or img.min().item() < 0.0 or img.max().item() > 1.0:
            fail(f"bad image {tuple(img.shape)}")
    if launches != len(images):
        fail(f"kernel launched {launches} times in {len(images)} calls")
    log("main_path", images=len(images), launches=launches,
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
    cpu = torch.device("cpu")
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

    # 7. profile: the device's busy share over the main path
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 4
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img in images[:n_prof]:
            pipeline.image_to_3dgs(models, img, camera, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log("profile", images=n_prof, wall_ms_per_image=wall_ms / n_prof,
        device_ms_per_image=device_ms / n_prof,
        device_busy_share=device_ms / wall_ms if device_ms else None,
        kernels_per_image=sum(e.count for e in kernels) / n_prof,
        top_kernels_ms_per_image={
            e.key[:80]: e.self_device_time_total / 1e3 / n_prof for e in top})

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "raster_fwd", "route": "cuda",
        "source": "fresnel_tpu_torch/csrc/raster_fwd.cu",
        "replaces": "fresnel_tpu/render/pallas_raster.py:135",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
