"""The CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU and nvcc; skips without them.  It imports no JAX, so
on a machine without JAX run it with `--noconftest`:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernels and plain versions differ only in summation order (sequential
transmittance and suffix sums within a segment and an in-order fold of the
segments, against the chunked cumprod / cumsum; a warp-shuffle tree
against torch's sum over pixels), all in float32: K1 at atol 1e-5, K2 per
field within BWD_TOL = 1e-4 of that field's largest plain value
(chip_smoke.py's bound).  K1 and K2 are held on count patterns around
the segment boundaries and on packs for which the kernels choose segments
of SEG, 2 SEG and 4 SEG slots, or whole tiles; K1's segment prefixes
against the plain forward of each tile's slots before the segment.  The
binning kernels K3 and K4 are integer functions and are held bit for bit.
K1 and K2 with the box test off (hard_cutoff=False), the phase-blending
pair K1-phi / K2-phi and the dense splat K5 / K6 (both modes) are held at
the same tolerances, K2-phi, K5 and K6 bit for bit from run to run;
K1-phi / K2-phi also on the edges of their per-warp cull (every tile at
the cap, boxes inside one warp strip or with edges on strip boundaries,
counts on and one past a checkpoint boundary, the box off with radian
phases).  The dense compositing pair K7 / K8 (both modes) at the same
tolerances, around their stages and back-walk runs, on lists of every
Gaussian and of none and where the transmittance underflows, with alpha
on its clip and SIMPLE's depth ties, K7 bit for bit from run to run;
the four renderers K5-K8 serve, the diffractive layers and the
quantised depth sorts, card against CPU; the
LPIPS distance and its gradients, ms_ssim and the matching loss, card
against CPU; the v2 decoders, the structure predictor and a render-loss
V2Trainer step (K1 twice, K2 once), card against CPU.  K1, K2, K1-phi and
K2-phi at tile sizes 1, 3, 4, 8, 12, 16, 24, 32 and 48 (the sizes other
than 16 take one runtime instantiation: pixel groups of at most 256 a
block, tail lanes that own no pixel) with the box on and off, on one
image and on two, against their plain versions at the same tolerances,
K1, K2 and K2-phi bit for bit from run to run; render_tiled at 8 and 32
with both table binnings, card against CPU.  parallel/ with two gloo ranks
on card 0: the mesh units and a small config's global-batch gradient
against one process.
"""

import numpy as np
import pytest
import torch

from fresnel_tpu_torch import _build
from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.gaussians import GaussianCloud
from fresnel_tpu_torch.render import binning
from fresnel_tpu_torch.render import raster
from fresnel_tpu_torch.render import stream_binning
from fresnel_tpu_torch.render import tile

pytestmark = pytest.mark.cuda
BWD_TOL = 1e-4
# K7 against its plain version, per output (colour, depth channel,
# transmittance) relative to its largest plain value: a sequential product
# against the chunked cumprod, over up to thousands of Gaussians.
COMPOSITE_TOL = 5e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pack(T, M, counts, seed, width):
    rng = np.random.default_rng(seed)
    pack = np.zeros((T, M, 12), np.float32)
    pack[..., 0] = rng.uniform(-8, width + 8, (T, M))
    pack[..., 1] = rng.uniform(-8, width + 8, (T, M))
    pack[..., 2] = rng.uniform(0.005, 0.1, (T, M))
    pack[..., 3] = rng.uniform(-0.004, 0.004, (T, M))
    pack[..., 4] = rng.uniform(0.005, 0.1, (T, M))
    pack[..., 5] = rng.uniform(2, 32, (T, M))
    pack[..., 6:9] = rng.uniform(0, 1, (T, M, 3))
    pack[..., 9] = rng.uniform(0, 1, (T, M))
    pack[..., 10] = rng.uniform(1, 4, (T, M))
    counts = np.asarray(counts, np.int32)
    dead = np.arange(M)[None, :] >= counts[:, None]
    pack[dead] = 0.0
    pack[dead, 5] = -1.0
    return torch.from_numpy(pack), torch.from_numpy(counts)


def _counts(pattern, T, M, seed):
    """Tile counts: random (with an empty tile and one at the cap), every
    tile at the cap, counts on both sides of each segment length, all
    empty, one slot, or one tile at the cap among empty ones."""
    if pattern == "random":
        counts = np.random.default_rng(seed).integers(0, M + 1, T)
        counts[0], counts[-1] = 0, M
        return counts
    if pattern == "cap":
        return np.full(T, M)
    if pattern == "around_seg":
        edges = [k * raster.SEG + d for k in (1, 2, 3) for d in (-1, 0, 1)]
        return np.minimum([edges[i % len(edges)] for i in range(T)], M)
    if pattern == "empty":
        return np.zeros(T, int)
    if pattern == "one_slot":
        return np.ones(T, int)
    if pattern == "heavy_among_empty":
        counts = np.zeros(T, int)
        counts[T // 3] = M
        return counts
    if pattern == "around_ckpt":
        edges = [k * raster.CKPT + d for k in (1, 2, 3, 15, 16) for d in (0, 1)]
        return np.minimum([edges[i % len(edges)] for i in range(T)], M)
    raise ValueError(pattern)


PATTERNS = ["cap", "around_seg", "empty", "one_slot", "heavy_among_empty"]
# Packs of M = 32 (render_tiled at N <= 32) and M = 96 (N = 70, the m_cap
# rounding to a multiple of the chunk): one segment, and a segment of 64
# with a partial one of 32 after it.
SMALL_M_CASES = [(16, 32, 4, "random"), (16, 32, 4, "cap"),
                 (64, 96, 8, "random"), (64, 96, 8, "cap"),
                 (64, 96, 8, "around_seg")]
# The pack of an experiment-4 cloud of 377 Gaussians at 256^2: M 384 (the
# m_cap rounding), six segments of 64.
EXP4_CASES = [(256, 384, 16, "random"), (256, 384, 16, "cap"),
              (256, 384, 16, "around_seg")]
FWD_CASES = ([(6, 64, 3, "random"), (64, 256, 8, "random"),
              (1024, 256, 32, "random"), (1024, 256, 32, "cap"),
              (256, 1024, 16, "random"), (256, 1024, 16, "cap")]
             + [(64, 256, 8, p) for p in PATTERNS] + SMALL_M_CASES
             + EXP4_CASES)


@pytest.mark.parametrize("T,M,ntx,pattern", FWD_CASES)
def test_kernel_matches_plain(cuda, T, M, ntx, pattern):
    pack, cnt = _pack(T, M, _counts(pattern, T, M, T), T, ntx * 16)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    before = raster.launches
    got = raster.composite_tiles_packed(pack, cnt, ntx)
    torch.cuda.synchronize()
    assert raster.launches == before + 1
    ref = raster.composite_tiles_plain(pack, cnt, ntx)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.is_cuda
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    outs = raster._launch_fwd(pack, cnt, ntx, keep_prefix=True)
    for g, r in zip(outs[:3], ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    _assert_prefixes(pack, cnt, ntx, outs[3])


def _length(cnt, M):
    return raster.segment_length(cnt, M, raster.resident_blocks(
        cnt.device.index))


def _assert_prefixes(pack, cnt, ntx, part):
    """Segment k >= 1 of a tile split into more than one holds the plain
    forward of the tile's first k * L slots: (R, G, B, depth, T_in)."""
    T, M, _ = pack.shape
    assert tuple(part.shape) == raster.scratch_shape(T, M)
    L = _length(cnt, M)
    n_seg = (cnt.long() + L - 1) // L
    for k in range(1, -(-M // L)):
        tiles = torch.nonzero(n_seg > k).flatten()
        if not len(tiles):
            continue
        c, d, t = raster.composite_tiles_plain(
            pack[:, :k * L].contiguous(), cnt.clamp(max=k * L), ntx)
        want = torch.cat([c, d[..., None], t[..., None]], -1)[tiles]
        got = part[k, tiles].transpose(1, 2)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_wrapper_rejects_bad_inputs(cuda):
    pack, cnt = _pack(4, 32, [1, 2, 3, 4], 0, 32)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    with pytest.raises(TypeError):
        raster.composite_tiles_packed(pack.double(), cnt, 2)
    with pytest.raises(ValueError):
        raster.composite_tiles_packed(pack[:, ::2], cnt, 2)
    with pytest.raises(ValueError):
        raster.composite_tiles_packed(pack, cnt.long(), 2)


@pytest.mark.parametrize("n,res", [(300, 64), (5000, 256), (20, 32),
                                   (70, 48)])
def test_render_on_card_matches_cpu(cuda, n, res):
    rng = np.random.default_rng(n)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pos[:, 2] -= 2.0
    args = [torch.from_numpy(a) for a in (
        pos, np.full((n, 3), 0.05, np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(size=(n, 3)).astype(np.float32),
        rng.uniform(0.2, 1.0, size=n).astype(np.float32))]
    cam = Camera.default_training(res)
    before = raster.launches
    img_gpu = tile.render_tiled(*[a.to(cuda) for a in args], cam)
    torch.cuda.synchronize()
    assert raster.launches == before + 1
    img_cpu = tile.render_tiled(*args, cam)
    # Projection rounds differently on the card; a Gaussian on a tile or
    # box edge may flip, so the image is held on average.
    err = (img_gpu.cpu() - img_cpu).abs()
    assert err.mean().item() <= 1e-5, err.mean().item()


def _cots(T, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
            for s in ((T, 256, 3), (T, 256), (T, 256))]


def _assert_fields_close(got, ref):
    for f in range(12):
        scale = ref[..., f].abs().max().item()
        err = (got[..., f] - ref[..., f]).abs().max().item()
        assert err <= BWD_TOL * max(scale, 1e-30), (f, err, scale)


BWD_CASES = ([(6, 64, 3, "random"), (64, 256, 8, "random"),
              (1024, 256, 32, "random"), (1024, 256, 32, "cap"),
              (256, 1024, 16, "random"), (256, 1024, 16, "cap")]
             + [(64, 256, 8, p) for p in PATTERNS] + SMALL_M_CASES
             + EXP4_CASES)


@pytest.mark.parametrize("T,M,ntx,pattern", BWD_CASES)
def test_bwd_kernel_matches_plain(cuda, T, M, ntx, pattern):
    pack, cnt = _pack(T, M, _counts(pattern, T, M, T + 1), T, ntx * 16)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    outs = raster.composite_tiles_plain(pack, cnt, ntx)
    cots = _cots(T, M, cuda)
    before = raster.launches_bwd
    got = raster.composite_tiles_bwd(pack, cnt, ntx, *outs, *cots)
    again = raster.composite_tiles_bwd(pack, cnt, ntx, *outs, *cots)
    torch.cuda.synchronize()
    assert raster.launches_bwd == before + 2
    assert torch.equal(got, again)          # no atomics: run to run equal
    ref = raster.composite_tiles_bwd_plain(pack, cnt, ntx, *outs, *cots)
    _assert_fields_close(got, ref)
    dead = torch.arange(M, device=cuda)[None, :] >= cnt[:, None]
    assert torch.all(got[dead] == 0) and torch.all(got[..., [5, 11]] == 0)
    # K2 alone recomputes the segment prefixes; handed K1's, it gives the
    # same bits.
    fwd = raster._launch_fwd(pack, cnt, ntx, keep_prefix=True)
    alone = raster._launch_bwd(pack, cnt, ntx, *fwd[:3], *cots)
    handed = raster._launch_bwd(pack, cnt, ntx, *fwd[:3], *cots,
                                prefix=fwd[3])
    assert torch.equal(alone, handed)
    _assert_fields_close(alone, raster.composite_tiles_bwd_plain(
        pack, cnt, ntx, *fwd[:3], *cots))


# Packs of several images, as the training step's (B * T, M, 12) pack:
# (T, M, n_tiles_x, tiles_per_image, pattern).  A tile's pixel coordinates
# restart with each image.
BATCHED_CASES = [(512, 1024, 16, 256, "random"), (128, 256, 8, 32, "random"),
                 (64, 96, 4, 16, "cap")]


@pytest.mark.parametrize("T,M,ntx,ti,pattern", BATCHED_CASES)
def test_batched_kernels_match_plain(cuda, T, M, ntx, ti, pattern):
    """K1 and K2 over T // ti images, one launch each, against their plain
    versions with the same tiles_per_image: K1 within 1e-5, K2 within 1e-4
    of each field's largest plain value."""
    pack, cnt = _pack(T, M, _counts(pattern, T, M, T + 2), T + 2, ntx * 16)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    f0, b0 = raster.launches, raster.launches_bwd
    got = raster.composite_tiles_packed(pack, cnt, ntx, tiles_per_image=ti)
    ref = raster.composite_tiles_plain(pack, cnt, ntx, tiles_per_image=ti)
    # The images after the first are placed apart from one image's grid.
    one = raster.composite_tiles_plain(pack, cnt, ntx)
    assert not torch.equal(ref[0], one[0])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    cots = _cots(T, M, cuda)
    grad = raster.composite_tiles_bwd(pack, cnt, ntx, *ref, *cots,
                                      tiles_per_image=ti)
    torch.cuda.synchronize()
    assert (raster.launches - f0, raster.launches_bwd - b0) == (1, 1)
    _assert_fields_close(grad, raster.composite_tiles_bwd_plain(
        pack, cnt, ntx, *ref, *cots, tiles_per_image=ti))


@pytest.mark.parametrize("pattern", ["random", "cap"])
def test_kernels_repeat_bitwise(cuda, pattern):
    """Two launches of K1, and of K2 by both routes, on the same inputs
    give the same bits: every merge and every sum has a fixed order."""
    T, M, ntx = 256, 1024, 16
    pack, cnt = _pack(T, M, _counts(pattern, T, M, 3), 3, ntx * 16)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    cots = _cots(T, 4, cuda)
    first = raster._launch_fwd(pack, cnt, ntx, keep_prefix=True)
    second = raster._launch_fwd(pack, cnt, ntx, keep_prefix=True)
    assert all(torch.equal(a, b) for a, b in zip(first[:3], second[:3]))
    # The scratch rows that hold prefixes: segments of tiles that have more
    # than one (the rest is never written).
    part, part2 = first[3], second[3]
    L = _length(cnt, M)
    n_seg = (cnt.long() + L - 1) // L
    held = (torch.arange(part.shape[0], device=cuda)[:, None]
            < torch.where(n_seg > 1, n_seg, 0)[None, :])
    assert torch.equal(part[held], part2[held])
    grads = [raster._launch_bwd(pack, cnt, ntx, *first[:3], *cots,
                                prefix=prefix)
             for prefix in (None, None, first[3], second[3])]
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    p = pack.clone().requires_grad_()
    outs = raster.composite_tiles_packed(p, cnt, ntx)
    sum((o * c).sum() for o, c in zip(outs, cots)).backward()
    assert torch.equal(p.grad, grads[0])


def test_bwd_rejects_prefix_of_another_shape(cuda):
    pack, cnt = _pack(8, 256, _counts("cap", 8, 256, 0), 0, 64)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    fwd = raster._launch_fwd(pack, cnt, 4, keep_prefix=True)
    cots = _cots(4, 0, cuda)
    with pytest.raises(ValueError, match="prefix"):
        raster._launch_bwd(pack[:4].contiguous(), cnt[:4].contiguous(), 4,
                           *(o[:4].contiguous() for o in fwd[:3]), *cots,
                           prefix=fwd[3])


def test_bwd_wrapper_rejects_bad_inputs(cuda):
    pack, cnt = _pack(4, 32, [1, 2, 3, 4], 0, 32)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    outs = raster.composite_tiles_plain(pack, cnt, 2)
    cots = _cots(4, 0, cuda)
    with pytest.raises(TypeError):
        raster.composite_tiles_bwd(pack, cnt, 2, outs[0].double(), *outs[1:],
                                   *cots)
    with pytest.raises(ValueError):
        raster.composite_tiles_bwd(pack, cnt, 2, *outs, cots[0][:2], *cots[1:])
    with pytest.raises(ValueError):
        raster.composite_tiles_bwd(pack, cnt, 2, *outs, cots[0].cpu(),
                                   *cots[1:])


def test_function_on_card_matches_cpu(cuda):
    T, M, ntx = 64, 256, 8
    rng = np.random.default_rng(5)
    pack, cnt = _pack(T, M, rng.integers(0, M + 1, T), 5, ntx * 16)
    cots = _cots(T, 6, "cpu")
    grads = []
    for dev in ("cpu", cuda):
        p = pack.detach().to(dev).clone().requires_grad_()
        outs = raster.composite_tiles_packed(p, cnt.to(dev), ntx)
        sum((o * c.to(dev)).sum() for o, c in zip(outs, cots)).backward()
        grads.append(p.grad.cpu())
    _assert_fields_close(grads[1], grads[0])


def test_second_derivative_raises_on_card(cuda):
    pack, cnt = _pack(4, 32, [32, 9, 0, 20], 7, 32)
    p = pack.to(cuda).requires_grad_()
    outs = raster.composite_tiles_packed(p, cnt.to(cuda), 2)
    (g,) = torch.autograd.grad(sum((o * o).sum() for o in outs), p,
                               create_graph=True)
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def test_ssim_stays_float32_with_tf32_allowed(cuda):
    """SSIM's filter avoids cuDNN, so TF32 switched on globally does not
    reach it: float32 on the card within 1e-6 of float64 on the CPU."""
    from fresnel_tpu_torch.losses.ssim import ssim

    rng = np.random.default_rng(0)
    a = rng.uniform(size=(1, 3, 256, 256)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(
        np.float32)
    ref = ssim(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        got = ssim(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert abs(got.item() - ref.item()) <= 1e-6, (got.item(), ref.item())


def test_fit_scene_on_card_takes_both_kernels(cuda):
    from fresnel_tpu_torch.train.fit_teacher import fit_scene

    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:64, 0:64] / 64.0
    image = np.stack([0.5 + 0.3 * np.sin(6 * x + rng.uniform(0, 6))
                      * np.cos(4 * y) for _ in range(3)]).astype(np.float32)
    depth = np.full((64, 64), 0.5, np.float32)
    f0, b0 = raster.launches, raster.launches_bwd
    _, m = fit_scene(image, depth, steps=3, grid=8, K=4, res=64,
                     max_per_tile=256, depth_offset_init=-0.13, device=cuda)
    assert raster.launches - f0 == 4 and raster.launches_bwd - b0 == 3
    assert np.all(np.isfinite(m["losses"]))


def _sorted_inputs(n, width, height, seed):
    """Depth-sorted means2d, radii, visible of a test cloud, on the CPU."""
    cloud = GaussianCloud.test_cloud(n, seed=seed, spread=0.7, z_offset=-2.0,
                                     scale=0.03)
    cam = Camera.create(fx=0.8 * width, fy=0.8 * width, cx=width / 2,
                        cy=height / 2, width=width, height=height,
                        view=Camera.default_training(width).view)
    sp = tile.project_sorted(cloud.positions, cloud.scales, cloud.rotations,
                             cloud.colors, cloud.opacities, cam,
                             tile.TileRendererConfig())
    return sp.means2d, sp.radii, sp.visible


def _bin_inputs(kind, n, width, height, seed):
    """Depth-ordered means2d, radii, visible on the CPU: a projected test
    cloud ("cloud"), or made with numpy from `seed`: boxes of random
    centres and radii, some invisible, with centres up to 40 px off the
    image ("random"); every box covering the whole grid ("all_hit"); a
    cloud with nothing visible ("invisible")."""
    if kind in ("cloud", "invisible"):
        m2, rad, vis = _sorted_inputs(n, width, height, seed)
        return m2, rad, vis & (kind == "cloud")
    rng = np.random.default_rng(seed)
    if kind == "all_hit":
        m2 = np.tile([[width / 2, height / 2]], (n, 1))
        rad = np.full(n, 2.0 * max(width, height))
        vis = np.ones(n, dtype=bool)
    else:
        m2 = np.stack([rng.uniform(-40, width + 40, n),
                       rng.uniform(-40, height + 40, n)], axis=1)
        rad = rng.uniform(0.5, 40.0, n)
        vis = rng.uniform(size=n) < 0.9
    return (torch.from_numpy(m2.astype(np.float32)),
            torch.from_numpy(rad.astype(np.float32)), torch.from_numpy(vis))


# (kind, n, width, height, M).  K3 walks tile rows 4 at a time, one chunk
# of 256 per warp, and sums chunk totals 2 048 at a time; K4 counts and
# places chunks of STREAM_CHUNK = 1024 and scans 128 chunk counts a step.
TABLE_CASES = {
    "cloud_20000": ("cloud", 20_000, 256, 256, 64),
    "cloud_12345": ("cloud", 12_345, 208, 112, 256),
    "chunk_all_hit": ("all_hit", 768, 64, 48, 64),       # counts of 256
    "all_empty": ("invisible", 5_000, 128, 128, 64),
    "n2_256": ("random", 200, 96, 64, 64),
    "rows_not_multiple": ("random", 3_000, 208, 80, 64),  # 13 x 5 tiles
    # 2 071 chunks: the running sum's second segment of 2 048 totals.
    "chunks_past_scan_segment": ("random", 530_000, 32, 32, 64),
}
STREAM_CASES = {
    "cloud_20000": ("cloud", 20_000, 256, 256, 64),
    "cloud_12345": ("cloud", 12_345, 208, 112, 256),
    "never_fill": ("random", 9_000, 128, 128, 4_096),
    "all_full_first_chunk": ("all_hit", 5_000, 128, 128, 64),
    "m_above_n": ("random", 100, 128, 128, 256),
    "n_ragged": ("random", 2 * 4_096 + 77, 128, 96, 64),
    "empty_stream": ("random", 0, 128, 128, 64),
    "m_not_32": ("random", 3_000, 128, 128, 50),
    "grid_9100_tiles": ("random", 20_000, 1_600, 1_456, 64),
    # 196 chunks: past the 128 whose counts one scan step loads.
    "chunks_past_scan_step": ("random", 200_000, 64, 64, 65_536),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
@pytest.mark.parametrize("groups", [1, 4])
def test_rank_table_kernel_matches_plain(cuda, case, groups):
    kind, n, width, height, M = TABLE_CASES[case]
    m2, rad, vis = _bin_inputs(kind, n, width, height, seed=n)
    ntx, nty = -(-width // 16), -(-height // 16)
    cxlo, cxhi, cylo, cyhi, vis, n2 = tile._padded_intervals(m2, rad, vis, 16)
    bounds = [b.to(cuda) for b in (cxlo, torch.where(vis, cxhi, -1), cylo,
                                   torch.where(vis, cyhi, -1))]
    nty_g = -(-nty // groups)
    for g in range(groups):
        before = binning.launches
        tab, cum = binning.build_rank_table(*bounds, ntx, nty_g, n2,
                                            y_offset=g * nty_g)
        tab2, cum2 = binning.build_rank_table(*bounds, ntx, nty_g, n2,
                                              y_offset=g * nty_g)
        torch.cuda.synchronize()
        assert binning.launches == before + 2
        ref_tab, ref_cum = binning.build_rank_table_plain(
            *bounds, ntx, nty_g, n2, y_offset=g * nty_g)
        assert tab.is_cuda and tab.dtype == torch.bfloat16
        assert torch.equal(tab, ref_tab) and torch.equal(cum, ref_cum)
        assert torch.equal(tab, tab2) and torch.equal(cum, cum2)
    if kind == "all_hit":
        assert int(ref_tab.float().max()) == 256
    if kind == "invisible":
        assert int(cum.max()) == 0
    # The search over the kernel's tables on the card equals the CPU's.
    got = tile._bin_gaussians_search(m2.to(cuda), rad.to(cuda),
                                     vis[:n].to(cuda), ntx, nty, 16, M,
                                     groups=groups)
    ref = tile._bin_gaussians_search(m2, rad, vis[:n], ntx, nty, 16, M,
                                     groups=groups)
    assert torch.equal(got[0].cpu(), ref[0])
    assert torch.equal(got[1].cpu(), ref[1])


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_kernel_matches_plain(cuda, case):
    kind, n, width, height, M = STREAM_CASES[case]
    m2, rad, vis = (a.to(cuda) for a in _bin_inputs(kind, n, width, height,
                                                     seed=n + 1))
    ntx, nty = -(-width // 16), -(-height // 16)
    before = stream_binning.launches
    ti, tv = stream_binning.bin_gaussians_stream(m2, rad, vis, ntx, nty, 16, M)
    ti2, tv2 = stream_binning.bin_gaussians_stream(m2, rad, vis, ntx, nty,
                                                   16, M)
    torch.cuda.synchronize()
    assert stream_binning.launches == before + 2
    assert ti.is_cuda and ti.dtype == torch.int32 and tv.dtype == torch.bool
    assert torch.equal(ti, ti2) and torch.equal(tv, tv2)
    ri, rv = stream_binning.bin_gaussians_stream_plain(m2, rad, vis, ntx, nty,
                                                       16, M)
    assert torch.equal(tv, rv) and torch.equal(ti, ri)
    if n:   # the search binning needs at least one chunk of 256
        si, sv = tile._bin_gaussians_search(m2, rad, vis, ntx, nty, 16, M)
        assert torch.equal(tv, sv) and torch.equal(ti, si)
    full = tv.all(dim=1)
    if kind == "cloud":
        assert full.any() and not tv.all(), \
            "the case should fill some tiles and not others"
    elif kind == "all_hit":
        assert full.all() and torch.equal(
            ti, torch.arange(M, dtype=torch.int32, device=cuda).expand_as(ti))
    elif case == "never_fill":
        assert tv.any() and not full.any()
    elif case == "empty_stream":
        assert not tv.any() and not ti.any()


def test_binning_on_cpu_tensors_launches_no_kernel(cuda):
    m2, rad, vis = _sorted_inputs(3000, 128, 128, seed=0)
    before = (binning.launches, stream_binning.launches, raster.launches)
    tile._bin_gaussians_search(m2, rad, vis, 8, 8, 16, 64)
    stream_binning.bin_gaussians_stream(m2, rad, vis, 8, 8, 16, 64)
    assert (binning.launches, stream_binning.launches,
            raster.launches) == before


def test_binning_wrappers_reject_bad_inputs(cuda):
    v = torch.zeros(256, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        binning.build_rank_table(v.long(), v, v, v, 2, 2, 256)
    with pytest.raises(ValueError):
        binning.build_rank_table(v, v, v, v[:128], 2, 2, 256)
    with pytest.raises(ValueError):
        binning.build_rank_table(v, v, v, v.cpu(), 2, 2, 256)
    with pytest.raises(ValueError):
        stream_binning._launch(torch.zeros((8, 4), device=cuda), 2, 2, 32)
    with pytest.raises(ValueError):
        stream_binning._launch(
            torch.zeros((8, 8), dtype=torch.int32, device=cuda)[:, :4], 2, 2,
            32)
    with pytest.raises(ValueError, match="aligned"):
        stream_binning._launch(
            torch.zeros(33, dtype=torch.int32, device=cuda)[1:].view(8, 4),
            2, 2, 32)


@pytest.mark.parametrize("name", ["bin_table", "bin_stream", "raster_fwd",
                                  "raster_bwd"])
def test_broken_build_raises_on_cuda_tensors(cuda, name, monkeypatch,
                                             tmp_path):
    """A kernel that does not build raises; nothing falls back to the
    plain version.  K2's pre-pass (K1's kernel, built into K2's library) is
    launched by K2's C entry point, so it raises with it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / f"{name}.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    m2, rad, vis = (a.to(cuda) for a in _sorted_inputs(500, 64, 64, seed=3))
    pack, cnt = _pack(4, 256, [256, 65, 0, 3], 0, 32)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    def counts():
        return (binning.launches, stream_binning.launches, raster.launches,
                raster.launches_bwd)

    before = counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        if name == "bin_table":
            tile._bin_gaussians_search(m2, rad, vis, 4, 4, 16, 32)
        elif name == "bin_stream":
            stream_binning.bin_gaussians_stream(m2, rad, vis, 4, 4, 16, 32)
        elif name == "raster_fwd":
            raster.composite_tiles_packed(pack, cnt, 2)
        else:
            outs = raster.composite_tiles_plain(pack, cnt, 2)
            raster.composite_tiles_bwd(pack, cnt, 2, *outs,
                                       *_cots(4, 0, cuda))
    assert counts() == before


def test_entry_point_launch_error_raises(cuda):
    """A launch that the C entry point refuses (here: no resident blocks,
    which the segment length divides by) raises; nothing is counted."""
    pack, cnt = _pack(4, 256, [256, 65, 0, 3], 0, 32)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    part = torch.empty(raster.scratch_shape(4, 256), device=cuda)
    tickets = torch.zeros(4, dtype=torch.int32, device=cuda)
    out = [torch.empty((4, 256, 3), device=cuda)] + [
        torch.empty((4, 256), device=cuda) for _ in range(2)]
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("raster_fwd", pack.device,
                      (pack.data_ptr(), cnt.data_ptr(),
                       *(t.data_ptr() for t in out + [part, tickets]), 0),
                      (4, 256, 2, 4, 0, 0, 1, 16))


def test_entry_points_refuse_bad_image_tiling(cuda):
    """tiles_per_image < 1 is refused by K1's and K2's C entry points, and
    a pack that is not whole images by the wrappers."""
    pack, cnt = _pack(4, 256, [256, 65, 0, 3], 0, 32)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    part = torch.empty(raster.scratch_shape(4, 256), device=cuda)
    tickets = torch.zeros(4, dtype=torch.int32, device=cuda)
    out = [torch.empty((4, 256, 3), device=cuda)] + [
        torch.empty((4, 256), device=cuda) for _ in range(2)]
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("raster_fwd", pack.device,
                      (pack.data_ptr(), cnt.data_ptr(),
                       *(t.data_ptr() for t in out + [part, tickets]), 0),
                      (4, 256, 2, 0, raster.resident_blocks(0), 0, 1, 16))
    with pytest.raises(ValueError, match="whole images"):
        raster.composite_tiles_packed(pack, cnt, 2, tiles_per_image=3)
    outs = raster.composite_tiles_packed(pack, cnt, 2, tiles_per_image=2)
    with pytest.raises(ValueError, match="whole images"):
        raster.composite_tiles_bwd(pack, cnt, 2, *outs, *_cots(4, 1, cuda),
                                   tiles_per_image=3)


@pytest.mark.parametrize("binning_name,counter", [
    ("auto", "search"), ("stream", "stream")])
def test_large_cloud_render_takes_binning_kernel(cuda, binning_name, counter):
    """120 000 Gaussians (past the "auto" threshold): the default config
    launches K3 and K1, binning="stream" K4 and K1; both images equal."""
    cloud = GaussianCloud.test_cloud(120_000, seed=0, spread=0.8,
                                     z_offset=-2.0, scale=0.02).to(cuda)
    cam = Camera.default_training(256)
    args = (cloud.positions, cloud.scales, cloud.rotations, cloud.colors,
            cloud.opacities, cam)
    before = (binning.launches, stream_binning.launches, raster.launches)
    with torch.no_grad():
        img = tile.render_tiled(*args, config=tile.TileRendererConfig(
            binning=binning_name))
        ref = tile.render_tiled(*args, config=tile.TileRendererConfig(
            binning="search", table_build="xla"))
    torch.cuda.synchronize()
    after = (binning.launches, stream_binning.launches, raster.launches)
    assert after[2] - before[2] == 2
    assert after[0] - before[0] == (1 if counter == "search" else 0)
    assert after[1] - before[1] == (1 if counter == "stream" else 0)
    assert torch.equal(img, ref) and img.max() > 0.1


def _batch_inputs(B, n, seed):
    clouds = [GaussianCloud.test_cloud(n, seed=seed + b, spread=0.5,
                                       z_offset=-2.0, scale=0.06)
              for b in range(B)]
    return [torch.stack([getattr(c, k) for c in clouds]) for k in (
        "positions", "scales", "rotations", "colors", "opacities")]


def test_gather_backward_repeats_bitwise_on_card(cuda):
    """The packed gather's backward (only the occupied slots, the index
    backward with accumulate=True) gives the same bits run to run."""
    args = [a.to(cuda) for a in _batch_inputs(1, 3000, 21)]
    cam = Camera.default_training(128)
    cfg = tile.TileRendererConfig(max_per_tile=256)
    cot = torch.from_numpy(np.random.default_rng(22).normal(
        size=(3, 128, 128)).astype(np.float32)).to(cuda)
    grads = []
    for _ in range(2):
        inputs = [a[0].clone().requires_grad_() for a in args]
        img = tile.render_tiled(*inputs, cam, config=cfg)
        grads.append(torch.autograd.grad((img * cot).sum(), inputs))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,n,res,mpt", [(4, 2000, 64, 256), (2, 70, 48, 128)])
def test_batched_render_on_card_matches_cpu(cuda, B, n, res, mpt):
    """One (B * T, M, 12) pack: one K1 launch forward and one K2 launch
    backward for the batch, images within the single render's bound of
    the CPU's, and the batch's images equal to their own renders on the
    card within K1's 1e-5."""
    args = _batch_inputs(B, n, 30)
    cam = Camera.default_training(res)
    cfg = tile.TileRendererConfig(max_per_tile=mpt)
    gpu = [a.to(cuda).requires_grad_() for a in args]
    f0, b0 = raster.launches, raster.launches_bwd
    img, dep, ovf = tile.render_tiled_batched(*gpu, cam, config=cfg)
    (img.sum() + dep.sum()).backward()
    torch.cuda.synchronize()
    assert (raster.launches - f0, raster.launches_bwd - b0) == (1, 1)
    img_cpu, _, _ = tile.render_tiled_batched(*args, cam, config=cfg)
    assert (img.detach().cpu() - img_cpu).abs().mean().item() <= 1e-5
    with torch.no_grad():
        for b in range(B):
            one, _, o1 = tile.render_tiled(*[a[b] for a in gpu], cam,
                                           return_depth=True,
                                           return_overflow=True, config=cfg)
            torch.testing.assert_close(img[b], one, atol=1e-5, rtol=0)
            assert torch.equal(ovf[b], o1)


RESULTS = __import__("pathlib").Path(__file__).resolve().parents[1] / "results"


def test_checkpoints_on_card_equal_cpu(cuda):
    """The committed Flax checkpoints read into Trainers on the card give
    the CPU's params (and a full file's moments and count) bit for bit."""
    from fresnel_tpu_torch.train.harness import trainer_from_checkpoint
    for name in ("exp2", "exp2_k8", "v2combo"):
        path = str(RESULTS / f"{name}_model.msgpack")
        got, _ = trainer_from_checkpoint(path, cuda).load_checkpoint(path)
        want, _ = trainer_from_checkpoint(path, "cpu").load_checkpoint(path)
        assert got["params"]["model.depth_offset"].is_cuda
        for k, v in want["params"].items():
            assert torch.equal(got["params"][k].cpu(), v), (name, k)
        for m in ("mu", "nu"):
            for k, v in want["opt_state"][m].items():
                assert torch.equal(got["opt_state"][m][k].cpu(), v)
        assert int(got["opt_state"]["count"]) == int(
            want["opt_state"]["count"])
        assert int(got["step"]) == int(want["step"])


def _exp2_cloud(device):
    from fresnel_tpu_torch.models.encoders import create_feature_extractor
    from fresnel_tpu_torch.train.harness import trainer_from_checkpoint
    path = str(RESULTS / "exp2_model.msgpack")
    t = trainer_from_checkpoint(path, "cpu")
    state, _ = t.load_checkpoint(path)
    rng = np.random.default_rng(40)
    img = rng.uniform(size=(256, 256, 3)).astype(np.float32)
    feats = create_feature_extractor("patch")(torch.from_numpy(img))[None]
    depth = rng.uniform(0.3, 0.7, (1, 256, 256)).astype(np.float32)
    out = t.decode(state["params"], feats, depth)
    return ({k: out[k][0].to(device) for k in (
        "positions", "scales", "rotations", "colors", "opacities")},
        img.transpose(2, 0, 1).copy())


@pytest.mark.parametrize("size", [64, 256])
def test_eval_views_on_card_match_cpu(cuda, size):
    """evaluate_novel_views of exp2's decoded cloud on the card against the
    CPU: 8 K1 launches; frontal SSIM within 1e-4, PSNR within 1e-3 dB,
    coverage within 2 / S^2 per view (chip_smoke.py's eval bounds)."""
    from fresnel_tpu_torch.evaluation.novel_view_eval import (
        evaluate_novel_views)
    g, target = _exp2_cloud(cuda)
    views = np.stack([target] * 8)
    f0 = raster.launches
    got = evaluate_novel_views([{"gaussians": g, "target": target,
                                 "views": views}], render_size=size,
                               max_per_tile=1024)
    assert raster.launches - f0 == 8
    want = evaluate_novel_views(
        [{"gaussians": {k: v.cpu() for k, v in g.items()},
          "target": target, "views": views}], render_size=size,
        max_per_tile=1024)
    assert list(got) == list(want)
    assert abs(got["frontal_ssim"] - want["frontal_ssim"]) <= 1e-4
    assert abs(got["frontal_psnr"] - want["frontal_psnr"]) <= 1e-3
    for k, w in want["per_view_coverage"].items():
        assert abs(got["per_view_coverage"][k] - w) <= 2 / size ** 2
    for k, w in want["per_view_ssim"].items():
        assert abs(got["per_view_ssim"][k] - w) <= 1e-4


def test_view_pack_kernels_match_plain(cuda):
    """K1 and K2 at a view pack, B clouds each under its own orbit camera
    (one image per camera, tiles_per_image = T), against their plain
    versions at K1's 1e-5 and K2's BWD_TOL."""
    B = 4
    args = [a.to(cuda) for a in _batch_inputs(B, 3000, 50)]
    cams = [Camera.from_pose(0.0, np.float32(np.radians(az)), 64)
            for az in (45, 90, 225, 315)]
    bp = tile.pack_tiles_batched(*args, cams,
                                 tile.TileRendererConfig(max_per_tile=1024))
    pack, counts, ntx, ti = (bp.pack, bp.counts, bp.n_tiles_x,
                             bp.tiles_per_image)
    assert pack.shape[0] == B * ti and int(counts.max()) > 0
    with torch.no_grad():
        fwd = raster.composite_tiles_packed(pack, counts, ntx,
                                            tiles_per_image=ti)
        ref = raster.composite_tiles_plain(pack, counts, ntx,
                                           tiles_per_image=ti)
        for g, r in zip(fwd, ref):
            torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
        rng = np.random.default_rng(51)
        cots = [torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(
            np.float32)).to(cuda) for o in fwd]
        got = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots,
                                         tiles_per_image=ti)
        want = raster.composite_tiles_bwd_plain(pack, counts, ntx, *fwd,
                                                *cots, tiles_per_image=ti)
    scale = want.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    assert ((got - want).abs().amax(dim=(0, 1)) / scale).max() <= BWD_TOL


@pytest.mark.parametrize("name", ["exp4", "exp4_budget"])
def test_exp4_render_on_card_matches_cpu(cuda, name):
    """An experiment-4 checkpoint's cloud (377 or 5 476 Gaussians on the
    spiral) decoded and rendered at 256^2 under the training cap on the
    card and on the CPU: the spiral and its sampled depths in the same
    bits, the fields within 1e-5 of each field's largest value, one K1
    launch, the image within a mean absolute error of 1e-5 (as
    test_render_on_card_matches_cpu)."""
    from fresnel_tpu_torch.models.encoders import create_feature_extractor
    from fresnel_tpu_torch.train.harness import trainer_from_checkpoint
    path = str(RESULTS / f"{name}_model.msgpack")
    rng = np.random.default_rng(41)
    img = rng.uniform(size=(256, 256, 3)).astype(np.float32)
    feats = create_feature_extractor("patch")(torch.from_numpy(img))[None]
    depth = rng.uniform(0.3, 0.7, (1, 256, 256)).astype(np.float32)
    clouds, images = {}, {}
    for dev in (cuda, torch.device("cpu")):
        t = trainer_from_checkpoint(path, dev)
        state, _ = t.load_checkpoint(path)
        out = t.decode(state["params"], feats, depth)
        g = [out[k][0] for k in ("positions", "scales", "rotations",
                                 "colors", "opacities")]
        before = raster.launches
        images[dev.type] = tile.render_tiled(
            *g, Camera.default_training(256),
            config=tile.TileRendererConfig(max_per_tile=1024)).cpu()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert raster.launches == before + 1
        clouds[dev.type] = [v.cpu() for v in g]
    for a, b in zip(clouds["cuda"], clouds["cpu"]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    assert torch.equal(clouds["cuda"][0][:, 2], clouds["cpu"][0][:, 2])
    err = (images["cuda"] - images["cpu"]).abs()
    assert err.mean().item() <= 1e-5, err.mean().item()


def _cvs_pair(cuda, image_size=32, base_channels=32, **cfg):
    """A CVS trainer on the card and one on the CPU from the same init, and
    a bootstrap batch of 2 pairs built on the CPU."""
    from fresnel_tpu_torch.train import train_cvs
    kw = dict(image_size=image_size, base_channels=base_channels, **cfg)
    ds = train_cvs.GaussianBootstrapDataset(
        n_scenes=1, views_per_scene=3, image_size=image_size,
        n_gaussians=40, device="cpu")
    batch = next(iter(ds.batches(2, np.random.default_rng(0))))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        t = train_cvs.CVSTrainer(train_cvs.CVSTrainConfig(**kw), device=dev)
        out[dev.type] = (t, t.init_state(), t.device_batch(batch))
    return out


@pytest.mark.parametrize("civ", [False, True])
def test_cvs_step_on_card_matches_cpu(cuda, civ):
    """One CVS training step (quality-aware, fp32) at chip_smoke.py's
    cvs_reference config (64^2, base 64) on the card and on the CPU with
    the same draws, every leaf but the attention key bias (zero gradient
    in exact arithmetic): losses within 1e-4 relative; Adam's first
    moment (a tenth of the clipped gradient) within a mean absolute
    difference of 1e-2 of the leaf's mean absolute value (chip_smoke.py's
    moment bound); the params within 2 * lr of each other and within a
    mean of 1e-5.  Adam's first step moves every entry by +-lr with its
    gradient's sign, so one sign the devices round apart in a leaf of 64
    moves that leaf's mean by 3.1e-6 (measured 2.1e-6 in
    unet.ResBlock_2.GroupNorm_0.bias); 1e-5 allows 5 % of a leaf's
    entries to part that way.  Each scalar `wavelength` sums its gradient
    over every (query, key) pair's interference bias, B x 8 heads x
    (H W)^2 terms of both signs (1.05e6 at 16^2), so the summation order
    moves its moment by up to 1.03e-2 (measured): those leaves are held
    at 5e-2 (a moment mapped to the wrong leaf is off by 1 or more)."""
    pair = _cvs_pair(cuda, 64, 64, use_quality_aware=True,
                     concat_input_view=civ)
    rng = np.random.default_rng(3)
    ts = torch.from_numpy(rng.integers(0, 1000, 2))
    noise = torch.from_numpy(rng.normal(size=(2, 3, 64, 64)).astype(
        np.float32))
    res = {}
    for dev, (t, st, b) in pair.items():
        st, ld = t.train_step(st, b, 0.5, ts.to(t.device),
                              noise.to(t.device))
        res[dev] = ({k: float(v) for k, v in ld.items()},
                    {k: v.cpu() for k, v in st["params"].items()},
                    {k: v.cpu() for k, v in st["opt_state"]["mu"].items()})
    (lg, pg, mg), (lc, pc, mc) = res["cuda"], res["cpu"]
    for k, v in lc.items():
        assert abs(lg[k] - v) <= 1e-4 * abs(v), k
    lr = pair["cpu"][0].cfg.lr
    for k in pc:
        if k.endswith("key.bias"):
            continue
        d = (pg[k] - pc[k]).abs()
        assert d.max().item() <= 2 * lr + 1e-7, k
        assert d.mean().item() <= 1e-5, k
        dm = (mg[k] - mc[k]).abs().mean().item()
        rtol = 5e-2 if k.endswith("wavelength") else 1e-2
        assert dm <= rtol * mc[k].abs().mean().item(), (k, dm)


@pytest.mark.parametrize("num_steps", [1, 4])
def test_cvs_generate_on_card_matches_cpu(cuda, num_steps):
    """generate() of the EMA params on the card and the CPU, fp32: within
    1e-4 of the output's largest value."""
    pair = _cvs_pair(cuda)
    noise = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 3, 32, 32)).astype(np.float32))
    outs = {}
    for dev, (t, st, b) in pair.items():
        outs[dev] = t.generate(st, b["features"], b["R_rel"], b["t_rel"],
                               noise, num_steps).cpu()
    scale = outs["cpu"].abs().max()
    assert (outs["cuda"] - outs["cpu"]).abs().max() <= 1e-4 * scale


def test_optimize_3dgs_pack_kernels_match_plain(cuda):
    """K1 and K2 at the pack optimize_3dgs makes: 2 000 Gaussians of its
    init under 8 orbit cameras at 256^2, one (8 x 256, 256, 12) pack;
    against their plain versions at 1e-5 and BWD_TOL; one step's loss on
    the card within 1e-4 relative of the CPU's, one K1 and one K2."""
    from fresnel_tpu_torch.inference import cvs_multiview as mv
    poses = mv.camera_path("orbit", 8)
    cams = [Camera.from_pose(el, az, 256) for el, az in poses]
    p = {k: v.to(cuda) for k, v in mv.fit_init(2000, 0).items()}
    bp = tile.pack_tiles_batched(
        *[x[None].expand(8, *x.shape) for x in (
            p["positions"], torch.exp(p["log_scales"]), p["rotations"],
            torch.sigmoid(p["color_logits"]),
            torch.sigmoid(p["opacity_logits"]))],
        cams, tile.TileRendererConfig(max_per_tile=256))
    pack, counts, ntx, ti = (bp.pack, bp.counts, bp.n_tiles_x,
                             bp.tiles_per_image)
    assert tuple(pack.shape[:2]) == (8 * 256, 256)
    with torch.no_grad():
        fwd = raster.composite_tiles_packed(pack, counts, ntx,
                                            tiles_per_image=ti)
        ref = raster.composite_tiles_plain(pack, counts, ntx,
                                           tiles_per_image=ti)
        for g, r in zip(fwd, ref):
            torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
        rng = np.random.default_rng(52)
        cots = [torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(
            np.float32)).to(cuda) for o in fwd]
        got = raster.composite_tiles_bwd(pack, counts, ntx, *fwd, *cots,
                                         tiles_per_image=ti)
        want = raster.composite_tiles_bwd_plain(pack, counts, ntx, *fwd,
                                                *cots, tiles_per_image=ti)
    scale = want.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    assert ((got - want).abs().amax(dim=(0, 1)) / scale).max() <= BWD_TOL
    views = np.random.default_rng(5).uniform(size=(8, 3, 256, 256)).astype(
        np.float32)
    losses = {}
    for dev in (cuda, torch.device("cpu")):
        f0, b0 = raster.launches, raster.launches_bwd
        got = []
        mv.optimize_3dgs(views, poses, 256, steps=1, device=dev,
                         losses=got)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (raster.launches - f0, raster.launches_bwd - b0) == (1, 1)
        losses[dev.type] = float(got[0])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * losses["cpu"]


def _saag_cloud(dev, grid=128, subsample=1, seed=6):
    """A SAAG cloud of the gradient depth of a seeded smooth image, on
    `dev` (the same depth and colour for every device)."""
    from fresnel_tpu_torch.geometry import (pointcloud_from_depth,
                                            to_surface_gaussians)
    from fresnel_tpu_torch.models.encoders import (gradient_depth_estimate,
                                                   resize_linear)
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(size=(3, 16, 16)).astype(np.float32))
    img = resize_linear(img, 2 * grid, 2 * grid)
    depth = gradient_depth_estimate(img.permute(1, 2, 0), grid)
    color = resize_linear(img, grid, grid).permute(1, 2, 0)
    pc = pointcloud_from_depth(depth.to(dev), color=color.to(dev),
                               depth_scale=2.0,
                               subsample=subsample).normalize(3.0)
    return pc, to_surface_gaussians(pc, depth.to(dev))


def test_saag_on_card_matches_cpu(cuda):
    """to_surface_gaussians at 128^2 on the card and the CPU from the same
    depth: the point clouds bit for bit, the masks equal, rotations
    within 2e-4 (norms an ulp apart near a flat normal move the arccos by
    ulp / sin(angle); chip_smoke.py's saag_reference), every other field
    within 1e-6."""
    pc_g, g = _saag_cloud(cuda)
    pc_c, c = _saag_cloud(torch.device("cpu"))
    for k in ("positions", "colors", "confidence", "valid"):
        assert torch.equal(getattr(pc_g, k).cpu(), getattr(pc_c, k)), k
    assert torch.equal(g.opacities.cpu() > 0, c.opacities > 0)
    for k in ("positions", "scales", "colors", "opacities", "rotations"):
        d = (getattr(g, k).cpu() - getattr(c, k)).abs().max().item()
        assert d <= (2e-4 if k == "rotations" else 1e-6), (k, d)


def test_saag_render_pack_kernels_match_plain(cuda):
    """K3 and K1 at the viewer server's /render pack: the session's
    default cloud (grid 256, subsample 2: 196 608 Gaussians) at 1 024^2,
    M 512: K3 bit for bit over every search group, K1 within 1e-5."""
    _, cloud = _saag_cloud(cuda, grid=256, subsample=2)
    assert cloud.num_gaussians == 196608
    cam = Camera.from_pose(0.1, 0.3, 1024, distance=2.0).to(cuda)
    cfg = tile.TileRendererConfig(max_per_tile=512)
    fields = (cloud.positions, cloud.scales, cloud.rotations, cloud.colors,
              cloud.opacities)
    with torch.no_grad():
        sp = tile.project_sorted(*fields, cam, cfg)
        xlo, xhi, ylo, yhi, vis, n2 = tile._padded_intervals(
            sp.means2d, sp.radii, sp.visible, 16)
        b = (xlo, torch.where(vis, xhi, -1), ylo, torch.where(vis, yhi, -1))
        groups = tile.search_groups(cloud.num_gaussians, 64, 64)
        gy = -(-64 // groups)
        for gi in range(groups):
            got = binning.build_rank_table(*b, 64, gy, n2, y_offset=gi * gy)
            ref = binning.build_rank_table_plain(*b, 64, gy, n2,
                                                 y_offset=gi * gy)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            del got, ref
        tp = tile.pack_tiles(*fields, cam, cfg)
        assert tuple(tp.pack.shape[:2]) == (4096, 512)
        fwd = raster.composite_tiles_packed(tp.pack, tp.counts, tp.n_tiles_x)
        ref = raster.composite_tiles_plain(tp.pack, tp.counts, tp.n_tiles_x)
    for g, r in zip(fwd, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("exp", [1, 3, 5])
def test_exp135_step_on_card_matches_cpu(cuda, exp):
    """One training step of experiment 1, 3 or 5 (64^2, batch 2, 55 spiral
    points, 4 NCA steps, dropout 0, the NCA's masks drawn once on the
    host) on the card and the CPU from one init: each loss term within
    1e-4 relative; one K1 and one K2 launch on the card."""
    from fresnel_tpu_torch.train import config as tconfig
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder
    rng = np.random.default_rng(exp)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    batch = {"image": rng.uniform(size=(2, 3, 64, 64)).astype(np.float32),
             "features": rng.normal(size=(2, 37, 37, 384)).astype(np.float32),
             "depth": np.stack([0.3 + 0.4 * xx * yy, 0.6 - 0.3 * yy]
                               ).astype(np.float32)}
    masks = (torch.rand((4, 2, 55, 1), generator=torch.Generator()
                        .manual_seed(0)) < 0.5).float()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        cfg = tconfig.TrainingConfig(experiment=exp, image_size=64,
                                     batch_size=2, n_spiral_points=55,
                                     nca_steps=4, lpips_weight=0.0)
        t = Trainer(cfg, tconfig.PhysicsConfig(), tconfig.HFGSConfig(
            use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False), tconfig.HFTSConfig(), device=dev)
        t.model = build_decoder(cfg, t.physics_config, dropout=0.0)
        st = t.init_state()
        f0, b0 = raster.launches, raster.launches_bwd
        _, ld = t.train_step(st, t.device_batch(batch), 1, None,
                             torch.Generator(device=dev).manual_seed(1),
                             nca_masks=masks.to(dev) if exp == 5 else None)
        out[dev.type] = {k: float(v) for k, v in ld.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (raster.launches - f0, raster.launches_bwd - b0) == (1, 1)
    for k, v in out["cpu"].items():
        assert abs(out["cuda"][k] - v) <= 1e-4 * max(abs(v), 1e-6), k


def test_reprocess_session_on_card(cuda):
    """The viewer server's session on the card: reprocess at subsample 1
    and 2 (the counts its cloud's opacities give) and a 256^2 render (one
    K1; a PNG not all background)."""
    import io
    from PIL import Image
    from fresnel_tpu_torch.viewer import serve
    rng = np.random.default_rng(3)
    img = rng.uniform(0.2, 0.9, (64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:64, 0:64]
    depth = ((xx + yy) / 126.0).astype(np.float32)
    s = serve.ReprocessSession(img, depth, grid=64, device=cuda)
    for sub in (1, 2):
        _, n = s.reprocess({"subsample": sub})
        assert s.cloud.positions.device.type == "cuda"
        assert n == int((s.cloud.opacities > 1e-3).sum()) > 0
    f0 = raster.launches
    png = np.asarray(Image.open(io.BytesIO(s.render_png(0.3, 0.1, 2.0, 256))))
    assert raster.launches - f0 == 1
    assert png.shape == (256, 256, 3) and png.max() > 0


def _backbone_files(tmp_path):
    """ViT-S/14 DINOv2 (HF naming, .safetensors) and Depth-Anything-V2-
    Small (.pth) at the published shapes, random from a seed."""
    from fresnel_tpu_torch.models import backbone_files as bf
    dino = str(tmp_path / "dinov2_small.safetensors")
    depth = str(tmp_path / "depth_anything_v2_small.pth")
    bf.save_checkpoint(dino, bf.dinov2_checkpoint("hf", seed=1))
    bf.save_checkpoint(depth, bf.depth_anything_checkpoint(seed=2))
    return dino, depth


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def test_backbones_on_card_match_cpu(cuda, tmp_path):
    """The weight-loaded DINOv2 and Depth-Anything at 518^2 on the card
    against the CPU: float32 within 1e-4 of the largest value; the card's
    bf16 no further from the CPU's float32 than twice the CPU's own bf16
    gap.  The fused trunk on the card against the separate route there,
    float32, within 1e-5."""
    from fresnel_tpu_torch.models import encoders as te
    dino, depth = _backbone_files(tmp_path)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(300, 300, 3)).astype(np.float32))
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for dev in (cuda, torch.device("cpu")):
            ext = te.DINOv2FeatureExtractor(dino, compute_dtype=dt,
                                            device=dev)
            est = te.DepthAnythingEstimator(depth, compute_dtype=dt,
                                            device=dev)
            out[dt, dev.type] = (ext(img), est(img, 256), ext, est)
    f32, b16 = torch.float32, torch.bfloat16
    for i in (0, 1):
        assert _rel(out[f32, "cuda"][i], out[f32, "cpu"][i]) <= 1e-4
        gap = _rel(out[b16, "cpu"][i], out[f32, "cpu"][i])
        assert _rel(out[b16, "cuda"][i], out[f32, "cpu"][i]) <= 2 * gap
    _, _, ext, est = out[f32, "cuda"]
    fused = te.create_fused_encoder(ext, est)
    f, d = fused(img, 256)
    assert _rel(f, out[f32, "cuda"][0]) <= 1e-5
    assert _rel(d, out[f32, "cuda"][1]) <= 1e-5


def test_option_step_on_card_matches_cpu(cuda):
    """One training step of experiment 2 with every decoder option the
    port has (Fresnel zones, edge-aware, phase output, pose encoding with
    multi-pose augmentation, depth fusion) at 64^2, batch 2, dropout 0,
    on the card and the CPU from one init with the same poses: each loss
    term within 1e-4 relative; one K1 and one K2 launch on the card."""
    from fresnel_tpu_torch.train import config as tconfig
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    batch = {"image": rng.uniform(size=(2, 3, 64, 64)).astype(np.float32),
             "features": rng.normal(size=(2, 37, 37, 384)).astype(np.float32),
             "depth": np.stack([0.3 + 0.4 * xx * yy, 0.6 - 0.3 * yy]
                               ).astype(np.float32)}
    poses = (np.array([0.0, 0.2], np.float32), np.array([0.0, -0.5],
                                                         np.float32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        cfg = tconfig.TrainingConfig(
            image_size=64, batch_size=2, lpips_weight=0.0,
            gaussians_per_patch=2, use_fresnel_zones=True,
            use_edge_aware=True, use_phase_output=True,
            use_pose_encoding=True, multi_pose_augmentation=True,
            use_depth_fusion=True)
        t = Trainer(cfg, tconfig.PhysicsConfig(), tconfig.HFGSConfig(
            use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False), tconfig.HFTSConfig(), device=dev)
        t.model = build_decoder(cfg, t.physics_config, dropout=0.0)
        st = t.init_state()
        f0, b0 = raster.launches, raster.launches_bwd
        _, ld = t.train_step(st, t.device_batch(batch), 2, None,
                             torch.Generator(device=dev).manual_seed(1),
                             poses=poses)
        out[dev.type] = {k: float(v) for k, v in ld.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (raster.launches - f0, raster.launches_bwd - b0) == (1, 1)
    for k, v in out["cpu"].items():
        assert abs(out["cuda"][k] - v) <= 1e-4 * max(abs(v), 1e-6), k


# ----------------------------------------------------------------------
# hard_cutoff=False, phase blending (K1-phi / K2-phi), the dense splat
# (K5 / K6)
# ----------------------------------------------------------------------

def _phase_pack(T, M, counts, seed, width, radians):
    """A pack with phases in column 11: in [0, 2 pi) (the decoders'
    radians, which the reference blends as unit-interval fractions) or in
    [0, 1)."""
    pack, cnt = _pack(T, M, counts, seed, width)
    rng = np.random.default_rng(seed + 100)
    ph = rng.uniform(0, 2 * np.pi if radians else 1.0, (T, M))
    pack[..., 11] = torch.from_numpy(ph.astype(np.float32))
    pack[np.arange(M)[None, :] >= cnt.numpy()[:, None]] *= torch.tensor(
        [1.0] * 11 + [0.0])
    return pack, cnt


@pytest.mark.parametrize("T,M,ntx,pattern", [
    (64, 256, 8, "random"), (64, 256, 8, "cap"), (16, 32, 4, "random"),
    (256, 1024, 16, "random")])
def test_box_off_kernels_match_plain(cuda, T, M, ntx, pattern):
    pack, cnt = _pack(T, M, _counts(pattern, T, M, T), T, ntx * 16)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    before = (raster.launches, raster.launches_bwd)
    got = raster.composite_tiles_packed(pack, cnt, ntx, box=False)
    ref = raster.composite_tiles_plain(pack, cnt, ntx, box=False)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    boxed = raster.composite_tiles_plain(pack, cnt, ntx)
    assert not torch.equal(ref[2], boxed[2])
    cots = _cots(T, 5, cuda)
    grad = raster.composite_tiles_bwd(pack, cnt, ntx, *got, *cots,
                                      box=False)
    assert (raster.launches, raster.launches_bwd) == (before[0] + 1,
                                                      before[1] + 1)
    _assert_fields_close(grad, raster.composite_tiles_bwd_plain(
        pack, cnt, ntx, *ref, *cots, box=False))


def _strip_slots(pack, ntx, pattern):
    """Every third slot of each tile moved onto the edges of the kernels'
    warp strips (16 x 4 pixels, rows 4 s to 4 s + 3 of the tile):
    "strip_one" a box of radius 1.5 about a strip's middle row, inside
    that strip alone; "strip_edge" a box of radius 2 whose edges lie on
    the first rows of strips s and s + 1."""
    T, M, _ = pack.shape
    t, j = np.meshgrid(np.arange(T), np.arange(0, M, 3), indexing="ij")
    s = j % 4
    x0, y0 = t % ntx * 16, t // ntx * 16
    r = 1.5 if pattern == "strip_one" else 2.0
    my = y0 + 4 * s + (1.5 if pattern == "strip_one" else r)
    alive = pack[t, j, 5] > 0
    pack[t, j, 0] = torch.from_numpy(np.where(
        alive, x0 + 7.5, pack[t, j, 0]).astype(np.float32))
    pack[t, j, 1] = torch.from_numpy(np.where(
        alive, my, pack[t, j, 1]).astype(np.float32))
    pack[t, j, 5] = torch.from_numpy(np.where(
        alive, r, pack[t, j, 5]).astype(np.float32))


@pytest.mark.parametrize("T,M,ntx,pattern,amp,box,radians", [
    (64, 256, 8, "random", 0.3, True, False),
    (64, 256, 8, "cap", 0.25, True, False),
    (64, 256, 8, "around_seg", 0.3, False, False),
    (16, 32, 4, "random", 0.25, True, False),
    (64, 96, 8, "random", 0.3, True, False),
    (64, 256, 8, "random", 0.3, True, True),
    (256, 256, 16, "cap", 0.25, True, True),
    (64, 256, 8, "strip_one", 0.25, True, True),
    (64, 256, 8, "strip_edge", 0.25, True, True),
    (64, 256, 8, "around_ckpt", 0.25, True, True),
    (64, 256, 8, "random", 0.25, False, True)])
def test_phase_kernels_match_plain(cuda, T, M, ntx, pattern, amp, box,
                                   radians):
    strip = pattern.startswith("strip")
    pack, cnt = _phase_pack(T, M, _counts("random" if strip else pattern,
                                          T, M, T), T, ntx * 16, radians)
    if strip:
        _strip_slots(pack, ntx, pattern)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    before = (raster.launches_phase, raster.launches_phase_bwd)
    p = pack.clone().requires_grad_()
    got = raster.composite_tiles_phase(p, cnt, ntx, amp, box=box)
    ref = raster.composite_tiles_plain(pack, cnt, ntx, box=box,
                                       phase_amplitude=amp)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
    cots = _cots(T, 6, cuda)
    (grad,) = torch.autograd.grad(got, p, cots)
    assert (raster.launches_phase, raster.launches_phase_bwd) == (
        before[0] + 1, before[1] + 1)
    ref_g = raster.composite_tiles_phase_bwd_plain(pack, cnt, ntx, amp,
                                                   *cots, box=box)
    _assert_fields_close(grad, ref_g)
    ckpt = raster._launch_fwd_phase(pack, cnt, ntx, amp, keep_ckpt=True,
                                    box=box)[3]
    again = raster._launch_bwd_phase(pack, cnt, ntx, amp, *cots, ckpt,
                                     box=box)
    assert torch.equal(grad, again)


def test_phase_fast_paths_match_library(cuda):
    """K1-phi / K2-phi's cosf, sinf and division fast paths round as the
    library does: every float of the trigonometric fast range and its
    negative, and 2^30 division pairs across the division's range."""
    got = raster.phase_fastpath_check(cuda)
    assert got["trig_checked"] == 2 * 0x47ce4780
    assert got["div_checked"] > 2 ** 29
    assert (got["cos_mismatches"], got["sin_mismatches"],
            got["div_mismatches"]) == (0, 0, 0)


# ----------------------------------------------------------------------
# Any tile size: K1, K2, K1-phi and K2-phi at tile sizes other than 16
# (one runtime instantiation, pixel groups of at most 256 pixels) and at 16
# (compiled in)
# ----------------------------------------------------------------------

TILE_SIZES = [1, 3, 4, 8, 12, 16, 24, 32, 48]


def _ts_pack(ts, phases, seed):
    """Two images of 4 x 2 tiles of ts x ts pixels (T = 16, M = 256):
    counts 0, 1, at the cap and past one and several segments (and
    checkpoint edges), radii from under a pixel to past the tile, so that
    boxes hold one pixel, one warp's pixels or the whole tile."""
    T, M, ntx = 16, 256, 4
    counts = np.array([0, 1, 256, 65, 130, 17, 16, 200,
                       64, 3, 255, 0, 129, 33, 256, 90])
    rng = np.random.default_rng(seed)
    w, h = ntx * ts, 2 * ts
    pack = np.zeros((T, M, 12), np.float32)
    pack[..., 0] = rng.uniform(-2, w + 2, (T, M))
    pack[..., 1] = rng.uniform(-2, h + 2, (T, M))
    scale = 1.0 / max(ts, 2) ** 2
    pack[..., 2] = rng.uniform(0.05, 1.0, (T, M)) * scale
    pack[..., 3] = rng.uniform(-0.02, 0.02, (T, M)) * scale
    pack[..., 4] = rng.uniform(0.05, 1.0, (T, M)) * scale
    pack[..., 5] = rng.uniform(0.4, 1.5 * ts + 1, (T, M))
    pack[..., 6:9] = rng.uniform(0, 1, (T, M, 3))
    pack[..., 9] = rng.uniform(0, 1, (T, M))
    pack[..., 10] = rng.uniform(1, 4, (T, M))
    if phases:
        pack[..., 11] = rng.uniform(0, 1, (T, M))
    dead = np.arange(M)[None, :] >= counts[:, None]
    pack[dead] = 0.0
    pack[dead, 5] = -1.0
    return (torch.from_numpy(pack), torch.from_numpy(counts.astype(np.int32)),
            ntx)


def _ts_cots(T, ts, seed, device):
    P = ts * ts
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
            for s in ((T, P, 3), (T, P), (T, P))]


@pytest.mark.parametrize("ts", TILE_SIZES)
@pytest.mark.parametrize("box", [True, False])
def test_kernels_match_plain_at_tile_size(cuda, ts, box):
    """K1 and K2 at tile size ts, on one image of 16 tiles and on two
    images of 8 (tiles_per_image): K1 within 1e-5 of its plain version,
    K2 within 1e-4 of each field's largest plain value, both bit for bit
    from run to run, K2 handed K1's prefixes equal to K2 alone."""
    pack, cnt, ntx = _ts_pack(ts, False, ts)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    T, M, _ = pack.shape
    cots = _ts_cots(T, ts, ts + 1, cuda)
    for ti in (None, 8):
        kw = dict(tiles_per_image=ti, box=box, tile_size=ts)
        f0, b0 = raster.launches, raster.launches_bwd
        got = raster._launch_fwd(pack, cnt, ntx, keep_prefix=True, **kw)
        again = raster._launch_fwd(pack, cnt, ntx, keep_prefix=True, **kw)
        ref = raster.composite_tiles_plain(pack, cnt, ntx, **kw)
        for g, a, r in zip(got[:3], again[:3], ref):
            assert g.shape == r.shape == (T, ts * ts) + tuple(r.shape[2:])
            torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
            assert torch.equal(g, a)
        handed = raster._launch_bwd(pack, cnt, ntx, *got[:3], *cots,
                                    prefix=got[3], **kw)
        alone = raster._launch_bwd(pack, cnt, ntx, *got[:3], *cots, **kw)
        torch.cuda.synchronize()
        assert (raster.launches - f0, raster.launches_bwd - b0) == (2, 2)
        assert torch.equal(handed, alone)
        _assert_fields_close(handed, raster.composite_tiles_bwd_plain(
            pack, cnt, ntx, *got[:3], *cots, **kw))
        dead = torch.arange(M, device=cuda)[None, :] >= cnt[:, None]
        assert torch.all(handed[dead] == 0)


@pytest.mark.parametrize("ts", TILE_SIZES)
@pytest.mark.parametrize("box", [True, False])
def test_phase_kernels_match_plain_at_tile_size(cuda, ts, box):
    """K1-phi and K2-phi at tile size ts, on one image and on two:
    K1-phi within 1e-5 of its plain version, K2-phi within 1e-4 of each
    field's largest plain value and bit for bit from run to run."""
    pack, cnt, ntx = _ts_pack(ts, True, ts + 2)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    T = pack.shape[0]
    cots = _ts_cots(T, ts, ts + 3, cuda)
    amp = 0.3
    for ti in (None, 8):
        kw = dict(tiles_per_image=ti, box=box, tile_size=ts)
        f0, b0 = raster.launches_phase, raster.launches_phase_bwd
        p = pack.clone().requires_grad_()
        got = raster.composite_tiles_phase(p, cnt, ntx, amp, **kw)
        ref = raster.composite_tiles_plain(pack, cnt, ntx,
                                           phase_amplitude=amp, **kw)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            torch.testing.assert_close(g, r, atol=1e-5, rtol=0)
        (grad,) = torch.autograd.grad(got, p, cots)
        assert (raster.launches_phase - f0,
                raster.launches_phase_bwd - b0) == (1, 1)
        _assert_fields_close(grad, raster.composite_tiles_phase_bwd_plain(
            pack, cnt, ntx, amp, *cots, **kw))
        ckpt = raster._launch_fwd_phase(pack, cnt, ntx, amp, keep_ckpt=True,
                                        **kw)[3]
        assert torch.equal(grad, raster._launch_bwd_phase(
            pack, cnt, ntx, amp, *cots, ckpt, **kw))


@pytest.mark.parametrize("ts", [8, 32])
@pytest.mark.parametrize("binning_name", ["search", "stream"])
def test_render_at_tile_size_on_card_matches_cpu(cuda, ts, binning_name):
    """render_tiled at tile size ts, plain and phase-blended, with its
    gradient: the card (K3 or K4, K1 / K2, K1-phi / K2-phi) against the
    CPU, held on average as test_render_on_card_matches_cpu holds it."""
    rng = np.random.default_rng(ts)
    n, res = 3000, 128
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pos[:, 2] -= 2.0
    args = [torch.from_numpy(a) for a in (
        pos, np.full((n, 3), 0.04, np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(size=(n, 3)).astype(np.float32),
        rng.uniform(0.2, 1.0, size=n).astype(np.float32),
        rng.uniform(0, 1, size=n).astype(np.float32))]
    cam = Camera.default_training(res)
    for phased in (False, True):
        cfg = tile.TileRendererConfig(tile_size=ts, binning=binning_name,
                                      use_phase_blending=phased)
        outs = []
        for dev in (cuda, "cpu"):
            a = [x.to(dev).requires_grad_(i == 3) for i, x in
                 enumerate(args)]
            img = tile.render_tiled(*a[:5], cam, phases=a[5], config=cfg)
            (g,) = torch.autograd.grad(img.square().sum(), a[3])
            outs.append((img.detach().cpu(), g.cpu()))
        (ig, gg), (ic, gc) = outs
        assert ig.shape == (3, res, res)
        assert (ig - ic).abs().mean().item() <= 1e-5
        assert (gg - gc).abs().mean().item() <= 1e-4 * gc.abs().max().item()


def _splat_inputs(B, N, size, mode, seed, opacity="some0"):
    """B different clouds of N Gaussians around a size^2 image; opacity
    "some0" (every 7th Gaussian invisible), "none0" or "all0"."""
    rng = np.random.default_rng(seed)
    p = np.zeros((B, N, 8), np.float32)
    p[..., 0:2] = rng.uniform(-10, size + 10, (B, N, 2))
    if mode == 0:
        p[..., 2] = rng.uniform(0.002, 0.05, (B, N))
        p[..., 3] = rng.uniform(-0.001, 0.001, (B, N))
        p[..., 4] = rng.uniform(0.002, 0.05, (B, N))
        p[..., 5] = rng.uniform(1, 40, (B, N))
        C = 8
    else:
        p[..., 2] = rng.uniform(0.5, 12, (B, N))
        C = 3
    p[..., 6] = rng.uniform(0, 1, (B, N))
    if opacity == "some0":
        p[:, ::7, 6] = 0.0                   # invisible ones
    elif opacity == "all0":
        p[..., 6] = 0.0
    V = rng.normal(size=(B, N, C)).astype(np.float32)
    return torch.from_numpy(p), torch.from_numpy(V)


# K5 culls 256 Gaussians at a time and K6 walks each Gaussian's window 32
# columns at a time: N = 1 and 257 around the stage, ISO sigmas up to 12 px
# at 256^2 (windows wider than 32 and 128 columns, clipped at the edges),
# H and W not multiples of 16, B clouds in one launch, and clouds whose
# every opacity is 0 (K5 gives 0; K6 the opacity's own gradient).
@pytest.mark.parametrize("B,N,H,W,mode,opacity", [
    (1, 300, 48, 48, 0, "some0"), (3, 257, 40, 56, 0, "some0"),
    (1, 300, 48, 48, 1, "some0"), (2, 129, 33, 47, 1, "some0"),
    (1, 400, 256, 256, 1, "some0"), (1, 1, 48, 48, 0, "none0"),
    (1, 1, 48, 48, 1, "none0"), (1, 257, 64, 64, 1, "some0"),
    (2, 300, 48, 48, 0, "all0"), (1, 300, 33, 47, 1, "all0"),
    (3, 300, 40, 56, 1, "some0")])
def test_dense_splat_kernels_match_plain(cuda, B, N, H, W, mode, opacity):
    from fresnel_tpu_torch.render import splat

    params, V = _splat_inputs(B, N, max(H, W), mode, N, opacity)
    params, V = params.to(cuda), V.to(cuda)
    before = (splat.launches, splat.launches_bwd)
    pg = params.clone().requires_grad_()
    vg = V.clone().requires_grad_()
    got = splat.dense_splat(pg, vg, H, W, mode)
    ref = splat.dense_splat_plain(params, V, H, W, mode)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    if opacity == "all0":
        assert not got.any()
    g_out = torch.from_numpy(np.random.default_rng(3).normal(
        size=tuple(got.shape)).astype(np.float32)).to(cuda)
    gp, gv = torch.autograd.grad(got, (pg, vg), g_out)
    assert (splat.launches, splat.launches_bwd) == (before[0] + 1,
                                                    before[1] + 1)
    rp, rv = splat.dense_splat_bwd_plain(params, V, g_out, mode)
    if opacity == "all0":
        assert rp[..., 6].abs().max().item() > 0
    for got_g, ref_g in ((gp, rp), (gv, rv)):
        for f in range(got_g.shape[-1]):
            s = ref_g[..., f].abs().max().item()
            e = (got_g[..., f] - ref_g[..., f]).abs().max().item()
            assert e <= BWD_TOL * max(s, 1e-30), (f, e, s)
    # Again, from a g_out 4 bytes off 16-byte alignment (K6 reads a WAVE
    # pixel as two float4s; the launcher realigns it).
    shifted = torch.empty(g_out.numel() + 1, device=cuda)[1:]
    shifted = shifted.view_as(g_out).copy_(g_out)
    assert shifted.data_ptr() % 16
    again = splat._launch_bwd(params, V, shifted, mode)
    assert torch.equal(again[0], gp) and torch.equal(again[1], gv)
    assert torch.equal(splat._launch_fwd(params, V, H, W, mode), got)


@pytest.mark.parametrize("over,physics,hfgs,kernels", [
    (dict(use_phase_blending=True, use_phase_output=True), dict(), dict(),
     ("launches_phase", "launches_phase_bwd")),
    (dict(use_phase_output=True), dict(use_wave_rendering=True), dict(),
     ("launches", "launches_bwd")),
    (dict(), dict(use_wave_rendering=True, learnable_wavelength=True,
                  use_diffraction_placement=True), dict(),
     ("launches", "launches_bwd")),
    (dict(experiment=4, use_phase_blending=True, n_spiral_points=377),
     dict(), dict(), ("launches", "launches_bwd"))])
def test_wave_route_step_on_card_matches_cpu(cuda, over, physics, hfgs,
                                             kernels):
    """One training step on each wave-optics route (phase blending with
    phases, QSR's wave field with per-RGB phases, the physics decoder,
    experiment 4's Fourier route) at 64^2, batch 2, dropout 0, on the card
    and the CPU from one init: each loss term within 1e-4 relative; one
    launch of the route's forward and backward kernel on the card."""
    from fresnel_tpu_torch.render import splat
    from fresnel_tpu_torch.train import config as tconfig
    from fresnel_tpu_torch.train.harness import Trainer, build_decoder
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    batch = {"image": rng.uniform(size=(2, 3, 64, 64)).astype(np.float32),
             "features": rng.normal(size=(2, 37, 37, 384)).astype(np.float32),
             "depth": np.stack([0.3 + 0.4 * xx * yy, 0.6 - 0.3 * yy]
                               ).astype(np.float32)}
    counter = raster if kernels[0] == "launches_phase" else splat
    out = {}
    for dev in (cuda, torch.device("cpu")):
        cfg = tconfig.TrainingConfig(image_size=64, batch_size=2,
                                     lpips_weight=0.0, gaussians_per_patch=2,
                                     **over)
        t = Trainer(cfg, tconfig.PhysicsConfig(**physics),
                    tconfig.HFGSConfig(**hfgs), tconfig.HFTSConfig(),
                    device=dev)
        t.model = build_decoder(cfg, t.physics_config, dropout=0.0)
        st = t.init_state()
        before = [getattr(counter, k) for k in kernels]
        _, ld = t.train_step(st, t.device_batch(batch), 2, None,
                             torch.Generator(device=dev).manual_seed(1))
        out[dev.type] = {k: float(v) for k, v in ld.items()}
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert [getattr(counter, k) - b
                    for k, b in zip(kernels, before)] == [1, 1]
    assert set(out["cpu"]) == set(out["cuda"])
    for k, v in out["cpu"].items():
        assert abs(out["cuda"][k] - v) <= 1e-4 * max(abs(v), 1e-6), k


# Sigma ranges (px) of _composite_inputs' DENSE layouts.
_COMPOSITE_SIGMAS = dict(spread=(1.0, 12.0), wide=(8.0, 40.0),
                         cluster=(0.12, 0.15), outside=(1.0, 12.0))


def _composite_inputs(N, size, mode, seed, ties=False, top=False,
                      layout="spread"):
    """Depth-sorted (N, 8) params and (N, 3) colours of the dense
    compositing kernels: DENSE conics of sigma 1-12 px (reaching past one
    tile), SIMPLE sigmas and radii as render_simplified makes them; `ties`
    gives runs of Gaussians one depth; `top` puts opacity at the clip on a
    few centred on pixels.  `layout` "wide": DENSE sigmas of 8-40 px and
    opacities of 0.5-0.95, so the transmittance underflows to 0; "cluster":
    every mean in x 40-55, y 19.3-19.7 with a reach under 3.3 px (DENSE
    sigma 0.12-0.15, SIMPLE radius 1), all in the 32 x 16 tile from (32,
    16), so that tile lists all N; "outside": every mean 100-200 px left
    of the image, so no tile lists any."""
    rng = np.random.default_rng(seed)
    p = np.zeros((N, 8), np.float32)
    p[:, 0] = rng.uniform(-10, size + 10, N)
    p[:, 1] = rng.uniform(-10, size + 10, N)
    if layout == "cluster":
        p[:, 0] = rng.uniform(40, 55, N)
        p[:, 1] = rng.uniform(19.3, 19.7, N)
    elif layout == "outside":
        p[:, 0] = rng.uniform(-200, -100, N)
    if mode == 0:
        s = rng.uniform(*_COMPOSITE_SIGMAS[layout], (N, 2))
        th = rng.uniform(0, np.pi, N)
        c, sn = np.cos(th), np.sin(th)
        a = c * c / s[:, 0] ** 2 + sn * sn / s[:, 1] ** 2
        b = c * sn * (1 / s[:, 0] ** 2 - 1 / s[:, 1] ** 2)
        d = sn * sn / s[:, 0] ** 2 + c * c / s[:, 1] ** 2
        p[:, 2], p[:, 3], p[:, 4] = a, b, d
    else:
        r = rng.uniform(1.0, 1.0 if layout == "cluster" else 20.0, N)
        p[:, 2] = np.maximum(r / 2, 1.0)
        p[:, 5] = r
    p[:, 6] = rng.uniform(0.5 if layout == "wide" else 0.05, 0.95, N)
    p[::17, 6] = 0.0
    p[:, 7] = np.sort(rng.uniform(0.5, 3.0, N))
    if ties:
        for s0 in range(0, N, 23):
            p[s0:s0 + 9, 7] = p[s0, 7]
    if top:
        k = slice(3, None, 41)
        p[k, 0] = np.round(p[k, 0])
        p[k, 1] = np.round(p[k, 1])
        p[k, 6] = 0.99 if mode == 0 else 1.0
    col = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return torch.from_numpy(p), torch.from_numpy(col)


# K7 / K8 take 32 x 16 tiles, stage 256 listed Gaussians at a time and K8
# walks runs of 16 back to front: N = 1, 255, 257 and 700 around those, H
# and W not multiples of the tile, alpha on its clip (0.99 DENSE, 1
# SIMPLE: T reaches exactly 0), opacities of 0, SIMPLE depth ties within
# and across chunks of 16, 64 and 128; a DENSE cloud over which T
# underflows to 0 at most pixels ("wide"), one tile listing every Gaussian
# ("cluster": lists of 47 and 49, one under and one over a run boundary,
# 257 and 300 over stage boundaries) and no tile listing any ("outside").
# K7 repeats bit for bit.
@pytest.mark.parametrize("N,H,W,mode,chunk,ties,top,layout", [
    (1, 48, 48, 0, 256, False, False, "spread"),
    (255, 40, 56, 0, 256, False, True, "spread"),
    (700, 64, 64, 0, 256, False, True, "spread"),
    (257, 33, 47, 0, 64, False, False, "spread"),
    (1, 48, 48, 1, 128, False, False, "spread"),
    (300, 40, 56, 1, 128, True, True, "spread"),
    (700, 64, 64, 1, 16, True, True, "spread"),
    (257, 33, 47, 1, 128, True, False, "spread"),
    (2000, 128, 128, 0, 256, False, False, "wide"),
    (300, 48, 80, 1, 128, True, False, "cluster"),
    (300, 40, 56, 1, 128, False, False, "outside"),
    (47, 48, 80, 0, 256, False, True, "cluster"),
    (49, 48, 80, 1, 16, True, True, "cluster"),
    (257, 48, 80, 0, 64, False, True, "cluster")])
def test_dense_composite_kernels_match_plain(cuda, N, H, W, mode, chunk,
                                             ties, top, layout):
    from fresnel_tpu_torch.render import dense_composite as dc

    params, col = _composite_inputs(N, max(H, W), mode, N + mode, ties, top,
                                    layout)
    params, col = params.to(cuda), col.to(cuda)
    before = (dc.launches, dc.launches_bwd)
    pg = params.clone().requires_grad_()
    cg = col.clone().requires_grad_()
    out, trans = dc.dense_composite(pg, cg, H, W, mode, chunk)
    ref, ref_t = dc.dense_composite_plain(params, col, H, W, mode, chunk)
    assert (dc.launches, dc.launches_bwd) == (before[0] + 1, before[1])
    with torch.no_grad():
        again = dc._launch_fwd(params, col, H, W, mode, chunk)
    assert torch.equal(again[0], out) and torch.equal(again[1], trans)
    listed = again[3][2 * N:2 * N + dc.n_tiles(H, W)]   # each tile's list
    if layout == "wide":
        assert (trans == 0).float().mean().item() > 0.5
    if layout == "cluster":
        assert listed.max().item() == N and (listed > 0).sum().item() == 1
    if layout == "outside":
        assert listed.max().item() == 0
        assert not (out[..., :3] != 0).any() and bool((trans == 1).all())
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(out))
    for got_f, ref_f in ((out[..., :3], ref[..., :3]),
                         (out[..., 3][fin[..., 3]], ref[..., 3][fin[..., 3]]),
                         (trans, ref_t)):
        if ref_f.numel() == 0:
            continue                  # no Gaussian passes anywhere
        s = ref_f.abs().max().item()
        assert (got_f - ref_f).abs().max().item() <= \
            COMPOSITE_TOL * max(s, 1e-30)
    rng = np.random.default_rng(7)
    g_out = torch.from_numpy(rng.normal(size=(H, W, 4)).astype(
        np.float32)).to(cuda)
    g_t = torch.from_numpy(rng.normal(size=(H, W)).astype(
        np.float32)).to(cuda)
    if mode == 1:
        g_out[..., 3] = torch.where(torch.isinf(out[..., 3]).detach(), 0.0,
                                    g_out[..., 3])
    gp, gc = torch.autograd.grad((out, trans), (pg, cg), (g_out, g_t))
    assert dc.launches_bwd == before[1] + 1
    rp, rc = dc.dense_composite_bwd_plain(params, col, H, W, mode, chunk,
                                          g_out, g_t)
    for got_g, ref_g in ((gp, rp), (gc, rc)):
        for f in range(got_g.shape[-1]):
            s = ref_g[..., f].abs().max().item()
            e = (got_g[..., f] - ref_g[..., f]).abs().max().item()
            assert e <= BWD_TOL * max(s, 1e-30), (f, e, s)
    assert not rp[:, 5].any() and not gp[:, 5].any()


def _render_cloud(n, seed):
    rng = np.random.default_rng(seed)
    pos = np.c_[rng.uniform(-0.8, 0.8, (n, 2)),
                rng.uniform(-2.5, -1.5, n)].astype(np.float32)
    sc = rng.uniform(0.03, 0.3, (n, 3)).astype(np.float32)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.1, 0.9, n).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return [torch.from_numpy(a) for a in (pos, sc, rot, col, op)], \
        torch.from_numpy(ph)


@pytest.mark.parametrize("name", ["dense", "simplified", "asm",
                                  "fourier_true"])
def test_renderers_on_card_match_cpu(cuda, name):
    from fresnel_tpu_torch.render.factory import make_renderer

    arrays, ph = _render_cloud(300, 11)
    size = 64
    out = {}
    for dev in ("cpu", cuda):
        args = [a.to(dev).requires_grad_() for a in arrays]
        phs = ph.to(dev).requires_grad_()
        img, depth = make_renderer(name)(*args, Camera.default_training(
            size).to(dev), phases=phs, return_depth=True)
        w = torch.from_numpy(np.random.default_rng(2).normal(
            size=(3, size, size)).astype(np.float32)).to(dev)
        loss = (img * w).sum() + depth.sum()
        grads = torch.autograd.grad(loss, args + [phs], allow_unused=True)
        out[str(dev)] = [img.detach().cpu(), depth.detach().cpu()] + [
            None if g is None else g.cpu() for g in grads]
    cpu, card = out["cpu"], out[str(cuda)]
    for i, (a, b) in enumerate(zip(card, cpu)):
        if b is None:
            assert a is None
            continue
        s = b.abs().max().item()
        tol = 1e-5 if i < 2 else BWD_TOL
        assert (a - b).abs().max().item() <= tol * max(s, 1e-30), (i, s)


@pytest.mark.parametrize("multiscale", [False, True])
def test_diffractive_layers_on_card_match_cpu(cuda, multiscale):
    from fresnel_tpu_torch.physics import (
        DiffractiveLayer, MultiscaleDiffractiveLayer)

    cls = MultiscaleDiffractiveLayer if multiscale else DiffractiveLayer
    m = cls(32, 24, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    field = torch.from_numpy((rng.normal(size=(2, 3, 32, 24))
                              + 1j * rng.normal(size=(2, 3, 32, 24))
                              ).astype(np.complex64))
    res = {}
    for dev in ("cpu", cuda):
        md = m.to(dev)
        f = field.to(dev).requires_grad_()
        o = md(f)
        # A loss that reads the phase (|o| alone does not depend on it).
        g = torch.autograd.grad((o.real - 0.5 * o.imag).sum(),
                                [f] + list(md.parameters()))
        res[str(dev)] = [o.detach().cpu()] + [x.cpu() for x in g]
    for a, b in zip(res[str(cuda)], res["cpu"]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("method", ["counting", "packed"])
def test_quantized_depth_sorts_on_card_equal_cpu(cuda, method):
    from fresnel_tpu_torch.render import projection

    cloud = GaussianCloud.test_cloud(50_000, seed=3, spread=0.8,
                                     z_offset=-2.0)
    cam = Camera.default_training(256)
    proj = projection.project_gaussians(cloud.positions, cloud.scales,
                                        cloud.rotations, cam)
    # The same depths on both devices: the sort alone is held.
    got = projection.depth_sort_indices(
        proj.replace(depths=proj.depths.to(cuda),
                     visible=proj.visible.to(cuda)), method=method)
    want = projection.depth_sort_indices(proj, method=method)
    assert torch.equal(got.cpu(), want)


def test_lpips_on_card_matches_cpu(cuda):
    """LPIPS (random filters, 64^2, batch 2) and its gradients with respect
    to both images on the card against the CPU, float32 with TF32 off:
    distance within 1e-5 relative, gradients within 1e-4 of their largest
    entry; the module stays float32 and frozen on the card."""
    from fresnel_tpu_torch.losses.lpips import random_lpips

    rng = np.random.default_rng(1)
    a, b = (rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
            for _ in range(2))
    res = {}
    for dev in ("cpu", cuda):
        m = random_lpips(0, device=dev)
        assert all(p.device.type == torch.device(dev).type
                   and p.dtype == torch.float32 and not p.requires_grad
                   for p in m.parameters())
        x = torch.from_numpy(a).to(dev).requires_grad_()
        y = torch.from_numpy(b).to(dev).requires_grad_()
        d = m(x, y)
        res[str(dev)] = [d.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(d.sum(), (x, y))]
    (dg, *gg), (dc, *gc) = res[str(cuda)], res["cpu"]
    assert ((dg - dc).abs() / dc.abs()).max().item() <= 1e-5
    for g, c in zip(gg, gc):
        assert (g - c).abs().max().item() <= 1e-4 * c.abs().max().item()


def test_ms_ssim_and_matching_on_card_match_cpu(cuda):
    """ms_ssim at 128^2 (four levels) within 1e-6 of the CPU's with TF32
    switched on (its filter avoids cuDNN), and gaussian_matching_loss with
    subsampling, padding and a mask, every output within 1e-5 relative."""
    from fresnel_tpu_torch.losses.matching import gaussian_matching_loss
    from fresnel_tpu_torch.losses.ssim import ms_ssim

    rng = np.random.default_rng(2)
    a = rng.uniform(size=(2, 3, 128, 128)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.05, size=a.shape), 0, 1).astype(
        np.float32)
    want = ms_ssim(torch.from_numpy(a), torch.from_numpy(b)).item()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        got = ms_ssim(torch.from_numpy(a).to(cuda),
                      torch.from_numpy(b).to(cuda)).item()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    assert abs(got - want) <= 1e-6, (got, want)

    pred = rng.uniform(-1, 1, (2, 300, 14)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 700, 14)).astype(np.float32)
    pred[:, -20:] = 0.0
    tmask = torch.from_numpy(rng.uniform(size=(2, 700)) > 0.2)
    kw = dict(max_match_points=128)
    want = gaussian_matching_loss(torch.from_numpy(pred),
                                  torch.from_numpy(target),
                                  target_mask=tmask, **kw)
    got = gaussian_matching_loss(torch.from_numpy(pred).to(cuda),
                                 torch.from_numpy(target).to(cuda),
                                 target_mask=tmask.to(cuda), **kw)
    for k, v in want.items():
        assert abs(got[k].item() - v.item()) <= 1e-5 * abs(v.item()), k


def test_slat_models_on_card_match_cpu(cuda):
    """The v2 decoders (float32, TF32 off) and the structure predictor on
    the card against the CPU, same weights: outputs within 1e-5 abs;
    occupancy_to_coords on one grid with saturated ties equal on both."""
    from fresnel_tpu_torch.models import slat
    from fresnel_tpu_torch.weights import init_flax_like_

    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.normal(size=(2, 49, 32)).astype(np.float32))
    coords = torch.from_numpy(np.concatenate(
        [np.zeros((2, 40, 1)), rng.integers(0, 64, (2, 40, 3))],
        -1).astype(np.int32))
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, 25:] = False
    models = (slat.DirectSLatDecoder(feature_dim=32, hidden_dim=48,
                                     num_layers=2, num_heads=4,
                                     num_gaussians_per_voxel=2),
              slat.MLPSLatDecoder(feature_dim=32, hidden_dim=48,
                                  num_gaussians_per_voxel=2),
              slat.DirectStructurePredictor(feature_dim=32, hidden_dim=32,
                                            resolution=16))
    for m in models:
        init_flax_like_(m, torch.Generator().manual_seed(0))
        args = ((feats,) if isinstance(m, slat.DirectStructurePredictor)
                else (feats, coords))
        kw = ({"coord_mask": mask}
              if isinstance(m, slat.DirectSLatDecoder) else {})
        with torch.no_grad():
            want = m(*args, **kw)
            got = m.to(cuda)(*[a.to(cuda) for a in args],
                             **{k: v.to(cuda) for k, v in kw.items()})
        if not isinstance(want, dict):
            want, got = dict(enumerate(want)), dict(enumerate(got))
        for k, v in want.items():
            assert (got[k].cpu() - v).abs().max().item() <= 1e-5, (m, k)
    occ = want[0][0].clone()
    occ.view(-1)[::7] = 1.0
    c_cpu, v_cpu = slat.occupancy_to_coords(occ, 300)
    c_gpu, v_gpu = slat.occupancy_to_coords(occ.to(cuda), 300)
    assert torch.equal(c_gpu.cpu(), c_cpu) and torch.equal(v_gpu.cpu(), v_cpu)


def test_v2_render_step_on_card_matches_cpu(cuda):
    """One V2Trainer step with the render loss (dropout 0) on the card and
    on the CPU from one init: every loss term within 1e-4 relative; the
    card's step launches K1 twice (predictions, teachers) and K2 once."""
    from fresnel_tpu_torch.data.trellis import SyntheticTrellisDataset
    from fresnel_tpu_torch.train import train_direct_decoder as v2

    ds = SyntheticTrellisDataset(n_samples=2, max_coords=64,
                                 max_gaussians=256, n_gaussians=256,
                                 feature_dim=32, num_patches=16, seed=4)
    batch = next(iter(ds.batches(2, np.random.default_rng(0))))
    cfg = dict(feature_dim=32, hidden_dim=48, num_layers=2, num_heads=4,
               num_gaussians_per_voxel=2, max_coords=64, max_gaussians=256,
               max_match_points=64, use_render_loss=True)
    res = {}
    for dev in ("cpu", cuda):
        t = v2.V2Trainer(v2.V2Config(**cfg), device=dev)
        t.model.dropout = 0.0
        raster.launches = raster.launches_bwd = 0
        _, ld = t.train_step(t.init_state(), t.device_batch(batch))
        res[str(dev)] = ({k: float(v) for k, v in ld.items()},
                         (raster.launches, raster.launches_bwd))
    (got, launches), (want, _) = res[str(cuda)], res["cpu"]
    assert launches == (2, 1)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 * abs(v), k


def test_smoke_exits_zero_on_card(cuda, capsys):
    """`fresnel-torch smoke`: the device lines, both round trips OK, and K1
    launched once against its plain version."""
    from fresnel_tpu_torch import cli

    raster.launches = 0
    assert cli.main(["smoke"]) == 0
    out = capsys.readouterr().out
    assert "compute roundtrip (1024 elements x2): OK" in out
    assert "large dispatch (1M elements): OK" in out
    assert "kernel round trip" in out and " OK; " in out
    assert raster.launches == 1


def _seed0_rotation_gap(feats, depth):
    """The bridge's seed-0 decoder on the CPU: its rotations in float32
    against float64, relative to their largest value, up to sign."""
    from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
    from fresnel_tpu_torch.weights import init_flax_like_

    m = DirectPatchDecoder(feature_dim=feats.shape[-1], gaussians_per_patch=4)
    init_flax_like_(m, torch.Generator().manual_seed(0))
    with torch.no_grad():
        q32 = m(feats, depth)["rotations"].double()
        q64 = m.double()(feats.double(), depth.double())["rotations"]
    q32 = q32 * torch.sign((q32 * q64).sum(-1, keepdim=True))
    return float((q32 - q64).abs().max() / q64.abs().max())


def test_bridge_decoder_on_card_matches_cpu(cuda, tmp_path):
    """The `decoder` bridge with the committed exp2 checkpoint and without
    one, card against CPU: N x 14 within 1e-5 of each field's largest
    value, quaternions up to sign; the seed-0 decoder's quaternions (a
    badly conditioned 6D -> quaternion step at a random init) within 2 x
    the CPU's own float32-vs-float64 gap on the same inputs."""
    from fresnel_tpu_torch.inference import bridges

    rng = np.random.default_rng(11)
    f = rng.standard_normal((37, 37, 384)).astype(np.float32)
    dm = rng.uniform(size=(256, 256)).astype(np.float32)
    feats, depth = tmp_path / "f.bin", tmp_path / "d.bin"
    f.tofile(feats)
    dm.tofile(depth)
    gap = _seed0_rotation_gap(torch.from_numpy(f)[None],
                              torch.from_numpy(dm)[None])
    for ckpt in ([str(RESULTS / "exp2_model.msgpack")], []):
        out = {}
        for dev in (cuda, "cpu"):
            path = tmp_path / f"g_{dev}.bin"
            assert bridges.cmd_decoder([str(feats), str(depth), str(path),
                                        *ckpt], device=dev) == 0
            out[str(dev)] = np.fromfile(path, np.float32).reshape(-1, 14)
        got, want = out[str(cuda)], out["cpu"]
        assert got.shape == want.shape
        got[:, 6:10] *= np.where(
            np.sum(got[:, 6:10] * want[:, 6:10], -1) < 0, -1, 1)[:, None]
        for a, b in ((0, 3), (3, 6), (6, 10), (10, 13), (13, 14)):
            tol = max(1e-5, 2 * gap) if a == 6 and not ckpt else 1e-5
            assert np.abs(got[:, a:b] - want[:, a:b]).max() \
                <= tol * np.abs(want[:, a:b]).max(), (ckpt, a)


@pytest.mark.parametrize("name", ["exp4", "exp2_g74zi"])
def test_module_traced_on_card_runs_on_cpu(cuda, name, tmp_path):
    """A committed decoder exported on the card (traced and verified
    there) loads with map_location="cpu" and matches the CPU's eager
    decoder within 1e-5 of each field's largest value."""
    import json
    from fresnel_tpu_torch.export import export_decoder as ex

    ckpt = str(RESULTS / f"{name}_model.msgpack")
    out = str(tmp_path / f"{name}.onnx")
    assert ex.main([ckpt, "--onnx", out]) == 0
    config = json.loads(open(ckpt + ".json").read())["config"]
    trainer, _, dec = ex.load_decoder(ckpt, device="cpu")
    x = ex._dummy_inputs(config, trainer.config.feature_dim, seed=5)
    path = out + ".pt"
    if not __import__("os").path.exists(path):   # an ONNX file was written
        _, _, dec_card = ex.load_decoder(ckpt, device=cuda)
        ex.trace(ex.ExportWrapper(dec_card, config["experiment"]),
                 [t.to(cuda) for t in x]).save(path)
    loaded = torch.jit.load(path, map_location="cpu")
    with torch.no_grad():
        err = ex.field_errors(loaded(*x),
                              ex.ExportWrapper(dec, config["experiment"])(*x))
    assert err <= 1e-5


def test_parallel_ranks_on_card(cuda, tmp_path):
    """parallel/ with two gloo ranks on card 0 (`parallel.launch.run_job`;
    NCCL refuses two ranks on one card), each collective staged through a
    host copy: `shard_batch`'s rows, `replicate` from rank 0,
    `pmean_gradients` against the hand mean, `rand_rows` from a CUDA
    generator against the global draw; and the global batch's gradient of
    a small Trainer config (experiment 2, 32^2, batch 4, dropout on,
    depth, SSIM and boundary terms on) against one process on the card:
    within 1e-3 by global norm (4 images a rank pick other cuDNN / cuBLAS
    algorithms than 8), the loss terms within 1e-5, the ranks'
    gradients bit for bit equal."""
    from fresnel_tpu_torch.data import synthetic_corpus
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from fresnel_tpu_torch.parallel import jobs, launch

    data = str(tmp_path / "corpus")
    synthetic_corpus.generate_corpus(data, n_images=4, image_size=32,
                                     seed=3)
    ds = dict(kind="image", data_dir=data, image_size=32, feature_dim=48,
              use_augmentation=True)
    ImageDataset(device=cuda, **{k: v for k, v in ds.items()
                                 if k != "kind"})
    grad = {"task": "gradients", "dataset": ds, "mesh": True, "configs": {
        "config": dict(experiment=2, batch_size=4, image_size=32,
                       feature_size=5, feature_dim=48, encoder_width=8,
                       gaussians_per_patch=2, max_per_tile=64,
                       train_encoder=True, depth_weight=0.1,
                       boundary_weight=0.1, lpips_weight=0.0,
                       output_dir=str(tmp_path / "out")),
        "hfgs": dict(use_phase_retrieval_loss=False,
                     use_frequency_loss=False, learnable_wavelengths=False)}}
    res = launch.run_job([{"task": "mesh_units", "batch": 4}, grad], 2,
                         tmp_path / "job", device="cuda:0", backend="gloo",
                         timeout=300)
    units = [r[0] for r in res]
    want = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    hand = {k: sum(u["grads"][k] for u in units) / 2 for k in ("w", "s")}
    for r, u in enumerate(units):
        assert torch.equal(u["local"]["image"], want[2 * r:2 * r + 2])
        assert torch.equal(u["replicated"]["a"], torch.ones(4))
        for k, w in hand.items():
            torch.testing.assert_close(u["pmean"][k], w, rtol=0, atol=1e-6)
    full = torch.rand((2, 4, 3), generator=torch.Generator(cuda).manual_seed(
        7), device=cuda).cpu()
    assert torch.equal(torch.cat([u["rand_rows"] for u in units], 1), full)
    one = jobs.gradients(dict(grad, mesh=False), cuda)
    two = [r[1] for r in res]
    num = sum(float(((two[0]["grads"][k] - g) ** 2).sum())
              for k, g in one["grads"].items())
    den = sum(float((g ** 2).sum()) for g in one["grads"].values())
    assert (num / den) ** 0.5 <= 1e-3, (num / den) ** 0.5
    for k, v in one["losses"].items():
        assert abs(two[0]["losses"][k] - v) <= 1e-5 * max(abs(v), 1.0), k
    for k, g in two[0]["grads"].items():
        assert torch.equal(g, two[1]["grads"][k]), k
