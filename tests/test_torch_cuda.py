"""The compositing kernels on the card against their plain versions.

Needs an NVIDIA GPU and nvcc; skips without them.  It imports no JAX, so
on a machine without JAX run it with `--noconftest`:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernels and plain versions differ only in summation order (sequential
transmittance and suffix sums against the chunked cumprod / cumsum, a
warp-shuffle tree against torch's sum over pixels), all in float32: K1 at
atol 1e-5, K2 per field within BWD_TOL = 1e-4 of that field's largest
plain value (chip_smoke.py's bound).
"""

import numpy as np
import pytest
import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import raster
from fresnel_tpu_torch.render import tile

pytestmark = pytest.mark.cuda
BWD_TOL = 1e-4


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


@pytest.mark.parametrize("T,M,ntx", [(6, 64, 3), (64, 256, 8), (1024, 256, 32),
                                     (256, 1024, 16)])
def test_kernel_matches_plain(cuda, T, M, ntx):
    rng = np.random.default_rng(T)
    counts = rng.integers(0, M + 1, T)
    counts[0], counts[-1] = 0, M
    pack, cnt = _pack(T, M, counts, T, ntx * 16)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    before = raster.launches
    got = raster.composite_tiles_packed(pack, cnt, ntx)
    torch.cuda.synchronize()
    assert raster.launches == before + 1
    ref = raster.composite_tiles_plain(pack, cnt, ntx)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.is_cuda
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def test_wrapper_rejects_bad_inputs(cuda):
    pack, cnt = _pack(4, 32, [1, 2, 3, 4], 0, 32)
    pack, cnt = pack.to(cuda), cnt.to(cuda)
    with pytest.raises(TypeError):
        raster.composite_tiles_packed(pack.double(), cnt, 2)
    with pytest.raises(ValueError):
        raster.composite_tiles_packed(pack[:, ::2], cnt, 2)
    with pytest.raises(ValueError):
        raster.composite_tiles_packed(pack, cnt.long(), 2)


@pytest.mark.parametrize("n,res", [(300, 64), (5000, 256)])
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


@pytest.mark.parametrize("T,M,ntx", [(6, 64, 3), (64, 256, 8), (256, 1024, 16)])
def test_bwd_kernel_matches_plain(cuda, T, M, ntx):
    rng = np.random.default_rng(T + 1)
    counts = rng.integers(0, M + 1, T)
    counts[0], counts[-1] = 0, M
    pack, cnt = _pack(T, M, counts, T, ntx * 16)
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
