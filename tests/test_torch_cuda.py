"""The compositing kernel on the card against its plain version.

Needs an NVIDIA GPU and nvcc; skips without them.  It imports no JAX, so
on a machine without JAX run it with `--noconftest`:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Kernel and plain version differ only in summation order (sequential
transmittance against the chunked cumprod), both in float32: atol 1e-5.
"""

import numpy as np
import pytest
import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render import raster
from fresnel_tpu_torch.render import tile

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("T,M,ntx", [(6, 64, 3), (64, 256, 8), (1024, 256, 32)])
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
