"""The packed gather and the batched render, on the CPU.

`render.tile.gather_pack` gathers only the occupied slots into a pack
filled with the sentinel row, so its backward scatters from those slots
alone.  Held here against the formulation it replaced (every slot gathered
through a sentinel row appended to the per-Gaussian table) on the refine
pack at 64^2 (grid 8, K 4, 256 Gaussians, max_per_tile 256) and on a
pack with tiles at the cap:
* the pack: bit for bit (the occupied slots are a prefix of each tile);
* the gradient of the per-Gaussian table: bit for bit against the old
  formulation on one thread, and against an explicit scatter of the
  occupied slots in slot order.  The old one also summed every empty slot
  into the sentinel row, which is dropped.  On several threads the old
  formulation's CPU scatter reorders its sums: measured up to 9.5e-7 (one
  ulp of its largest entry, 7.79) against the slot-order sum, where the
  new one stays bit for bit on any thread count (measured: 0.0).

`render.tile.render_tiled_batched` renders B clouds through one (B * T, M,
12) pack and one compositing call; on the CPU each image, depth map,
overflow row and the gradient of every input equal B separate
`render_tiled` calls bit for bit (measured: 0.0).
"""

import numpy as np
import pytest
import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.gaussians import GaussianCloud
from fresnel_tpu_torch.models.decoders import head_transform
from fresnel_tpu_torch.models.encoders import gradient_depth_estimate
from fresnel_tpu_torch.render import tile
from fresnel_tpu_torch.train import fit_teacher
from test_torch_threads import _few_threads  # noqa: F401


FIELDS = ("positions", "scales", "rotations", "colors", "opacities")


def _old_gather(fields, tile_idx, tile_valid):
    """The replaced formulation: a sentinel row appended to the table and
    every slot gathered, empty ones through the sentinel."""
    n = fields.shape[0]
    sentinel = torch.zeros((1, tile.PACK), dtype=fields.dtype)
    sentinel[0, 5] = tile.SENTINEL_RADIUS
    table = torch.cat([fields, sentinel], dim=0)
    return table[torch.where(tile_valid, tile_idx, n).long()]


def _refine_cloud():
    y, x = np.mgrid[0:64, 0:64] / 64.0
    image = np.stack([0.5 + 0.3 * np.sin(2 * np.pi * (c + 1) * x)
                      * np.cos(2 * np.pi * y) for c in range(3)]
                     ).astype(np.float32)
    depth = gradient_depth_estimate(
        torch.from_numpy(image.transpose(1, 2, 0).copy()), 64).numpy()
    cam = Camera.default_training(64)
    raw = fit_teacher.init_raw(image, depth, cam, grid=8, K=4)
    head = head_transform(torch.from_numpy(raw), torch.from_numpy(depth)[None],
                          torch.tensor(-0.13))
    return [head[k][0] for k in FIELDS], cam, 256


def _dense_cloud():
    cloud = GaussianCloud.test_cloud(600, seed=5, spread=0.4, z_offset=-2.0,
                                     scale=0.08)
    return ([getattr(cloud, k) for k in FIELDS], Camera.default_training(64),
            64)


@pytest.mark.parametrize("make", [_refine_cloud, _dense_cloud],
                         ids=["refine_64", "tiles_at_cap"])
def test_gather_matches_old_formulation(make):
    inputs, cam, mpt = make()
    cfg = tile.TileRendererConfig(max_per_tile=mpt)
    sp = tile.project_sorted(*inputs, cam, cfg)
    n = inputs[0].shape[0]
    m_cap = -(-min(mpt, n) // cfg.chunk) * cfg.chunk
    idx, valid = tile.bin_tiles(sp.means2d, sp.radii, sp.visible, 4, 4, m_cap,
                                cfg)
    fields = tile._pack_fields(sp).detach()
    new_f = fields.clone().requires_grad_()
    old_f = fields.clone().requires_grad_()
    new = tile._gather_rows(new_f, idx, valid)
    old = _old_gather(old_f, idx, valid)
    assert torch.equal(new, old)
    pack, counts = tile.gather_pack(sp, idx, valid)
    assert torch.equal(pack, old) and torch.equal(counts, valid.sum(1).int())
    if make is _dense_cloud:
        assert int(counts.max()) == m_cap        # some tiles are at the cap
    cot = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(new.shape)).astype(np.float32))
    in_order = torch.zeros_like(fields).index_put_(
        (idx[valid].long(),), cot[valid], accumulate=True)
    threads = torch.get_num_threads()
    try:
        for nt in (1, 4):
            torch.set_num_threads(nt)
            (g_new,) = torch.autograd.grad((new * cot).sum(), new_f,
                                           retain_graph=True)
            assert torch.equal(g_new, in_order)
        torch.set_num_threads(1)
        (g_old,) = torch.autograd.grad((old * cot).sum(), old_f)
        assert torch.equal(g_new, g_old)
    finally:
        torch.set_num_threads(threads)


def _clouds(B, n, seed):
    out = []
    for b in range(B):
        c = GaussianCloud.test_cloud(n, seed=seed + b, spread=0.5,
                                     z_offset=-2.0, scale=0.06)
        out.append([getattr(c, k) for k in FIELDS])
    return [torch.stack(f) for f in zip(*out)]


@pytest.mark.parametrize("B,n,res,mpt,poses", [
    (3, 300, 64, 256, False),       # M 256
    (2, 20, 32, 128, False),        # N <= 32: M 32
    (2, 70, 48, 128, True),         # M 96 by the m_cap rounding, two poses
])
def test_batched_render_equals_separate_renders(B, n, res, mpt, poses):
    batch = [t.clone().requires_grad_() for t in _clouds(B, n, 11)]
    cams = ([Camera.from_pose(0.2 * b, 0.5 * b, res) for b in range(B)]
            if poses else Camera.default_training(res))
    cfg = tile.TileRendererConfig(max_per_tile=mpt)
    img, dep, ovf = tile.render_tiled_batched(*batch, cams, config=cfg)
    assert img.shape == (B, 3, res, res) and dep.shape == (B, res, res)
    assert ovf.shape == (B, 4) and ovf.dtype == torch.int32
    rng = np.random.default_rng(3)
    ci = torch.from_numpy(rng.normal(size=tuple(img.shape)).astype(np.float32))
    cd = torch.from_numpy(rng.normal(size=tuple(dep.shape)).astype(np.float32))
    grads = torch.autograd.grad((img * ci).sum() + (dep * cd).sum(), batch)
    for b in range(B):
        one = [t[b].detach().clone().requires_grad_() for t in batch]
        cam = cams[b] if poses else cams
        i1, d1, o1 = tile.render_tiled(*one, cam, return_depth=True,
                                       return_overflow=True, config=cfg)
        assert torch.equal(img[b], i1) and torch.equal(dep[b], d1)
        assert torch.equal(ovf[b], o1)
        g1 = torch.autograd.grad((i1 * ci[b]).sum() + (d1 * cd[b]).sum(),
                                 one)
        for g, h in zip(grads, g1):
            assert torch.equal(g[b], h)
