"""The segment algebra of the compositing kernels K1 and K2, on the CPU:
the plain versions at segment lengths 32 and 64.

K1 and K2 (csrc/raster_common.cuh) split each tile's depth-ordered list
into segments of L slots that run in parallel, L a multiple of SEG = 64
that the kernels choose from the pack's work; the algebra is held here at
several lengths.  The forward composites
each segment from T = 1 and folds the partials in order,

    (C, D, T)(a then b) = (C_a + T_a C_b, D_a + T_a D_b, T_a T_b),

leaving each segment's prefix: the sums P of the segments before it and the
transmittance T_in at its start.  The backward runs each segment from
T_in with suffix sums S_in = S_total - P.  The helpers here do the same with
the plain functions, segment by segment, and are held against:

* `composite_tiles_plain`, forward at atol 1e-6, and
  `composite_tiles_bwd_plain`, per field within 1e-5 of the field's largest
  value, both in float32: the two sides differ only in rounding;
* the JAX package's `composite_tiles_pallas_packed` (interpret) and
  `jax.vjp` of it, at the bounds tests/test_torch_tile.py (forward: 2e-5,
  depth 1e-4) and tests/test_torch_raster_bwd.py (gradient: atol 3e-5,
  rtol 2e-3) hold the plain versions to
  (tests/test_torch_raster_split_jax.py, with length 128 against the plain
  versions and the kernels' scratch shape and segment length).

The plain backward starts at T = 1; for a segment that starts at T_in it is
called on S_in / T_in and T_fin / T_in with the cotangents scaled by T_in,
which gives the same gradient (every term is linear in T_in).
"""

import numpy as np
import pytest
import torch

from fresnel_tpu_torch.render import raster
from test_torch_threads import _few_threads  # noqa: F401


T_TILES, M, NTX = 16, 256, 4            # a 64^2 image, 4 x 4 tiles
LENGTHS = (32, 64)                      # segment lengths of this file
FIELD_RTOL = 1e-5


def _counts(pattern, seg):
    if pattern == "cap":
        return [M] * T_TILES
    if pattern == "around_seg":
        return [(seg - 1, seg, seg + 1)[i % 3] for i in range(T_TILES)]
    if pattern == "empty":
        return [0, 0, 0, 0, 5, 0, M, 0, 0, seg, 0, 0, 0, 0, 0, 0]
    if pattern == "one_slot":
        return [1] * T_TILES
    if pattern == "heavy_among_empty":
        return [0] * 5 + [M] + [0] * (T_TILES - 6)
    raise ValueError(pattern)


def _pack(counts, seed):
    """A numpy-seeded pack of the kernels' layout; dead slots masked."""
    rng = np.random.default_rng(seed)
    shape = (T_TILES, M)
    width = NTX * 16
    pack = np.zeros(shape + (12,), np.float32)
    pack[..., 0] = rng.uniform(-4, width + 4, shape)
    pack[..., 1] = rng.uniform(-4, width + 4, shape)
    pack[..., 2] = rng.uniform(0.01, 0.2, shape)
    pack[..., 3] = rng.uniform(-0.01, 0.01, shape)
    pack[..., 4] = rng.uniform(0.01, 0.2, shape)
    pack[..., 5] = rng.uniform(2, 20, shape)
    pack[..., 6:9] = rng.uniform(0, 1, shape + (3,))
    pack[..., 9] = rng.uniform(0, 1, shape)
    pack[..., 10] = rng.uniform(1, 3, shape)
    counts = np.asarray(counts, np.int32)
    dead = np.arange(M)[None, :] >= counts[:, None]
    pack[dead] = 0.0
    pack[dead, 5] = -1.0
    return pack, counts


def _cotangents(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((T_TILES, 256, 3), (T_TILES, 256), (T_TILES, 256))]


def _segment(pack, counts, seg, k):
    """Segment k's slots of every tile, and how many of them are occupied."""
    sub = pack[:, k * seg:(k + 1) * seg].contiguous()
    return sub, (counts - k * seg).clamp(0, sub.shape[1]).to(torch.int32)


def composite_by_segments(pack, counts, ntx, seg):
    """The forward segment by segment: (color, depth, trans, prefixes),
    prefixes a list of (P (T, 256, 4), T_in (T, 256)), one per segment."""
    T = pack.shape[0]
    acc = torch.zeros((T, 256, 4), dtype=pack.dtype)
    tr = torch.ones((T, 256), dtype=pack.dtype)
    prefixes = []
    for k in range(-(-pack.shape[1] // seg)):
        c, d, t = raster.composite_tiles_plain(*_segment(pack, counts, seg, k),
                                               ntx)
        prefixes.append((acc, tr))
        acc = acc + tr[..., None] * torch.cat([c, d[..., None]], -1)
        tr = tr * t
    return acc[..., :3], acc[..., 3], tr, prefixes


def bwd_by_segments(pack, counts, ntx, color, depth, trans, g_color, g_depth,
                    g_trans, seg):
    """The backward segment by segment from each segment's (T_in, S_in)."""
    *_, prefixes = composite_by_segments(pack, counts, ntx, seg)
    s_total = torch.cat([color, depth[..., None]], -1)
    grads = []
    for k, (P, t_in) in enumerate(prefixes):
        s_in = (s_total - P) / t_in[..., None]
        grads.append(raster.composite_tiles_bwd_plain(
            *_segment(pack, counts, seg, k), ntx, s_in[..., :3].contiguous(),
            s_in[..., 3].contiguous(), trans / t_in,
            g_color * t_in[..., None], g_depth * t_in, g_trans * t_in))
    return torch.cat(grads, 1)


def _assert_fields_close(got, ref, rtol):
    for f in range(12):
        scale = ref[..., f].abs().max().item()
        err = (got[..., f] - ref[..., f]).abs().max().item()
        assert err <= rtol * max(scale, 1e-30), (f, err, scale)


PATTERNS = ["cap", "around_seg", "empty", "one_slot", "heavy_among_empty"]


def check_segments_match_plain(seg, pattern):
    """The segment algebra against the plain versions at length `seg`."""
    pack, counts = _pack(_counts(pattern, seg), seed=seg + len(pattern))
    tp, tc = torch.from_numpy(pack), torch.from_numpy(counts)
    outs = raster.composite_tiles_plain(tp, tc, NTX)
    got = composite_by_segments(tp, tc, NTX, seg)
    for g, r in zip(got[:3], outs):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)
    n_seg = -(-M // seg)
    assert len(got[3]) == n_seg
    if pattern == "empty":
        assert torch.all(outs[2][0] == 1) and torch.all(outs[0][0] == 0)

    cots = [torch.from_numpy(c) for c in _cotangents(seg)]
    ref = raster.composite_tiles_bwd_plain(tp, tc, NTX, *outs, *cots)
    grad = bwd_by_segments(tp, tc, NTX, *outs, *cots, seg=seg)
    assert grad.shape == ref.shape
    _assert_fields_close(grad, ref, FIELD_RTOL)
    dead = torch.arange(M)[None, :] >= tc[:, None]
    assert torch.all(grad[dead] == 0)




@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seg", LENGTHS)
def test_segments_match_plain(seg, pattern):
    check_segments_match_plain(seg, pattern)
