"""The segment algebra of the compositing kernels K1 and K2, on the CPU:
against the JAX package's interpret-mode compositor and its VJP, against
the plain versions at segment length 128, and the kernels' scratch shape
and segment length.  The helpers, the packs and the tolerances are those
of tests/test_torch_raster_split_plain.py, whose docstring sets out the
algebra: forward at atol 1e-6 and backward per field within 1e-5 of the
field's largest value against the plain versions; against JAX at the
bounds of tests/test_torch_tile.py (forward 2e-5, depth 1e-4) and
tests/test_torch_raster_bwd.py (gradient atol 3e-5, rtol 2e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.render.pallas_raster import composite_tiles_pallas_packed

from fresnel_tpu_torch.render import raster
from test_torch_raster_split_plain import (
    M,
    NTX,
    PATTERNS,
    _counts,
    _cotangents,
    _pack,
    bwd_by_segments,
    check_segments_match_plain,
    composite_by_segments,
)
from test_torch_threads import _few_threads  # noqa: F401



@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("seg", (128,))
def test_segments_match_plain(seg, pattern):
    check_segments_match_plain(seg, pattern)


@pytest.mark.parametrize("pattern,seg", list(zip(PATTERNS, (32, 64, 128, 64,
                                                            32))))
def test_segments_match_pallas(pattern, seg):
    pack, counts = _pack(_counts(pattern, seg), seed=7 + seg)
    gc, gd, gt = _cotangents(11)
    outs, vjp = jax.vjp(
        lambda p: composite_tiles_pallas_packed(
            p, NTX, interpret=True, counts=jnp.asarray(counts)),
        jnp.asarray(pack))
    (ref,) = vjp((jnp.asarray(gc), jnp.asarray(gd), jnp.asarray(gt)))

    tp, tc = torch.from_numpy(pack), torch.from_numpy(counts)
    color, depth, trans, _ = composite_by_segments(tp, tc, NTX, seg)
    for got, want, atol in zip((color, depth, trans), outs,
                               (2e-5, 1e-4, 2e-5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    # The backward from the JAX forward's outputs, as K2 is handed them.
    jc, jd, jt = (torch.from_numpy(np.array(o)) for o in outs)
    grad = bwd_by_segments(tp, tc, NTX, jc, jd, jt, torch.from_numpy(gc),
                           torch.from_numpy(gd), torch.from_numpy(gt), seg)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=2e-3)


@pytest.mark.parametrize("T,M,want", [
    (1024, 256, (4, 1024, 5, 256)),
    (256, 1024, (16, 256, 5, 256)),
    (8, 65, (2, 8, 5, 256))])
def test_scratch_shape(T, M, want):
    assert raster.scratch_shape(T, M) == want


def test_scratch_shape_of_one_segment_is_empty():
    """A pack no longer than one segment needs no scratch."""
    assert raster.scratch_shape(64, raster.SEG) == (0, 64, 5, 256)
    assert raster.scratch_shape(64, 32) == (0, 64, 5, 256)


# An H100 SXM's 132 SMs at eight blocks each.
RESIDENT = 132 * raster.BLOCKS_PER_SM


@pytest.mark.parametrize("counts,M,want", [
    ([0] * 1024, 256, 64),                  # nothing to share: SEG
    ([56] * 1024, 256, 64),                 # the image pack's mean count
    ([256] * 1024, 256, 256),               # every tile at the cap: whole
    ([128] * 1024, 256, 128),
    ([1024] * 256, 1024, 256),              # refine shape, every tile full
    ([70] * 256, 1024, 64),                 # refine shape, the init's mean
    ([200] * 8, 32, 64),                    # M under SEG: one segment
])
def test_segment_length(counts, M, want):
    """The kernels' segment length: the card's share of the slots rounded
    up to SEG, within [SEG, M]; whole tiles where the pack fills the card."""
    L = raster.segment_length(torch.tensor(counts, dtype=torch.int32), M,
                              RESIDENT)
    assert L == want and L % raster.SEG == 0
