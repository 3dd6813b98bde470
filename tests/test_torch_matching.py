"""Port parity: the Chamfer Gaussian-matching loss (losses/matching.py)
against the JAX package, on the CPU, float32.

* `gaussian_matching_loss`, batch 2, (B, N, 14) rows of position, scale,
  quaternion, colour, opacity: all seven outputs within 1e-5 relative,
  with subsampling off (the default 4 096 points) and on (8 predictions
  of 27, 16 targets of 45, non-integer strides), with zero-padded rows
  and masks on both sides, custom weights, and planted exact ties (a
  target duplicated at a higher index with other attributes, so only
  the lower index gives JAX's answer); the matches themselves equal.
* `occupancy_bce_loss`, with and without a mask, within 1e-6 relative;
  `proximity_occupancy_targets` equal, voxels on the threshold's edge
  included.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.losses import matching as jm

from fresnel_tpu_torch.losses import matching as tm
from test_torch_threads import _few_threads  # noqa: F401


def _gaussians(rng, B, N, pad=0):
    g = np.concatenate([
        rng.uniform(-1, 1, (B, N, 3)),            # position
        rng.uniform(-4, -1, (B, N, 3)),           # scale (log)
        rng.normal(size=(B, N, 4)),               # quaternion
        rng.uniform(0, 1, (B, N, 3)),             # colour
        rng.uniform(0, 1, (B, N, 1))], -1).astype(np.float32)
    if pad:
        g[:, -pad:] = 0.0                         # zero-padded rows
    return g


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "plain":
        return dict(pred=_gaussians(rng, 2, 40), target=_gaussians(rng, 2, 70))
    if name == "padded_masked":
        pm = rng.uniform(size=(2, 40)) > 0.2
        tmask = rng.uniform(size=(2, 70)) > 0.3
        return dict(pred=_gaussians(rng, 2, 40, pad=6),
                    target=_gaussians(rng, 2, 70, pad=9),
                    pred_mask=pm, target_mask=tmask)
    if name == "subsampled":
        pm = rng.uniform(size=(2, 27)) > 0.2
        return dict(pred=_gaussians(rng, 2, 27, pad=3),
                    target=_gaussians(rng, 2, 45, pad=4), pred_mask=pm,
                    max_match_points=8,
                    weights=dataclasses.replace(jm.MatchingWeights(),
                                                position=3.0, coverage=2.5))
    # "ties": targets 40-49 repeat the positions of targets 0-9 with other
    # scales, rotations, colours and opacities; predictions 0-9 sit on
    # targets 0-9, and 10-19 at (2, 2, 2), outside the others' cube, on
    # the exact dyadic midpoint of targets 20-29 and 50-59.
    pred, target = _gaussians(rng, 2, 30), _gaussians(rng, 2, 60)
    target[:, 40:50, :3] = target[:, 0:10, :3]
    pred[:, 0:10, :3] = target[:, 0:10, :3]
    target[:, 20:30, :3] = np.float32(1.75)
    target[:, 50:60, :3] = np.float32(2.25)
    pred[:, 10:20, :3] = np.float32(2.0)
    return dict(pred=pred, target=target)


CASES = ["plain", "padded_masked", "subsampled", "ties"]


@pytest.mark.parametrize("name", CASES)
def test_matching_loss_matches_jax(name):
    kw = _case(name)
    w = kw.pop("weights", jm.MatchingWeights())
    want = jm.gaussian_matching_loss(
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}, weights=w)
    got = tm.gaussian_matching_loss(
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()},
        weights=tm.MatchingWeights(**dataclasses.asdict(w)))
    assert set(got) == set(want) == {"total", "position", "scale",
                                     "rotation", "color", "opacity",
                                     "coverage"}
    for k, v in want.items():
        v = float(v)
        assert abs(got[k].item() - v) <= 1e-5 * abs(v), (k, got[k].item(), v)


@pytest.mark.parametrize("name", CASES)
def test_matches_and_subsample_equal_jax(name):
    """The nearest indices of both directions (after the subsample and the
    validity masks) are JAX's, index for index."""
    kw = _case(name)
    k = kw.get("max_match_points", 4096)
    for side, mask_key, kk in (("pred", "pred_mask", k),
                               ("target", "target_mask", 2 * k)):
        g, m = kw[side], kw.get(mask_key)
        jv = jm._valid_mask(jnp.asarray(g), None if m is None
                            else jnp.asarray(m))
        tv = tm._valid_mask(torch.from_numpy(g), None if m is None
                            else torch.from_numpy(m))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jg, jmask = jax.vmap(lambda a, b: jm._subsample(a, b, kk))(
            jnp.asarray(g), jv)
        tg, tmask = tm._subsample(torch.from_numpy(g), tv, kk)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        kw[side], kw[mask_key] = np.array(jg), np.array(jmask)
    p, t = kw["pred"], kw["target"]
    pv, tv = kw["pred_mask"], kw["target_mask"]
    for a, b, bv in ((p, t, tv), (t, p, pv)):
        want = jax.vmap(jm._nearest)(jnp.asarray(a[..., :3]),
                                     jnp.asarray(np.ones(a.shape[:2], bool)),
                                     jnp.asarray(b[..., :3]),
                                     jnp.asarray(bv))
        got = tm._nearest(torch.from_numpy(a[..., :3]),
                          torch.from_numpy(b[..., :3]), torch.from_numpy(bv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if name == "ties":
        # Ties go to the lower index: a prediction on a duplicated target
        # matches the first copy; the midpoint's the first of 20-29.
        near = tm._nearest(torch.from_numpy(p[..., :3]),
                           torch.from_numpy(t[..., :3]),
                           torch.from_numpy(tv))
        assert (near[:, :10] == torch.arange(10)).all()
        assert (near[:, 10:20] == 20).all()


def test_occupancy_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(scale=4.0, size=(3, 200)).astype(np.float32)
    targets = (rng.uniform(size=(3, 200)) > 0.5).astype(np.float32)
    mask = rng.uniform(size=(3, 200)) > 0.25
    for m in (None, mask):
        want = float(jm.occupancy_bce_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m)))
        got = tm.occupancy_bce_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m)).item()
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)

    G = 64
    coords = np.concatenate([np.zeros((300, 1)), rng.integers(
        0, G, (300, 3))], 1).astype(np.int32)
    pos = rng.uniform(-1, 1, (150, 3)).astype(np.float32)
    # Gaussians exactly 0.125 (= threshold, dyadic) from a voxel centre.
    centre = coords[:10, 1:4].astype(np.float32) / G * 2 - 1
    pos[:10] = centre + np.float32(0.125) * np.array([1, 0, 0], np.float32)
    coord_valid = rng.uniform(size=300) > 0.1
    gauss_valid = rng.uniform(size=150) > 0.2
    for thr in (0.15, 0.125):
        want = np.asarray(jm.proximity_occupancy_targets(
            jnp.asarray(coords), jnp.asarray(pos), jnp.asarray(coord_valid),
            jnp.asarray(gauss_valid), threshold=thr, grid_resolution=G))
        got = tm.proximity_occupancy_targets(
            torch.from_numpy(coords), torch.from_numpy(pos),
            torch.from_numpy(coord_valid), torch.from_numpy(gauss_valid),
            threshold=thr, grid_resolution=G)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < 300
