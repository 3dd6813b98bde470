"""Port parity: decoder experiments 1 (SAAGRefinementNet), 3
(FeatureGuidedSAAG) and 5 (NCAGaussianDecoder) against the JAX package,
on the CPU, with the JAX params converted by `weights.decoder_state_dict`
/ `weights.trainer_params`.

* Forwards (random weights perturbed off their zero inits, 37^2 x 64
  features): every field within 2e-6 of JAX's, rotations of experiment 1
  within 2e-5 (the 6D Gram-Schmidt of nearly parallel axes magnifies the
  MLP's ~1e-7 differences, as for experiment 4; measured 5.1e-6), the
  NCA's positions within 2e-6 (measured 4.8e-7 after 4 steps).
* The NCA's neighbour sets step by step: equal, or where a set differs,
  the swapped pair's distances within 4 ulp of each other (measured: no
  set differs).
* `saag_prior_from_depth` over a batch of 2 (64^2, subsample 8) against
  the JAX package's vmapped prior: positions and rotations within 1e-6,
  the other fields equal.
* One `Trainer` step per experiment at 32^2, n_spiral_points 55, nca_steps
  2, batch 2 (tests/test_experiments.py::test_one_train_step's config),
  dropout 0 on both sides, the NCA's update masks JAX's own draws: each
  loss term within 1e-4 relative; each parameter leaf after the step
  within 2 * lr of JAX's (Adam's first step is about lr * sign(g)) and its
  mean within 1e-7.
* infer / eval with a sidecar: an experiment-5 checkpoint written by the
  JAX trainer decodes in the port's `cli infer` to the JAX cli's PLY
  (fields within 1e-5 of their largest value); for experiments 1 and 3
  the JAX cli fails (its `model.apply(params, feats, depth)` cannot feed
  these modules), and the port raises a ValueError that says so.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.core import io as jio
from fresnel_tpu.data.dataset import SyntheticGaussianDataset as JSynth
from fresnel_tpu.models import blocks as jblocks
from fresnel_tpu.models.nca import NCAGaussianDecoder as JNCA
from fresnel_tpu.models.saag_refine import (
    FeatureGuidedSAAG as JFG, SAAGRefinementNet as JRefine)
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer
from fresnel_tpu.train.harness import saag_prior_from_depth as jprior

from fresnel_tpu_torch import cli
from fresnel_tpu_torch.core import io as tio
from fresnel_tpu_torch.models.blocks import FeatureInterpolator, bilinear_sample
from fresnel_tpu_torch.models.nca import NCAGaussianDecoder, knn_indices
from fresnel_tpu_torch.models.saag_refine import (
    FeatureGuidedSAAG, SAAGRefinementNet)
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train.harness import (
    SAAG_SUBSAMPLE, Trainer, build_decoder, saag_prior_from_depth)
from fresnel_tpu_torch.weights import decoder_state_dict, trainer_params
from test_torch_threads import _few_threads  # noqa: F401

FIELDS = ("positions", "scales", "rotations", "colors", "opacities")
C = 64


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, 37, 37, C)).astype(np.float32)
    depth = rng.uniform(size=(b, 64, 64)).astype(np.float32)
    return feats, depth


def _perturb(params, seed, scale):
    """Params moved off their inits (the zero-initialised output layers
    included), so every path carries signal."""
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree.unflatten(tree, [
        x + scale * jax.random.normal(k, jnp.shape(x))
        for x, k in zip(leaves, keys)])


def _load(module, params):
    module.load_state_dict(decoder_state_dict(
        {k: np.asarray(v) for k, v in
         flatten_dict(params["params"], sep="/").items()}))
    return module


def _close(got, want, atol, key=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=key)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    pos = rng.uniform(-0.2, 1.2, size=(2, 40, 2)).astype(np.float32)
    want = jax.vmap(jblocks.bilinear_sample)(jnp.asarray(f), jnp.asarray(pos))
    got = FeatureInterpolator()(torch.from_numpy(f), torch.from_numpy(pos))
    _close(got, want, 1e-6)
    one = bilinear_sample(torch.from_numpy(f[0]), torch.from_numpy(pos[0]))
    _close(one, want[0], 1e-6)


def test_saag_prior_matches_jax():
    _, depth = _inputs()
    want = jprior(jnp.asarray(depth))
    got = saag_prior_from_depth(torch.from_numpy(depth))
    n = (64 // SAAG_SUBSAMPLE) ** 2
    for k, w in want.items():
        assert got[k].shape == tuple(w.shape) and w.shape[:2] == (2, n)
        tol = 1e-6 if k in ("saag_positions", "saag_rotations") else 0.0
        _close(got[k], w, tol, k)


def test_refinement_forward_matches_jax():
    feats, depth = _inputs()
    saag = jprior(jnp.asarray(depth))
    j = JRefine(feature_dim=C)
    params = _perturb(j.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                             **saag), 3, 0.02)
    want = jax.jit(lambda p, f, s: j.apply(p, f, **s))(
        params, jnp.asarray(feats), saag)
    t = _load(SAAGRefinementNet(feature_dim=C), params)
    with torch.no_grad():
        got = t(torch.from_numpy(feats),
                **{k: torch.from_numpy(np.array(v))
                   for k, v in saag.items()})
    for k in FIELDS:
        _close(got[k], want[k], 2e-5 if k == "rotations" else 2e-6, k)
    for k, w in want["residuals"].items():
        _close(got["residuals"][k], w, 2e-7, k)


def test_feature_guided_forward_matches_jax():
    feats, _ = _inputs()
    j = JFG(feature_dim=C)
    params = j.init(jax.random.PRNGKey(0), jnp.asarray(feats))
    t = _load(FeatureGuidedSAAG(feature_dim=C), params)
    neutral = t(torch.from_numpy(feats))
    assert torch.equal(neutral["base_size_mult"],
                       torch.ones(2, 37, 37))
    params = _perturb(params, 4, 0.1)
    want = j.apply(params, jnp.asarray(feats))
    with torch.no_grad():
        got = _load(t, params)(torch.from_numpy(feats))
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, 2e-6, k)


@pytest.fixture(scope="module")
def nca():
    feats, depth = _inputs()
    j = JNCA(feature_dim=C, n_points=55, n_steps=4)
    params = _perturb(j.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                             jnp.asarray(depth)), 5, 0.05)
    t = _load(NCAGaussianDecoder(feature_dim=C, n_points=55, n_steps=4),
              params)
    return j, params, t, feats, depth


def test_nca_forward_matches_jax(nca):
    j, params, t, feats, depth = nca
    want = jax.jit(j.apply)(params, jnp.asarray(feats), jnp.asarray(depth))
    with torch.no_grad():
        got = t(torch.from_numpy(feats), torch.from_numpy(depth))
    for k in FIELDS:
        _close(got[k], want[k], 2e-6, k)


def test_nca_neighbours_match_jax_step_by_step(nca):
    """The kNN sets of each step, from each side's own state after s
    steps (the modules' n_steps override)."""
    j, params, t, feats, depth = nca

    @jax.jit
    def jax_knn(pos):
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        dists = jnp.sqrt(jnp.sum(diff * diff, -1) + 1e-12)
        return jax.lax.top_k(-dists, 7)[1][..., 1:], dists

    apply = jax.jit(j.apply, static_argnames="n_steps")
    parted = 0
    for s in range(4):
        jpos = apply(params, jnp.asarray(feats), jnp.asarray(depth),
                     n_steps=s)["positions"]
        with torch.no_grad():
            tpos = t(torch.from_numpy(feats), torch.from_numpy(depth),
                     n_steps=s)["positions"]
        want, dists = jax_knn(jpos)
        got = knn_indices(tpos, 6).numpy()
        want, dists = np.asarray(want), np.asarray(dists)
        for b, i in zip(*np.nonzero((np.sort(got, -1)
                                     != np.sort(want, -1)).any(-1))):
            parted += 1
            d = dists[b, i]
            swapped = np.setxor1d(got[b, i], want[b, i])
            gap = np.ptp(d[swapped])
            assert gap <= 4 * np.spacing(d[swapped].max()), (s, b, i, gap)
    assert parted == 0


def test_nca_masks_gate_the_update(nca):
    _, _, t, feats, depth = nca
    f, d = torch.from_numpy(feats), torch.from_numpy(depth)
    with torch.no_grad():
        full = t(f, d)
        ones = t(f, d, deterministic=False,
                 masks=torch.ones(4, 2, 55, 1))
        none = t(f, d, deterministic=False,
                 masks=torch.zeros(4, 2, 55, 1))
        frozen = t(f, d, n_steps=0)
        g1 = t(f, d, deterministic=False,
               generator=torch.Generator().manual_seed(1))
        g2 = t(f, d, deterministic=False,
               generator=torch.Generator().manual_seed(1))
    for k in FIELDS:
        assert torch.equal(full[k], ones[k])
        assert torch.equal(none[k], frozen[k])
        assert torch.equal(g1[k], g2[k])
    assert not torch.equal(g1["scales"], full["scales"])


def test_knn_ties_go_to_the_lower_index():
    pos = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0], [5.0, 0.0, 0.0]]])
    assert knn_indices(pos, 3)[0, 0].tolist() == [1, 2, 3]


# ----------------------------------------------------------------------
# One Trainer step per experiment against the JAX trainer
# ----------------------------------------------------------------------

LR = 1e-4
CFG = dict(epochs=1, batch_size=2, image_size=32, gaussians_per_patch=1,
           n_spiral_points=55, nca_steps=2, lpips_weight=0.0, lr=LR)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)


def _flat(params):
    out = {}
    for k, v in params.items():
        for kk, vv in flatten_dict(v, sep="/").items():
            out[f"{k}/{kk}"] = np.array(vv)
    return out


def _jax_nca_masks(key, shape):
    """The update masks the JAX step draws from its key: the step splits
    it in three, hands the module fold_in(the second, 1) as its "nca"
    stream, and the module's make_rng folds that in once more (at the
    root scope)."""
    import flax.linen as nn

    class Probe(nn.Module):
        @nn.compact
        def __call__(self):
            return self.make_rng("nca")

    _, rng_drop, _ = jax.random.split(key, 3)
    rng = Probe().apply({}, rngs={"nca": jax.random.fold_in(rng_drop, 1)})
    return np.asarray(jax.random.uniform(rng, shape) < 0.5, np.float32)


@pytest.fixture(scope="module", params=[1, 3, 5])
def step_pair(request, tmp_path_factory):
    exp = request.param
    root = tmp_path_factory.mktemp(f"exp{exp}")
    ds = JSynth(n_samples=2, image_size=32, n_gaussians=30, seed=exp)
    batch = next(iter(ds.batches(2, np.random.default_rng(0))))
    jt = JTrainer(jconfig.TrainingConfig(experiment=exp,
                                         output_dir=str(root), **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    if exp == 1:
        jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(1)
    state = jt.init_state(batch)
    # Off the zero inits, so every leaf's gradient carries signal.
    state["params"] = _perturb(state["params"], 7, 0.02)
    state["opt_state"] = jt.optimizer.init(state["params"])
    init = _flat(state["params"])
    key = jax.random.PRNGKey(0)
    new, ld = jt.get_step(1, None)(state, jax.tree.map(jnp.asarray, batch),
                                   key)
    masks = None
    if exp == 5:
        masks = torch.from_numpy(_jax_nca_masks(key, (2, 2, 55, 1)))

    t = Trainer(tconfig.TrainingConfig(experiment=exp,
                                       output_dir=str(root), **CFG),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    t._make_optimizer(1)
    params = {k: v.clone() for k, v in trainer_params(init).items()}
    assert set(params) == {f"model.{k}" for k, _ in
                           t.model.named_parameters()}
    tstate = {"params": params, "opt_state": t.optimizer.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    tnew, tld = t.train_step(tstate, t.device_batch(batch), 1, None,
                             torch.Generator().manual_seed(0),
                             nca_masks=masks)
    return dict(exp=exp, want_ld={k: float(v) for k, v in ld.items()},
                got_ld={k: float(v) for k, v in tld.items()},
                want=trainer_params(_flat(new["params"])),
                got=tnew["params"], trainer=t, jtrainer=jt)


def test_one_step_losses_match_jax(step_pair):
    want, got = step_pair["want_ld"], step_pair["got_ld"]
    assert set(want) == set(got)
    if step_pair["exp"] == 1:
        assert "residual" in got
    for k, w in want.items():
        assert np.isfinite(got[k])
        assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def test_one_step_params_match_jax(step_pair):
    want, got = step_pair["want"], step_pair["got"]
    assert set(want) == set(got)
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR, (k, d.max().item())
        assert d.mean().item() <= 1e-7, (k, d.mean().item())


def test_total_gaussians_match_jax(step_pair):
    t, jt = step_pair["trainer"], step_pair["jtrainer"]
    for side in (64, 256):
        t._depth_side = jt._depth_side = side
        assert t._total_gaussians(1) == jt._total_gaussians(1)


# ----------------------------------------------------------------------
# infer with an experiment's sidecar
# ----------------------------------------------------------------------

def _jax_checkpoint(exp, root):
    """A JAX trainer's checkpoint (msgpack and sidecar) for `exp` at its
    init, the NCA's update layer moved off zero so it decodes non-trivially."""
    cfg = jconfig.TrainingConfig(experiment=exp, output_dir=str(root),
                                 **CFG)
    jt = JTrainer(cfg, jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    ds = JSynth(n_samples=2, image_size=32, n_gaussians=30, seed=0)
    state = jt.init_state(next(iter(ds.batches(2, np.random.default_rng(0)))))
    state["params"] = _perturb(state["params"], 9, 0.02)
    path = root / f"exp{exp}.msgpack"
    jt.save_checkpoint(path, state, 0)
    return str(path)


def _png(root):
    from PIL import Image
    rng = np.random.default_rng(5)
    path = root / "img.png"
    Image.fromarray((rng.uniform(size=(48, 48, 3)) * 255).astype(
        np.uint8)).save(path)
    return str(path)


def test_infer_with_nca_sidecar_matches_jax(tmp_path):
    from fresnel_tpu import cli as jcli
    ckpt = _jax_checkpoint(5, tmp_path)
    img = _png(tmp_path)
    assert jcli.main(["infer", img, str(tmp_path / "j.ply"),
                      "--checkpoint", ckpt]) == 0
    assert cli.main(["infer", img, str(tmp_path / "t.ply"), "--checkpoint",
                     ckpt, "--device", "cpu"]) == 0
    want = jio.load_ply(str(tmp_path / "j.ply"))
    got = tio.load_ply(str(tmp_path / "t.ply"))
    assert got.num_gaussians == want.num_gaussians == 55
    for k in ("positions", "colors", "opacities"):
        w = np.asarray(getattr(want, k))
        _close(getattr(got, k), w, 1e-5 * np.abs(w).max(), k)


@pytest.mark.parametrize("exp", [1, 3])
def test_infer_of_saag_experiments_fails_in_jax_and_raises(exp, tmp_path):
    from fresnel_tpu import cli as jcli
    ckpt = _jax_checkpoint(exp, tmp_path)
    img = _png(tmp_path)
    with pytest.raises(TypeError):
        jcli.main(["infer", img, str(tmp_path / "j.ply"), "--checkpoint",
                   ckpt])
    with pytest.raises(ValueError, match="SAAG prior"):
        cli.main(["infer", img, str(tmp_path / "t.ply"), "--checkpoint",
                  ckpt, "--device", "cpu"])
    meta = json.loads((tmp_path / f"exp{exp}.msgpack.json").read_text())
    assert meta["config"]["experiment"] == exp
