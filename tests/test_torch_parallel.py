"""Port parity: data-parallel decoder training (`parallel.mesh`,
`Trainer.fit(mesh=...)`) on the CPU, two gloo ranks spawned by
`parallel.launch.run_job` (each child imports the port only; this file
runs the JAX side), all of this file's rank programs in one start-up.

Config: tests/test_torch_trainer.py's small flagship-like one (experiment
2, K 2, ImageEncoder grid 5 width 8, 32^2, max_per_tile 64, depth weight
0.1, boundary 0.1) at global batch 4, with multi-pose augmentation and
stochastic K 32 of the 50 Gaussians, the tiled renderer's overflow
statistics on.

* Against JAX: 2 steps of the JAX Trainer's step under `jit` on a
  2-device CPU mesh (`replicate` + `shard_batch`, as
  tests/test_train.py::TestDataParallel), dropout 0 on both sides, from
  JAX's init; the port's world-2 `train_step`s, and its world-1 ones, are
  handed the same global batches, JAX's poses and JAX's stochastic-K
  indices (each package draws its own random bits).  Every loss term
  within 1e-4 relative (measured 8.5e-6 at most, the depth term).  The
  parameters after 2 steps, per leaf: max absolute difference within
  2 * lr * steps and mean within 2e-6 (measured 1.0e-6 at most, the same
  for the port's world-1 steps: at batch 4 the second Adam step reads
  gradient ratios, which the two packages' float32 summation orders move
  by ~1e-3 relative on the encoder's smallest leaves); the world-2
  parameters within 1e-8 of the world-1 ones by leaf mean (measured
  3.7e-9 at most), except the leaves whose gradient is zero in exact
  arithmetic (tests/test_torch_trainer.py names them), which step on
  rounding noise.
* Against the port's world 1: one epoch of `fit` (2 steps) at world 2 and
  at world 1 with dropout on (0.1), the same seeds: each step's loss
  within 1e-5 relative (measured 1.2e-7), leaf means within 1e-8
  (measured 3.7e-9; the all-reduce sums in another order, so not bit for
  bit), one all-reduce a step.
* The global batch's gradient at the init (dropout on), world 2 against
  world 1: within 1e-5 by global norm (measured 7.0e-7), every leaf
  within 1e-3 by its norm (measured 1.5e-6), the loss terms within 1e-6
  (measured 1.2e-7); the ranks' gradients bit for bit equal.
* Across ranks: the parameters bit for bit equal (sha256) after both runs.
* The mesh units: `shard_batch`'s rows and its ValueError on an
  indivisible batch, `replicate` from rank 0, `pmean_gradients` against
  the hand mean, a `RowGenerator`'s rows against the global draw (and
  its ValueError on a draw that is not batch-major), the world a step
  sees under `jit_data_parallel` (with the mesh: 2, without: 1) and
  `data_parallel_step`.
(`train_gaussian_decoder --num_devices 2 --device cpu` against
`--num_devices 1` is tests/test_torch_train_cli.py's `--num_devices 2`
case.)
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax.traverse_util import flatten_dict

import fresnel_tpu.train.harness as jharness
from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.parallel.mesh import get_mesh, replicate, shard_batch
from fresnel_tpu.train import config as jconfig

from fresnel_tpu_torch.parallel import jobs, launch
from fresnel_tpu_torch.parallel.mesh import get_mesh as get_mesh_port
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

STEPS, K, SK, LR, B = 2, 2, 32, 2e-4, 4
CFG = dict(experiment=2, epochs=1, batch_size=B, image_size=32,
           feature_size=5, feature_dim=48, encoder_width=8,
           gaussians_per_patch=K, max_per_tile=64, train_encoder=True,
           lr=LR, weight_decay=1e-5, scale_bias=-2.6, opacity_bias=1.5,
           depth_offset_init=-0.128, rgb_weight=1.0, ssim_weight=0.5,
           depth_weight=0.1, boundary_weight=0.1, lpips_weight=0.0,
           multi_pose_augmentation=True, save_interval=100, seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)
HFTS = dict(stochastic_k=SK)
DS = dict(image_size=32, feature_size=5, feature_dim=48,
          use_augmentation=True)
ZERO_GRAD = re.compile(r"res\.\d\.conv1\.bias|attn\.k\.bias")


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


def _configs(out_dir):
    return {"config": dict(CFG, output_dir=str(out_dir)), "hfgs": HFGS,
            "hfts": HFTS}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, monkeypatch_module):
    """JAX's mesh steps; the stochastic-K indices each step drew are
    recorded through a debug callback, the poses redrawn from the step's
    key as its loss draws them."""
    root = tmp_path_factory.mktemp("parallel")
    jcorpus.generate_corpus(str(root / "data"), n_images=8, image_size=32,
                            seed=3)
    jdata = jds.ImageDataset(str(root / "data"), **DS)
    cfg = jconfig.TrainingConfig(output_dir=str(root / "jfit"), **CFG)
    jt = jharness.Trainer(cfg, jconfig.PhysicsConfig(),
                          jconfig.HFGSConfig(**HFGS),
                          jconfig.HFTSConfig(**HFTS))
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(STEPS)
    seen = []
    orig = jharness.gumbel_topk_indices

    def recorded(rng, weights, k):
        idx = orig(rng, weights, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx)
        return idx

    monkeypatch_module.setattr(jharness, "gumbel_topk_indices", recorded)
    nprng = np.random.default_rng(0)
    first = next(iter(jdata.batches(B, nprng)))
    # Jitted: eager Flax init takes ~3 x as long here.
    state = jax.jit(jt.init_state)(jax.tree.map(jnp.asarray, first))
    state["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
        -0.128, jnp.float32)
    init = _flat(state["params"])
    mesh = get_mesh(2)
    state = replicate(state, mesh)
    step_fn = jt.get_step(K, SK)
    el_lo, el_hi = np.radians(cfg.pose_range_elevation)
    az_lo, az_hi = np.radians(cfg.pose_range_azimuth)
    rng = jax.random.PRNGKey(1)
    batches, draws, losses = [], [], []
    for batch in jdata.batches(B, nprng):
        batches.append(batch)
        rng, sr = jax.random.split(rng)
        rng_pose = jax.random.split(sr, 3)[0]
        r1, r2, r3 = jax.random.split(rng_pose, 3)
        el = jax.random.uniform(r1, (B,), minval=el_lo, maxval=el_hi)
        az = jax.random.uniform(r2, (B,), minval=az_lo, maxval=az_hi)
        frontal = jax.random.uniform(r3, (B,)) < cfg.frontal_prob
        poses = (np.array(jnp.where(frontal, 0.0, el), np.float32),
                 np.array(jnp.where(frontal, 0.0, az), np.float32))
        seen.clear()
        state, ld = step_fn(state, shard_batch(jt._device_batch(batch, nprng),
                                               mesh), sr)
        jax.effects_barrier()
        draws.append({"K": K, "sk": SK, "poses": poses, "topk": seen[-1]})
        losses.append({k: float(v) for k, v in ld.items()})
    assert len(batches) == STEPS
    return dict(root=root, init=init, batches=batches, draws=draws,
                losses=losses, final=_flat(state["params"]))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def ranks(jax_run):
    """One start-up of two gloo ranks: the mesh units, the steps against
    JAX, and one epoch of `fit` with dropout on."""
    root = jax_run["root"]
    steps = {"task": "train_steps", "configs": _configs(root / "tsteps"),
             "dropout": 0.0, "params": trainer_params(jax_run["init"]),
             "batches": jax_run["batches"], "draws": jax_run["draws"],
             "total_steps": STEPS, "gen_seed": 1, "mesh": True}
    fit = {"task": "fit", "configs": _configs(root / "tfit"),
           "dataset": dict(kind="image", data_dir=str(root / "data"), **DS),
           "mesh": True}
    grad = dict(fit, task="gradients")
    res = launch.run_job([{"task": "mesh_units", "batch": B}, steps, fit,
                          grad], 2, root / "job", device="cpu", threads=2)
    cpu = torch.device("cpu")
    one_fit = jobs.fit(dict(fit, configs=_configs(root / "tfit1"),
                            mesh=False), cpu)
    one_steps = jobs.train_steps(dict(steps, configs=_configs(
        root / "tsteps1"), mesh=False), cpu)
    one_grad = jobs.gradients(dict(grad, mesh=False), cpu)
    return dict(fit_task=fit, units=[r[0] for r in res],
                steps=[r[1] for r in res],
                fit=[r[2] for r in res], fit1=one_fit, steps1=one_steps,
                grad=[r[3] for r in res], grad1=one_grad)


def test_shard_batch_rows(ranks):
    for r, u in enumerate(ranks["units"]):
        assert u["world"] == 2 and u["local_type"] == "dict"
        want = torch.arange(B * 3, dtype=torch.float32).reshape(B, 3)
        torch.testing.assert_close(u["local"]["image"],
                                   want[r * 2:(r + 1) * 2], rtol=0, atol=0)
        assert list(u["local"]["rows"]) == [2 * r, 2 * r + 1]
        assert u["local"]["distill_scale"] == 0.5
        assert "not divisible" in u["indivisible"]
        assert u["worlds"] == {"jit_mesh": 2, "jit_plain": 1, "step": 2}


def test_replicate_and_pmean(ranks):
    units = ranks["units"]
    hand = {k: sum(u["grads"][k] for u in units) / 2 for k in ("w", "s")}
    for u in units:
        assert torch.equal(u["replicated"]["a"], torch.ones(4))
        assert torch.equal(u["replicated"]["b"]["c"], torch.zeros(2, 2))
        assert u["pmean"]["none"] is None
        for k, w in hand.items():
            torch.testing.assert_close(u["pmean"][k], w, rtol=0, atol=1e-7)
        assert float(u["global_sum"]) == 1.0
        assert "not batch-major" in u["not_rows"]
    full = torch.rand((2, B, 3), generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(
        torch.cat([u["rand_rows"] for u in units], dim=1), full, rtol=0,
        atol=0)


def test_world2_steps_match_jax_mesh_step(jax_run, ranks):
    for got_rank in ranks["steps"]:
        for want, got in zip(jax_run["losses"], got_rank["losses"]):
            assert set(want) == set(got)
            for k, w in want.items():
                assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (
                    k, got[k], w)
    want = trainer_params(jax_run["final"])
    one = ranks["steps1"]["params"]
    for got in (ranks["steps"][0]["params"], one):
        for k, w in want.items():
            d = (got[k] - w).abs()
            assert d.max().item() <= 2 * LR * STEPS, (k, d.max().item())
            if not ZERO_GRAD.search(k):
                assert d.mean().item() <= 2e-6, (k, d.mean().item())
    for k, w in one.items():
        if not ZERO_GRAD.search(k):
            d = (ranks["steps"][0]["params"][k] - w).abs().mean().item()
            assert d <= 1e-8, (k, d)


def test_world2_fit_matches_world1_with_dropout(ranks):
    one = ranks["fit1"]
    assert len(one["step_loss"]) == STEPS
    for two in ranks["fit"]:
        assert len(two["step_loss"]) == STEPS
        for a, b in zip(two["step_loss"], one["step_loss"]):
            assert abs(a - b) <= 1e-5 * abs(b), (a, b)
        assert set(two["history"]) == set(one["history"])
        for k, v in one["history"].items():
            assert abs(two["history"][k][0] - v[0]) <= 1e-5 * max(
                abs(v[0]), 1e-6), k
        for k, w in one["params"].items():
            if not ZERO_GRAD.search(k):
                d = (two["params"][k] - w).abs().mean().item()
                assert d <= 1e-8, (k, d)
    # one all-reduce a step; the allreduce carries grads and loss terms
    assert ranks["fit"][0]["allreduce"]["calls"] == STEPS
    n_params = sum(v.numel() for v in one["params"].values())
    assert ranks["fit"][0]["allreduce"]["bytes"] > 4 * n_params * STEPS


def test_world2_gradient_matches_world1(ranks):
    """The global batch's gradient at the init (dropout on, normalised
    depth L1's moments global) against world 1's."""
    want = ranks["grad1"]
    for got in ranks["grad"]:
        assert set(got["grads"]) == set(want["grads"])
        num = sum(float(((got["grads"][k] - g) ** 2).sum())
                  for k, g in want["grads"].items())
        den = sum(float((g ** 2).sum()) for g in want["grads"].values())
        assert (num / den) ** 0.5 <= 1e-5, (num / den) ** 0.5
        for k, g in want["grads"].items():
            if g.norm() > 0 and not ZERO_GRAD.search(k):
                rel = ((got["grads"][k] - g).norm() / g.norm()).item()
                assert rel <= 1e-3, (k, rel)
        for k, v in want["losses"].items():
            assert abs(got["losses"][k] - v) <= 1e-6 * max(abs(v), 1.0), k
    a, b = ranks["grad"]
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k


def test_ranks_bitwise_equal(ranks):
    for name in ("steps", "fit"):
        a, b = ranks[name]
        assert a["sha256"] == b["sha256"], name
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), (name, k)


def test_init_distributed_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    """A rank's device and a mesh's device type resolve as the entry
    points' devices do: with no card, none given means CUDA and raises;
    the CPU is taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.init_distributed(0, 1, launch.file_init(tmp_path))
    assert not dist.is_initialized()
    dev = launch.init_distributed(0, 1, launch.file_init(tmp_path), "cpu")
    try:
        assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_mesh_port()
        assert get_mesh_port(device_type="cpu").device_type == "cpu"
    finally:
        launch.shutdown()


def test_world1_mesh_fit_equals_plain_fit_bitwise(ranks, tmp_path):
    """At world size 1 (a one-rank gloo group) the data-parallel fit does
    the plain fit's arithmetic, dropout, stochastic K and depth L1 on:
    each step's loss and the parameters bit for bit."""
    cpu = torch.device("cpu")
    task = dict(ranks["fit_task"], configs=_configs(tmp_path / "plain"),
                mesh=False)
    plain = jobs.fit(task, cpu)
    launch.init_distributed(0, 1, launch.file_init(tmp_path), "cpu")
    try:
        mesh = jobs.fit(dict(task, configs=_configs(tmp_path / "mesh"),
                             mesh=True), cpu)
    finally:
        launch.shutdown()
    assert mesh["allreduce"]["calls"] == STEPS
    assert mesh["step_loss"] == plain["step_loss"]
    assert mesh["sha256"] == plain["sha256"]
