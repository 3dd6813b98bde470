"""Port parity: tensor-parallel state sharding (`parallel.tp`) against the
JAX package's `parallel/tp.py`, on the CPU.

* `infer_leaf_spec`: tests/test_parallel.py's five cases, the port's
  per-dimension tuple equal to JAX's PartitionSpec.
* `infer_state_specs` on the flagship Trainer state's shapes (experiment
  2, K 8, the ImageEncoder at feature_dim 384, grid 37, width 64; params
  and Adam moments, from `jax.eval_shape` of JAX's init) over a (2, 2)
  ("data", "model") mesh: equal to JAX's leaf by leaf (285 leaves, 96
  sharded); and the port's own
  flagship state (torch layouts: kernels transposed) shards as many
  elements under its specs as JAX's does under its.
* The gradient step of tests/test_parallel.py's network (64 -> 256 -> 8,
  min_elems 1024) with its weights sharded by `shard_state` over a (2, 2)
  mesh on four gloo ranks (spawned by `parallel.launch.run_job`), against
  JAX's replicated step: loss within 1e-5 relative, gradients within
  1e-5 absolute (test_parallel.py's bounds; measured 1.3e-7 and 5.2e-8),
  sharded fraction above 0.9 and equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fresnel_tpu.parallel.mesh import get_mesh, shard_batch
from fresnel_tpu.parallel import tp as jtp
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.parallel import launch, tp
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train.harness import Trainer
from test_torch_threads import _few_threads  # noqa: F401

FLAGSHIP = dict(experiment=2, gaussians_per_patch=8, scale_bias=-2.6,
                opacity_bias=1.5, train_encoder=True, feature_dim=384,
                feature_size=37, encoder_width=64, image_size=256,
                max_per_tile=1024, batch_size=8, boundary_weight=0.1,
                lpips_weight=0.0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)


@pytest.mark.parametrize("shape,tp_size,kw", [
    ((), 2, {}), ((128,), 2, {}), ((4096, 2), 2, dict(min_elems=1024)),
    ((3, 4096), 2, dict(min_elems=1024)),
    ((3, 4097), 2, dict(min_elems=1024))])
def test_leaf_spec_rules_match_jax(shape, tp_size, kw):
    want = jtp.infer_leaf_spec(shape, tp_size, **kw)
    assert tp.infer_leaf_spec(shape, tp_size, **kw) == tuple(want)


def _is_spec(x):
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def _flatten(tree):
    """{path: spec} of a spec tree (a PartitionSpec or the port's tuple is
    a leaf; dicts, tuples and optax's named tuples are nodes)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)
    return {jax.tree_util.keystr(k): v for k, v in leaves}


def _sharded_elems(shapes, specs):
    return sum(int(np.prod(shapes[k])) for k, s in specs.items()
               if "model" in tuple(s))


def test_state_specs_match_jax(tmp_path):
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(tmp_path),
                                         **FLAGSHIP),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    batch = {"image": jax.ShapeDtypeStruct((8, 3, 256, 256), jnp.float32),
             "depth": jax.ShapeDtypeStruct((8, 256, 256), jnp.float32),
             "features": jax.ShapeDtypeStruct((8, 37, 37, 384),
                                              jnp.float32)}
    state = jax.eval_shape(jt.init_state, batch)
    mesh = get_mesh(4, axis_names=("data", "model"), shape=(2, 2))
    want = _flatten(jtp.infer_state_specs(state, mesh))
    got = _flatten(tp.infer_state_specs(state, {"model": 2}))
    assert set(got) == set(want) and len(got) > 100
    for k, w in want.items():
        assert got[k] == tuple(w), k
    leaf_shapes = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
                   jax.tree_util.tree_flatten_with_path(state["params"])[0]}
    jax_sharded = _sharded_elems(leaf_shapes,
                                 _flatten(jtp.infer_state_specs(
                                     state["params"], mesh)))
    t = Trainer(tconfig.TrainingConfig(output_dir=str(tmp_path), **FLAGSHIP),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), device="cpu")
    params = t.init_state()["params"]
    specs = tp.infer_state_specs(params, {"model": 2})
    assert _sharded_elems({k: tuple(v.shape) for k, v in params.items()},
                          specs) == jax_sharded
    assert sum(v.numel() for v in params.values()) == sum(
        int(np.prod(s)) for s in leaf_shapes.values())


def test_tp_step_matches_replicated(tmp_path):
    rng = np.random.default_rng(0)
    params = {
        "w1": rng.normal(size=(64, 256)).astype(np.float32) * 0.1,
        "b1": np.zeros((256,), np.float32),
        "w2": rng.normal(size=(256, 8)).astype(np.float32) * 0.1,
    }
    x = rng.normal(size=(8, 64)).astype(np.float32)

    def loss_fn(p, x):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"]) ** 2)

    step = jax.jit(jax.value_and_grad(loss_fn))
    ref_loss, ref_grads = step({k: jnp.asarray(v) for k, v in
                                params.items()}, jnp.asarray(x))
    mesh = get_mesh(4, axis_names=("data", "model"), shape=(2, 2))
    jfrac = jtp.sharded_fraction(jtp.shard_state(
        {k: jnp.asarray(v) for k, v in params.items()}, mesh,
        min_elems=1024))
    shard_batch({"x": jnp.asarray(x)}, mesh)
    res = launch.run_job([{"task": "tp_step", "params": params, "x": x,
                           "shape": (2, 2), "min_elems": 1024}], 4,
                         tmp_path / "job", device="cpu", threads=1)
    for (r,) in res:
        assert r["fraction"] > 0.9 and r["fraction"] == pytest.approx(
            jfrac, abs=1e-12)
        assert r["specs"] == {"w1": (None, "model"), "b1": (),
                              "w2": ("model", None)}
        assert abs(r["loss"] - float(ref_loss)) <= 1e-5 * abs(
            float(ref_loss))
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g.numpy(), np.asarray(ref_grads[k]),
                                       atol=1e-5)
