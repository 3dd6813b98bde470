"""Port parity: the committed trained checkpoints through
`Trainer.load_checkpoint` against the JAX package, on the CPU.

* `results/exp2_model.msgpack` (full, float32): params, Adam's mu and nu,
  the count and the step equal, bit for bit, the JAX Trainer's loaded
  state carried through `weights.trainer_params` (the one JAX Trainer of
  this file); epoch from the sidecar.
* exp2_k8 and v2combo (thin, bf16): params equal bit for bit to
  `fresnel_tpu.train.thin_ckpt.load_thin_params` upcast to float32; a
  fresh optimizer state (count 0, zero moments); step and epoch from the
  sidecar.
* exp4 and exp4_budget (experiment 4, full) load and decode as the JAX
  Trainer does: params, Adam's moments, count and step equal bit for
  bit; two `synthetic_corpus` scenes (256^2, the patch extractor's
  features) decoded in one batch: every field within 1e-5 of its largest
  value, the depth-locked z bit for bit.  exp2_g74zi (thin, bf16,
  `feature_upsample` 2: 74^2 x K 2) loads the JAX reader's params and,
  through its encoder (features within 1e-4, as exp2_k8's below; measured
  6.6e-6), decodes the two scenes within 1e-5 of each field's largest
  value (measured 4.8e-6 at most; positions reach |398|, the trained XY
  offsets are large, so an absolute bound would hold their last bits).
  A sidecar that needs what the port still lacks (more than one device,
  beside the ported `use_amp` or the Fresnel-zone decoder) raises
  NotImplementedError naming it, and experiments 1, 3 and 5 build their
  decoders; a
  missing sidecar raises FileNotFoundError unless
  FRESNEL_ALLOW_MISSING_SIDECAR; optax's two counts must agree.
* The `z_offset_scale` head against JAX's DirectPatchDecoder (atol 1e-5
  on every field).
* exp2_k8's encoder and decoder on one 256^2 image against the JAX
  modules with the same upcast params, float32: features within 1e-4
  absolute (LayerNorm-ed, order one; as tests/test_torch_image_encoder.py
  holds the encoder), positions, scales, colours and opacities within
  1e-4 absolute and rotations within 1e-4.
"""

import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import flax.serialization as ser
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.models.decoders import DirectPatchDecoder as JDecoder
from fresnel_tpu.models.image_encoder import ImageEncoder as JEncoder
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer
from fresnel_tpu.train.thin_ckpt import load_thin_params as j_load_thin

from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
from fresnel_tpu_torch.train.harness import trainer_from_checkpoint
from fresnel_tpu_torch.weights import (
    decoder_state_dict, trainer_opt_state, trainer_params)
from fresnel_tpu_torch.train.flax_msgpack import read_flat
from test_torch_threads import _few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")
FIELDS = ("positions", "scales", "rotations", "colors", "opacities")


def _ckpt(name):
    return os.path.join(RESULTS, f"{name}_model.msgpack")


def _meta(name):
    with open(_ckpt(name) + ".json") as f:
        return json.load(f)


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _port(name):
    t = trainer_from_checkpoint(_ckpt(name), device="cpu")
    state, epoch = t.load_checkpoint(_ckpt(name))
    return t, state, epoch


def _equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert torch.equal(got[k], w), k


@pytest.fixture(scope="module")
def exp2_jax():
    meta = _meta("exp2")
    jt = JTrainer(jconfig.TrainingConfig(**meta["config"]),
                  jconfig.PhysicsConfig(**meta["physics_config"]),
                  jconfig.HFGSConfig(**meta["hfgs_config"]),
                  jconfig.HFTSConfig(**meta["hfts_config"]))
    batch = {"features": np.zeros((1, 37, 37, 384), np.float32),
             "depth": np.zeros((1, 256, 256), np.float32)}
    state, epoch = jt.load_checkpoint(_ckpt("exp2"), batch)
    return state, epoch


def test_full_checkpoint_matches_jax(exp2_jax):
    jstate, jepoch = exp2_jax
    t, state, epoch = _port("exp2")
    assert epoch == jepoch == 300
    _equal(state["params"], trainer_params(_flat(jstate["params"])))
    adam = jstate["opt_state"][1][0]
    _equal(state["opt_state"]["mu"], trainer_params(_flat(adam.mu)))
    _equal(state["opt_state"]["nu"], trainer_params(_flat(adam.nu)))
    assert int(state["opt_state"]["count"]) == int(adam.count) == 6000
    assert int(jstate["opt_state"][1][2].count) == 6000
    assert state["step"].dtype == torch.int32
    assert int(state["step"]) == int(jstate["step"]) == 6000
    assert state["params"]["model.depth_offset"].shape == ()


@pytest.mark.parametrize("name", ["exp2_k8", "v2combo"])
def test_thin_checkpoint_matches_jax(name):
    with open(_ckpt(name), "rb") as f:
        raw = ser.msgpack_restore(f.read())["params"]
    template = jax.tree.map(lambda x: np.zeros(np.shape(x), np.float32), raw)
    want = trainer_params(_flat(j_load_thin(_ckpt(name), template)))
    t, state, epoch = _port(name)
    meta = _meta(name)
    _equal(state["params"], want)
    assert int(state["opt_state"]["count"]) == 0
    for m in ("mu", "nu"):
        assert all(not v.any() for v in state["opt_state"][m].values())
    assert int(state["step"]) == meta["step"] and epoch == meta["epoch"]
    assert t.config.z_offset_scale == (0.2 if name == "v2combo" else 0.0)


def _jtrainer(name):
    meta = _meta(name)
    return JTrainer(jconfig.TrainingConfig(**meta["config"]),
                    jconfig.PhysicsConfig(**meta["physics_config"]),
                    jconfig.HFGSConfig(**meta["hfgs_config"]),
                    jconfig.HFTSConfig(**meta["hfts_config"]))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two 256^2 synthetic_corpus scenes as the JAX dataset batches them
    for eval (patch features, depth, image)."""
    root = tmp_path_factory.mktemp("ckpt_scenes")
    jcorpus.generate_corpus(str(root), n_images=2, image_size=256, seed=1)
    ds = jds.ImageDataset(str(root), use_augmentation=False)
    return next(iter(ds.batches(2, np.random.default_rng(0),
                                shuffle=False)))


@pytest.mark.parametrize("name,points", [("exp4", 377),
                                         ("exp4_budget", 5476)])
def test_exp4_checkpoint_decodes_like_jax(scenes, name, points):
    jt = _jtrainer(name)
    jstate, jepoch = jt.load_checkpoint(_ckpt(name), scenes)
    t, state, epoch = _port(name)
    assert epoch == jepoch == 150
    _equal(state["params"], trainer_params(_flat(jstate["params"])))
    adam = jstate["opt_state"][1][0]
    _equal(state["opt_state"]["mu"], trainer_params(_flat(adam.mu)))
    _equal(state["opt_state"]["nu"], trainer_params(_flat(adam.nu)))
    assert int(state["opt_state"]["count"]) == int(adam.count) == 3000
    assert int(state["step"]) == int(jstate["step"]) == 3000
    want = jax.jit(jt.model.apply)(jstate["params"]["model"],
                                   jnp.asarray(scenes["features"]),
                                   jnp.asarray(scenes["depth"]))
    got = t.decode(state["params"], scenes["features"], scenes["depth"])
    assert got["positions"].shape == (2, points, 3)
    for k in FIELDS:
        w = np.asarray(want[k])
        err = np.abs(got[k].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (k, err)
    np.testing.assert_array_equal(got["positions"][..., 2].numpy(),
                                  np.asarray(want["positions"][..., 2]))


def test_exp2_g74zi_decodes_like_jax(scenes):
    with open(_ckpt("exp2_g74zi"), "rb") as f:
        raw = ser.msgpack_restore(f.read())["params"]
    template = jax.tree.map(lambda x: np.zeros(np.shape(x), np.float32), raw)
    p32 = j_load_thin(_ckpt("exp2_g74zi"), template)
    t, state, epoch = _port("exp2_g74zi")
    _equal(state["params"], trainer_params(_flat(p32)))
    assert t.config.feature_upsample == 2 and epoch == 149
    assert not state["params"]["model.upsample_refine.weight"].eq(0).all()
    jt = _jtrainer("exp2_g74zi")
    jfeats = jt.encode(p32, jnp.asarray(scenes["image"]))
    want = jax.jit(jt.model.apply)(p32["model"], jfeats,
                                   jnp.asarray(scenes["depth"]))
    feats = t.encode(state["params"], scenes["image"])
    got = t.decode(state["params"], feats, scenes["depth"])
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-4)
    assert got["positions"].shape == (2, 74 * 74 * 2, 3)
    for k in FIELDS:
        w = np.asarray(want[k])
        err = np.abs(got[k].numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (k, err, np.abs(w).max())


@pytest.mark.parametrize("over,missing", [
    # use_amp is ported: its case (same id) takes num_devices with the
    # ported use_amp beside it.
    pytest.param(dict(use_amp=True, num_devices=3), "num_devices",
                 id="over0-use_amp"),
    (dict(num_devices=2), "num_devices"),
    # The Fresnel zones, phase blending and use_amp are ported; with them
    # (an experiment-2 sidecar beside exp4's weights: the Trainer builds
    # and decodes from its init) the case keeps its earlier id.
    pytest.param(dict(experiment=2, use_fresnel_zones=True,
                      use_phase_blending=True, use_amp=True, num_devices=2),
                 "num_devices", id="over2-use_fresnel_zones")])
def test_unported_configs_raise(tmp_path, over, missing):
    """Data parallelism is ported and `num_devices` is inert outside the
    CLI, as in the JAX package: a sidecar that sets it rebuilds the
    Trainer, which loads the checkpoint (or, for another experiment,
    starts from its init) and decodes the same cloud, bit for bit, as the
    sidecar without it."""
    clouds = {}
    for name, cfg in (("set", over), ("unset", {k: v for k, v in
                                                 over.items()
                                                 if k != missing})):
        meta = _meta("exp4")
        meta["config"].update(cfg)
        path = tmp_path / name / "model.msgpack"
        path.parent.mkdir()
        path.symlink_to(os.path.abspath(_ckpt("exp4")))
        (path.parent / "model.msgpack.json").write_text(json.dumps(meta))
        t = trainer_from_checkpoint(path, device="cpu")
        assert t.config.num_devices == cfg.get(missing)
        if t.config.experiment == 4:
            state, epoch = t.load_checkpoint(path)
            assert epoch == meta["epoch"]
        else:
            state = t.init_state()
        rng = np.random.default_rng(0)
        feats = rng.normal(size=(1, 37, 37, 384)).astype(np.float32)
        depth = rng.uniform(size=(1, 256, 256)).astype(np.float32)
        clouds[name] = t.decode(state["params"], feats, depth)
    for k in FIELDS:
        assert torch.equal(clouds["set"][k], clouds["unset"][k]), k


@pytest.mark.parametrize("exp,module", [
    (1, "SAAGRefinementNet"), (3, "FeatureGuidedSAAG"),
    (5, "NCAGaussianDecoder")])
def test_experiment_135_sidecars_build(tmp_path, exp, module):
    meta = _meta("exp4")
    meta["config"].update(experiment=exp)
    path = tmp_path / "model.msgpack"
    (tmp_path / "model.msgpack.json").write_text(json.dumps(meta))
    assert type(trainer_from_checkpoint(path, device="cpu").model
                ).__name__ == module


def test_exp2_e74_loads():
    t, state, epoch = _port("exp2_e74")
    assert t.config.feature_size == 74 and t.config.encoder_attn_pool == 2
    assert epoch == 299 and int(state["step"]) == 12000


def test_missing_sidecar(tmp_path, monkeypatch):
    t = trainer_from_checkpoint(_ckpt("exp2"), device="cpu")
    bare = tmp_path / "exp2_model.msgpack"
    shutil.copy(_ckpt("exp2"), bare)
    with pytest.raises(FileNotFoundError, match="sidecar"):
        t.load_checkpoint(bare)
    monkeypatch.setenv("FRESNEL_ALLOW_MISSING_SIDECAR", "1")
    state, epoch = t.load_checkpoint(bare)
    assert epoch == 0 and int(state["step"]) == 6000
    with pytest.raises(FileNotFoundError, match="sidecar"):
        trainer_from_checkpoint(bare, device="cpu")


def test_optax_counts_must_agree():
    flat = read_flat(_ckpt("exp2"))
    opt = {k[len("opt_state/"):]: v for k, v in flat.items()
           if k.startswith("opt_state/")}
    assert int(trainer_opt_state(opt)["count"]) == 6000
    opt["1/2/count"] = np.asarray(5999, np.int32)
    with pytest.raises(ValueError, match="counts differ"):
        trainer_opt_state(opt)


def test_z_offset_head_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    depth = rng.uniform(size=(2, 32, 32)).astype(np.float32)
    kw = dict(feature_dim=16, gaussians_per_patch=2, hidden_dims=(32,),
              dropout=0.0, depth_z_scale=2.0, scale_bias=-2.6,
              opacity_bias=1.5)
    j = JDecoder(z_offset_scale=0.2, **kw)
    params = j.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                    jnp.asarray(depth))
    want = j.apply(params, jnp.asarray(feats), jnp.asarray(depth))
    t = DirectPatchDecoder(z_offset_scale=0.2, **kw)
    t.load_state_dict(decoder_state_dict(
        flatten_dict(params["params"], sep="/")))
    t0 = DirectPatchDecoder(**kw)
    t0.load_state_dict(t.state_dict())
    with torch.no_grad():
        got = t(torch.from_numpy(feats), torch.from_numpy(depth))
        base = t0(torch.from_numpy(feats), torch.from_numpy(depth))
    for k in FIELDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    dz = (got["positions"] - base["positions"])[..., 2]
    assert 0.01 < dz.abs().max().item() <= 0.2
    assert torch.equal(got["positions"][..., :2], base["positions"][..., :2])


def test_exp2_k8_encoder_and_decoder_match_jax():
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:256, 0:256] / 256.0
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rng.uniform(1, 3) * x
                                                     + rng.uniform(0, 1)))
                    * np.cos(2 * np.pi * rng.uniform(1, 3) * y)
                    for _ in range(3)])[None].astype(np.float32)
    depth = rng.uniform(size=(1, 256, 256)).astype(np.float32)
    with open(_ckpt("exp2_k8"), "rb") as f:
        raw = ser.msgpack_restore(f.read())["params"]
    p32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), raw)
    cfg = _meta("exp2_k8")["config"]
    jenc = JEncoder(feature_dim=384, grid=37, width=cfg["encoder_width"])
    jfeats = jenc.apply(p32["encoder"], jnp.asarray(img))
    jdec = JDecoder(feature_dim=384, gaussians_per_patch=8,
                    scale_bias=cfg["scale_bias"],
                    opacity_bias=cfg["opacity_bias"],
                    depth_z_scale=cfg["depth_z_scale"])
    want = jdec.apply(p32["model"], jfeats, jnp.asarray(depth))

    t, state, _ = _port("exp2_k8")
    feats = t.encode(state["params"], img)
    got = t.decode(state["params"], feats, depth)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-4)
    assert got["positions"].shape == (1, 37 * 37 * 8, 3)
    for k in FIELDS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
