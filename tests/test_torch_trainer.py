"""Port parity: `train.harness.Trainer` against the JAX package's, on the
CPU, at a small flagship-like config: experiment 2, K 2, the jointly
trained ImageEncoder (grid 5, width 8, feature_dim 48), 32^2 images,
max_per_tile 64, batch 2, lr 2e-4 cosine, weight decay 1e-5, scale_bias
-2.6, opacity_bias 1.5, depth_offset_init -0.128, rgb 1.0, ssim 0.5, depth
0.1, boundary 0.1 (so FresnelZones), on a 6-scene `synthetic_corpus`
through `ImageDataset` with colour jitter.  Both sides run with dropout 0
(JAX's dropout mask cannot be reproduced): the JAX decoder by
`clone(dropout=0.0)` here, the port's by its constructor argument.  One
JAX run is shared by the file (module fixture): 3 steps by hand through
the JAX step function from its init, converted into the port, then
`fit` on both sides for one epoch.

* The loss dict at each step: every term within 1e-4 relative (measured:
  total 1.0e-6, depth 8.6e-6 at most).
* `depth_offset` after 3 steps within 1e-5 (measured 0.0).
* The parameters after 3 steps, per leaf: max absolute difference at most
  2 * lr * steps (Adam's first steps are about lr * sign(g), so an entry
  whose gradient sits near zero may step on one side only; measured 8.2e-5
  at most) and mean at most 1e-7 (measured 1.3e-8 at most), except the
  leaves whose gradient is zero in exact arithmetic, where Adam steps on
  rounding noise of either sign: the residual blocks' first conv biases
  (each feeds a GroupNorm of one channel per group at these widths;
  measured mean 2.9e-5) and the attention key biases (softmax ignores a
  per-query constant; 5.4e-7).
* `fit`, one epoch of 3 steps from the same state: the epoch's mean loss
  within 1e-4 relative, and the same checkpoint and sidecar files (`.pt`
  for `.msgpack`).
Port-only: the decoder's train-mode dropout (rate and 1 / (1 - p)
scaling), the pose rotation against JAX's head, and the NaN guard inside
the trainer.
"""

import json
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.models.decoders import DirectPatchDecoder as JDecoder
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.data import dataset as tds
from fresnel_tpu_torch.models.blocks import dropout
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train.harness import Trainer, build_decoder
from fresnel_tpu_torch.weights import decoder_state_dict, trainer_params
from test_torch_threads import _few_threads  # noqa: F401


STEPS, K, LR = 3, 2, 2e-4
CFG = dict(experiment=2, epochs=1, batch_size=2, image_size=32,
           feature_size=5, feature_dim=48, encoder_width=8,
           gaussians_per_patch=K, max_per_tile=64, train_encoder=True,
           lr=LR, weight_decay=1e-5, scale_bias=-2.6, opacity_bias=1.5,
           depth_offset_init=-0.128, rgb_weight=1.0, ssim_weight=0.5,
           depth_weight=0.1, boundary_weight=0.1, lpips_weight=0.0,
           save_interval=100, seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)
DS = dict(image_size=32, feature_size=5, feature_dim=48,
          use_augmentation=True)


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


def _port_trainer(out_dir):
    t = Trainer(tconfig.TrainingConfig(output_dir=str(out_dir), **CFG),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    return t


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    jcorpus.generate_corpus(str(root / "data"), n_images=6, image_size=32,
                            seed=3)
    jdata = jds.ImageDataset(str(root / "data"), **DS)
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(root / "jfit"),
                                         **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(STEPS)
    nprng = np.random.default_rng(0)
    first = next(iter(jdata.batches(2, nprng)))
    state = jt.init_state(first)
    state["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
        -0.128, jnp.float32)
    init = _flat(state["params"])
    step_fn = jt.get_step(K, None)
    rng = jax.random.PRNGKey(1)
    batches, losses = [], []
    for batch in jdata.batches(2, nprng):
        batches.append(batch)
        rng, sr = jax.random.split(rng)
        state, ld = step_fn(state, jt._device_batch(batch, nprng), sr)
        losses.append({k: float(v) for k, v in ld.items()})
    final = _flat(state["params"])
    # fit from the same init, reusing the compiled step.
    jstate = jt.init_state(first)
    jstate["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
        -0.128, jnp.float32)
    jt.fit(jdata, state=jstate, log_fn=lambda *a: None)
    return dict(root=root, init=init, batches=batches, losses=losses,
                final=final, fit_history=jt.history)


def _port_state(t, flat):
    params = {k: v.clone() for k, v in trainer_params(flat).items()}
    return {"params": params, "opt_state": t.optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.fixture(scope="module")
def port(run):
    t = _port_trainer(run["root"] / "tfit")
    t._make_optimizer(STEPS)
    state = _port_state(t, run["init"])
    assert set(state["params"]) == set(
        f"model.{k}" for k, _ in t.model.named_parameters()) | set(
        f"encoder.{k}" for k, _ in t.encoder.named_parameters())
    gen = torch.Generator().manual_seed(1)
    losses = []
    for batch in run["batches"]:
        state, ld = t.train_step(state, t.device_batch(batch), K, None, gen)
        losses.append({k: float(v) for k, v in ld.items()})
    return dict(trainer=t, state=state, losses=losses)


def test_losses_match_at_each_step(run, port):
    assert len(run["losses"]) == len(port["losses"]) == STEPS
    for want, got in zip(run["losses"], port["losses"]):
        assert set(want) == set(got)
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def test_params_after_three_steps(run, port):
    want = trainer_params(run["final"])
    got = port["state"]["params"]
    assert abs(got["model.depth_offset"].item()
               - want["model.depth_offset"].item()) <= 1e-5
    zero_grad = re.compile(r"res\.\d\.conv1\.bias|attn\.k\.bias")
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR * STEPS, (k, d.max().item())
        if not zero_grad.search(k):
            assert d.mean().item() <= 1e-7, (k, d.mean().item())
    assert int(port["state"]["step"]) == STEPS
    assert int(port["state"]["opt_state"]["count"]) == STEPS


def test_fit_matches(run):
    t = _port_trainer(run["root"] / "tfit2")
    state = _port_state(t, run["init"])
    t.fit(tds.ImageDataset(str(run["root"] / "data"), device="cpu", **DS),
          state=state, log_fn=lambda *a: None)
    w, g = run["fit_history"]["total"][0], t.history["total"][0]
    assert abs(g - w) <= 1e-4 * abs(w)
    assert set(t.history) == set(run["fit_history"])
    jfiles = sorted(p.name.replace(".msgpack", ".pt")
                    for p in (run["root"] / "jfit").iterdir())
    tfiles = sorted(p.name for p in (run["root"] / "tfit2").iterdir())
    assert jfiles == tfiles
    jmeta = json.loads((run["root"] / "jfit" /
                        "final_model.msgpack.json").read_text())
    tmeta = json.loads((run["root"] / "tfit2" /
                        "final_model.pt.json").read_text())
    jmeta["config"]["output_dir"] = tmeta["config"]["output_dir"]
    assert jmeta == tmeta


def test_decoder_dropout_in_training_only():
    torch.manual_seed(0)
    m = DirectPatchDecoder(feature_dim=16, gaussians_per_patch=1,
                           hidden_dims=(64,), dropout=0.5)
    g = torch.Generator().manual_seed(2)
    h = torch.rand(1000, 64, generator=g) + 0.5           # no zeros
    y = dropout(h, 0.5, False, g)
    kept = y != 0
    assert 0.45 < kept.float().mean().item() < 0.55
    torch.testing.assert_close(y[kept], (h * 2.0)[kept])
    assert torch.equal(dropout(h, 0.5, True, g), h)
    feats = torch.randn(2, 3, 3, 16)
    a = m(feats)["positions"]
    assert torch.equal(a, m(feats)["positions"])
    assert not torch.equal(a, m(feats, deterministic=False,
                                generator=g)["positions"])


def test_pose_rotation_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    depth = rng.uniform(size=(2, 32, 32)).astype(np.float32)
    el = np.array([0.0, 0.4], np.float32)
    az = np.array([1.2, -0.3], np.float32)
    j = JDecoder(feature_dim=16, gaussians_per_patch=2, hidden_dims=(32,),
                 dropout=0.0)
    params = j.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                    jnp.asarray(depth), elevation=jnp.asarray(el),
                    azimuth=jnp.asarray(az))
    want = j.apply(params, jnp.asarray(feats), jnp.asarray(depth),
                   elevation=jnp.asarray(el), azimuth=jnp.asarray(az))
    t = DirectPatchDecoder(feature_dim=16, gaussians_per_patch=2,
                           hidden_dims=(32,), dropout=0.0)
    t.load_state_dict(decoder_state_dict(
        flatten_dict(params["params"], sep="/")))
    with torch.no_grad():
        got = t(torch.from_numpy(feats), torch.from_numpy(depth),
                elevation=torch.from_numpy(el), azimuth=torch.from_numpy(az))
    for k in ("positions", "scales", "rotations", "colors", "opacities"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)


def test_non_finite_step_keeps_state(run):
    t = _port_trainer(run["root"] / "nan")
    state = _port_state(t, run["init"])
    batch = dict(run["batches"][0])
    batch["image"] = batch["image"].copy()
    batch["image"][0, 0, 0, 0] = np.nan
    new, ld = t.train_step(state, t.device_batch(batch), K, None,
                           torch.Generator().manual_seed(0))
    assert not np.isfinite(float(ld["total"]))
    assert int(new["step"]) == 1 and int(new["opt_state"]["count"]) == 0
    for k, v in state["params"].items():
        assert torch.equal(new["params"][k], v)
