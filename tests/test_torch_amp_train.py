"""Port parity: two `Trainer` steps with `use_amp` (bf16 decoder and
encoder, float32 master weights) against the JAX package's, on the CPU,
at test_torch_trainer.py's flagship-like config (experiment 2, K 2, the
jointly trained ImageEncoder: grid 5, width 8, feature_dim 48; 32^2,
max_per_tile 64, batch 2, lr 2e-4, boundary loss on), dropout 0 on both
sides, from one init (JAX's, converted).  One JAX Trainer for the file:
its bf16 step and, for the JAX package's own bf16-against-float32 gap,
its float32 step built from the same Trainer.

* Each loss term at each step within 2 x the larger of JAX's own gap and
  1e-4 of the term (the float32 ports' agreement).
* The parameters after two steps: the mean absolute difference over all
  entries within 2 x JAX's own mean bf16-against-float32 difference, and
  each entry within 2 * lr * steps (Adam's first steps are about lr *
  sign(g), so an entry whose gradient sits near zero may step on one side
  only).

The 2 x bound alone would pass a port that ran float32 throughout (its
distance to JAX's bf16 is JAX's own gap), so the port's steps also record
the dtypes the encoder and the decoder see (forward hooks, before
`amp_apply` casts the outputs back): bf16 parameters, bf16 features and
Gaussian fields, and float32 positions, as JAX's promotion gives them.

Port-only: `cli train --use_amp` writes `use_amp: true` to its sidecar and
a `--resume` of that run continues it in bf16.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch import cli
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
from fresnel_tpu_torch.train.harness import Trainer, build_decoder
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

STEPS, K, LR = 2, 2, 2e-4
GAP = 2.0                   # x the JAX package's own bf16 - f32 difference
LOSS_FLOOR = 1e-4           # relative, the float32 ports' agreement
CFG = dict(experiment=2, epochs=1, batch_size=2, image_size=32,
           feature_size=5, feature_dim=48, encoder_width=8,
           gaussians_per_patch=K, max_per_tile=64, train_encoder=True,
           lr=LR, weight_decay=1e-5, scale_bias=-2.6, opacity_bias=1.5,
           depth_offset_init=-0.128, rgb_weight=1.0, ssim_weight=0.5,
           depth_weight=0.1, boundary_weight=0.1, lpips_weight=0.0,
           use_augmentation=False, use_amp=True, save_interval=100, seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


def dtype_probe(*modules):
    """Forward hooks on `modules` recording, for each call, the module's
    class, the dtypes of its parameters during the call and of its tensor
    outputs by key.  Returns (the records, the hooks' handles)."""
    seen = []

    def hook(m, args, out):
        outs = out if isinstance(out, dict) else {"out": out}
        seen.append((type(m).__name__, {p.dtype for p in m.parameters()},
                     {k: v.dtype for k, v in outs.items()
                      if torch.is_tensor(v)}))

    return seen, [m.register_forward_hook(hook) for m in modules]


def run_jax(jt, batches, init_state, step):
    state = jax.tree.map(jnp.array, init_state)
    rng = jax.random.PRNGKey(1)
    losses = []
    for batch in batches:
        rng, sr = jax.random.split(rng)
        state, ld = step(state, jax.tree.map(jnp.asarray, batch), sr)
        losses.append({k: float(v) for k, v in ld.items()})
    return losses, trainer_params(_flat(state["params"]))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("amp_train")
    jcorpus.generate_corpus(str(root / "data"), n_images=4, image_size=32,
                            seed=3)
    jdata = jds.ImageDataset(str(root / "data"), image_size=32,
                             feature_size=5, feature_dim=48,
                             use_augmentation=False)
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(root / "j"), **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(STEPS)
    batches = list(jdata.batches(2, np.random.default_rng(0)))[:STEPS]
    state = jt.init_state(batches[0])
    state["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
        -0.128, jnp.float32)
    init = _flat(state["params"])
    amp = run_jax(jt, batches, state, jt.get_step(K, None))
    jt.config = dataclasses.replace(jt.config, use_amp=False)
    f32 = run_jax(jt, batches, state, jt._build_step(K, None))
    return dict(root=root, init=init, batches=batches, amp=amp, f32=f32)


@pytest.fixture(scope="module")
def port(run):
    t = Trainer(tconfig.TrainingConfig(output_dir=str(run["root"] / "t"),
                                       **CFG),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    t._make_optimizer(STEPS)
    params = {k: v.clone() for k, v in trainer_params(run["init"]).items()}
    state = {"params": params, "opt_state": t.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(1)
    seen, hooks = dtype_probe(t.encoder, t.model)
    losses = []
    for batch in run["batches"]:
        state, ld = t.train_step(state, t.device_batch(batch), K, None, gen)
        losses.append({k: float(v) for k, v in ld.items()})
    for h in hooks:
        h.remove()
    return losses, state["params"], seen


def test_amp_runs_in_bf16(port):
    seen = port[2]
    bf16, f32 = torch.bfloat16, torch.float32
    assert [s[0] for s in seen] == ["ImageEncoder",
                                    "DirectPatchDecoder"] * STEPS
    for name, params, outs in seen:
        assert params == {bf16}, name
        if name == "ImageEncoder":
            assert outs == {"out": bf16}
        else:
            assert outs == dict(positions=f32, scales=bf16, rotations=bf16,
                                colors=bf16, opacities=bf16)


def test_amp_losses_match_jax(run, port):
    (want, _), (f32, _), got = run["amp"], run["f32"], port[0]
    assert len(want) == len(got) == STEPS
    for w, f, g in zip(want, f32, got):
        assert set(w) == set(g)
        for k in w:
            assert np.isfinite(g[k])
            gap = max(abs(w[k] - f[k]), LOSS_FLOOR * abs(w[k]))
            assert abs(g[k] - w[k]) <= GAP * gap, (k, g[k], w[k], f[k])


def test_amp_params_match_jax(run, port):
    (_, want), (_, f32), got = run["amp"], run["f32"], port[1]
    assert set(want) == set(got)
    for k, p in got.items():
        assert p.dtype == torch.float32
        assert (p - want[k]).abs().max().item() <= 2 * LR * STEPS, k
    n = sum(p.numel() for p in got.values())
    err = sum((got[k] - want[k]).abs().sum().item() for k in got) / n
    gap = sum((want[k] - f32[k]).abs().sum().item() for k in got) / n
    assert err <= GAP * gap, (err, gap)


FLAGS = ["--synthetic", "--synthetic_samples", "4", "--batch_size", "2",
         "--image_size", "32", "--feature_size", "5", "--train_encoder",
         "--encoder_width", "8", "--max_per_tile", "64", "--lpips_weight",
         "0", "--use_amp", "--device", "cpu"]


def test_cli_train_use_amp_resumes(tmp_path):
    out = str(tmp_path / "run")
    assert cli.main(["train", *FLAGS, "--epochs", "3", "--stop_epoch", "1",
                     "--output_dir", out]) == 0
    ckpt = tmp_path / "run" / "checkpoint_epoch1.pt"
    meta = json.loads(ckpt.with_suffix(".pt.json").read_text())
    assert meta["config"]["use_amp"] is True and meta["epoch"] == 0
    trainer, state = tcli.main([*FLAGS, "--epochs", "3", "--output_dir",
                                str(tmp_path / "resumed"), "--resume",
                                str(ckpt)])
    assert trainer.config.use_amp
    assert len(trainer.history["total"]) == 2          # epochs 1 and 2
    assert np.all(np.isfinite(trainer.history["total"]))
    assert int(state["step"]) == 3 * 2                  # 2 steps an epoch
    assert all(v.dtype == torch.float32 for v in state["params"].values())
