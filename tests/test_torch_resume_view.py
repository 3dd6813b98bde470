"""Port parity: resuming from the committed Flax checkpoints, and
view-aware training (`view_weight`, corpus_v2 GT orbit views, the
`z_offset_scale` head), against the JAX package's Trainer on the CPU.

Each case builds both trainers from a checkpoint's sidecar config at 64^2
with batch 2 and the LPIPS term off (as both CLIs turn it off without
weights), loads the checkpoint on both sides (a thin file on the JAX
side as its load_checkpoint makes it: float32 params, a fresh optax
state, the sidecar's step), and takes 2 steps by hand
on the same host batches with dropout 0 (JAX's dropout mask cannot be
reproduced):
* resume (this file): `results/exp2_model.msgpack` (full: Adam's moments
  and count 6 000 carried over) on a 4-scene `synthetic_corpus`;
* view (tests/test_torch_view_train.py, a file of its own so that each
  file's one JAX Trainer stays within the suite's per-file budget):
  `results/v2combo_model.msgpack` (thin: a fresh optimizer, so the cosine
  schedule restarts at its peak) with view_weight 0.5 on a 2-scene
  corpus_v2 (`raytrace_corpus`, seed 21), one epoch per step, so each
  step reshuffles and then draws its GT view from the same generator.
Held: every loss term within 1e-4 relative (measured 3.5e-6 resume,
1.2e-5 view); the GT views drawn equal; per leaf, the mean absolute
difference of the params within 2e-6 (measured 1.5e-8 resume, 4.2e-7
view), of mu within 1e-5 (1.1e-7, 1.8e-6: the first conv's bias, whose
gradient sums every pixel) and of nu within 1e-9 (2.9e-11, 1.2e-10), and
the params' max within 2 lr steps (Adam's first steps from a fresh state
are about lr * sign(g), so an entry whose gradient sits near zero may
step on one side only; measured 3.3e-4, 0.41 of the bound); the leaves
whose gradient is zero in exact arithmetic (the attention key biases, and
the residual blocks' first conv biases where a GroupNorm group holds one
channel) are held by the max alone.
Port-only: `cli train --resume X.msgpack` starts at the sidecar's epoch +
1 and writes its checkpoints.
"""

import json
import os
import re

import numpy as np
import flax.serialization as ser
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
from fresnel_tpu_torch.train.harness import Trainer, build_decoder
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, B, STEPS = 64, 2, 2
ZERO_GRAD = re.compile(r"res\.\d\.conv1\.bias|attn\.k\.bias")


def _ckpt(name):
    return os.path.join(ROOT, "results", f"{name}_model.msgpack")


def _configs(name, out_dir):
    with open(_ckpt(name) + ".json") as f:
        meta = json.load(f)
    cfg = dict(meta["config"], image_size=SIZE, batch_size=B,
               lpips_weight=0.0, output_dir=str(out_dir))
    return cfg, meta


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _run(name, data_dir, tmp):
    cfg, meta = _configs(name, tmp)
    jt = JTrainer(jconfig.TrainingConfig(**cfg),
                  jconfig.PhysicsConfig(**meta["physics_config"]),
                  jconfig.HFGSConfig(**meta["hfgs_config"]),
                  jconfig.HFTSConfig(**meta["hfts_config"]))
    jt.model = jt.model.clone(dropout=0.0)
    t = Trainer(tconfig.TrainingConfig(**cfg),
                tconfig.PhysicsConfig(**meta["physics_config"]),
                tconfig.HFGSConfig(**meta["hfgs_config"]),
                tconfig.HFTSConfig(**meta["hfts_config"]), device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    data = jds.ImageDataset(data_dir, image_size=SIZE, use_augmentation=False)
    if meta.get("thin"):
        # What JAX's load_checkpoint makes of a thin file, without the
        # template init it compiles only to read the dtypes (float32).
        with open(_ckpt(name), "rb") as f:
            params = jax.tree.map(
                lambda x: jnp.asarray(x, jnp.float32),
                ser.msgpack_restore(f.read())["params"])
        jstate = {"params": params, "opt_state": jt.optimizer.init(params),
                  "step": jnp.asarray(meta["step"], jnp.int32)}
        jepoch = meta["epoch"]
    else:
        first = next(iter(data.batches(B, np.random.default_rng(0))))
        jstate, jepoch = jt.load_checkpoint(_ckpt(name), first)
    tstate, tepoch = t.load_checkpoint(_ckpt(name))
    assert jepoch == tepoch
    K = cfg["gaussians_per_patch"]
    step_fn = jt.get_step(K, None)
    rng = jax.random.PRNGKey(1)
    gen = torch.Generator().manual_seed(1)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    jl, tl, drawn = [], [], []
    while len(jl) < STEPS:
        for jb_host, tb_host in zip(data.batches(B, jr), data.batches(B, tr)):
            jb = jt._device_batch(jb_host, jr)
            tb = t.device_batch(tb_host, tr)
            if "view_gt" in jb:
                drawn.append((np.asarray(jb["view_gt"]),
                              tb["view_gt"].numpy(),
                              np.asarray(jb["view_az_deg"]),
                              tb["view_az_rad"]))
            rng, sr = jax.random.split(rng)
            jstate, ld = step_fn(jstate, jb, sr)
            jl.append({k: float(v) for k, v in ld.items()})
            tstate, ld = t.train_step(tstate, tb, K, None, gen)
            tl.append({k: float(v) for k, v in ld.items()})
            if len(jl) == STEPS:
                break
    return dict(cfg=cfg, jstate=jstate, tstate=tstate, jl=jl, tl=tl,
                drawn=drawn, t=t)


@pytest.fixture(scope="module")
def resume(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    jcorpus.generate_corpus(str(root / "data"), n_images=4,
                            image_size=SIZE, seed=0)
    return _run("exp2", str(root / "data"), root / "out")


def _check_losses(run):
    assert len(run["jl"]) == len(run["tl"]) == STEPS
    for want, got in zip(run["jl"], run["tl"]):
        assert set(want) == set(got)
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k], w)


def _check_leaves(got, want, mean_tol, max_tol=None):
    for k, w in want.items():
        d = (got[k] - w).abs()
        if max_tol is not None:
            assert d.max().item() <= max_tol, (k, d.max().item())
        if not ZERO_GRAD.search(k):
            assert d.mean().item() <= mean_tol, (k, d.mean().item())


def _check_state(run, count0):
    js, ts = run["jstate"], run["tstate"]
    lr = run["cfg"]["lr"]
    _check_leaves(ts["params"], trainer_params(_flat(js["params"])), 2e-6,
                  2 * lr * STEPS)
    adam = js["opt_state"][1][0]
    _check_leaves(ts["opt_state"]["mu"], trainer_params(_flat(adam.mu)),
                  1e-5)
    _check_leaves(ts["opt_state"]["nu"], trainer_params(_flat(adam.nu)),
                  1e-9)
    assert int(ts["opt_state"]["count"]) == int(adam.count) == count0 + STEPS
    assert int(ts["step"]) == int(js["step"])


def test_resume_losses_match_jax(resume):
    _check_losses(resume)
    assert "view" not in resume["tl"][0]


def test_resume_state_matches_jax(resume):
    _check_state(resume, 6000)


def test_cli_resume_from_msgpack(resume, tmp_path):
    out = tmp_path / "cli"
    data = os.path.join(os.path.dirname(resume["cfg"]["output_dir"]), "data")
    trainer, state = tcli.main([
        "--data_dir", data, "--output_dir", str(out), "--epochs", "302",
        "--batch_size", "2", "--lr", "2e-4", "--image_size", str(SIZE),
        "--gaussians_per_patch", "4", "--surface_init",
        "--depth_offset_init", "-0.128", "--max_per_tile", "1024",
        "--no_augmentation", "--resume", _ckpt("exp2"), "--device", "cpu"])
    assert len(trainer.history["total"]) == 1            # epoch 301 only
    assert int(state["step"]) == 6000 + 2
    assert (out / "final_model.pt").exists()
    with open(out / "final_model.pt.json") as f:
        assert json.load(f)["epoch"] == 301
