"""Port parity: `Trainer` steps on the wave-optics training routes, against
the JAX package's, on the CPU; here the route of `cloud/train.sh full`.

The launcher's "full" mode passes `--use_phase_blending` without
`--use_phase_output`: the JAX package builds a tiled renderer with phase
blending on, the decoder emits no phases, so the step composites plain
(fresnel_tpu/render/tile.py:869).  The port used to raise for it in
`Trainer.__init__`.

Each route's file runs one JAX Trainer (module fixture): the flags through
both packages' `configs_from_args`, over a small config (64^2 here, batch
2, a 5^2 feature grid, K 2, dropout 0), 2 steps on 4 scenes of
`synthetic_corpus` (seed 3), and the port from the same converted init:
every loss term within 1e-4 relative, each params leaf's mean absolute
difference within 1e-6 (max within 2 * lr * steps), except the leaves
whose gradient is zero in exact arithmetic (tests/test_torch_trainer.py).
The helpers here serve the other routes' files
(tests/test_torch_wave_train_*.py).
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import train_gaussian_decoder as jcli
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
from fresnel_tpu_torch.train.harness import Trainer, build_decoder
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

STEPS, LR = 2, 2e-4
N_IMAGES, CORPUS_SEED = 4, 3
LOSS_RTOL, PARAM_MEAN_TOL = 1e-4, 1e-6
ZERO_GRAD = re.compile(r"res\.\d\.conv1\.bias|attn\.k\.bias")
SMALL = ["--batch_size", "2", "--epochs", "1", "--feature_size", "5",
         "--gaussians_per_patch", "2",
         "--train_encoder", "--encoder_width", "8", "--max_per_tile", "64",
         "--lr", str(LR), "--lpips_weight", "0",
         "--depth_offset_init", "-0.128", "--seed", "0"]
TRAIN_SH_FULL = ["--experiment", "2", "--use_fresnel_zones",
                 "--use_edge_aware", "--image_size", "64",
                 "--use_phase_blending", "--use_phase_retrieval_loss",
                 "--use_frequency_loss"]


def _flat_state(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


def run_both(root, flags, image_size):
    """2 steps of the JAX Trainer and of the port from one converted init,
    on the configs both CLIs make of `flags` + SMALL: (jax losses, port
    losses, jax final params, port trainer, port state)."""
    argv = flags + SMALL + ["--output_dir", str(root / "out")]
    jcfg = jcli.configs_from_args(jcli.build_parser().parse_args(argv))
    tcfg = tcli.configs_from_args(tcli.build_parser().parse_args(argv))
    K = jcfg[0].gaussians_per_patch
    jcorpus.generate_corpus(str(root / "data"), n_images=N_IMAGES,
                            image_size=image_size, seed=CORPUS_SEED)
    jdata = jds.ImageDataset(str(root / "data"), image_size=image_size,
                             feature_size=5, feature_dim=384,
                             use_augmentation=True)
    jt = JTrainer(*jcfg)
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(STEPS)
    nprng = np.random.default_rng(0)
    first = next(iter(jdata.batches(2, nprng)))
    state = jt.init_state(first)
    if "depth_offset" in state["params"]["model"]["params"]:
        state["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
            -0.128, jnp.float32)
    init = _flat_state(state["params"])
    step_fn = jt.get_step(K, None)
    rng = jax.random.PRNGKey(1)
    batches, jlosses = [], []
    for batch in jdata.batches(2, nprng):
        batches.append(batch)
        rng, sr = jax.random.split(rng)
        state, ld = step_fn(state, jt._device_batch(batch, nprng), sr)
        jlosses.append({k: float(v) for k, v in ld.items()})

    t = Trainer(*tcfg, device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    t._make_optimizer(STEPS)
    params = {k: v.clone() for k, v in trainer_params(init).items()}
    names = {f"model.{k}" for k, _ in t.model.named_parameters()} | {
        f"encoder.{k}" for k, _ in t.encoder.named_parameters()}
    assert set(params) - {"wavelengths_raw", "boundary_emphasis"} == names
    tstate = {"params": params, "opt_state": t.optimizer.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(1)
    tlosses = []
    for batch in batches:
        tstate, ld = t.train_step(tstate, t.device_batch(batch), K, None,
                                  gen)
        tlosses.append({k: float(v) for k, v in ld.items()})
    return dict(jlosses=jlosses, tlosses=tlosses,
                final=trainer_params(_flat_state(state["params"])),
                trainer=t, state=tstate)


def check_parity(run):
    assert len(run["jlosses"]) == len(run["tlosses"]) == STEPS
    for want, got in zip(run["jlosses"], run["tlosses"]):
        assert set(want) == set(got)
        for k, w in want.items():
            assert np.isfinite(w)
            assert abs(got[k] - w) <= LOSS_RTOL * max(abs(w), 1e-6), (
                k, got[k], w)
    got = run["state"]["params"]
    for k, w in run["final"].items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR * STEPS, (k, d.max().item())
        if not ZERO_GRAD.search(k):
            assert d.mean().item() <= PARAM_MEAN_TOL, (k, d.mean().item())


@pytest.fixture(scope="module")
def train_sh_full(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("train_sh_full"),
                    TRAIN_SH_FULL, 64)


def test_train_sh_full_route_matches_jax(train_sh_full):
    """Phase blending with no phases composites plain (K1 / K2), the
    tiled renderer's overflow telemetry logged, as in the JAX package."""
    t = train_sh_full["trainer"]
    assert type(t.renderer).__name__ == "TileRenderer"
    assert t.renderer.config.use_phase_blending
    assert "overflow_dropped_frac" in train_sh_full["tlosses"][0]
    assert "phase_retrieval" in train_sh_full["tlosses"][0]
    check_parity(train_sh_full)
