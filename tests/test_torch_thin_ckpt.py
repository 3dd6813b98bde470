"""Port parity: `train.thin_ckpt` and `train.reconstruct_sidecar` on the
CPU.

* `to_thin` of a full JAX checkpoint (a JAX Trainer's init state at a
  small config with learnable wavelengths, saved
  by its `save_checkpoint`): the port's thin `.pt` holds bf16 leaves
  whose bits are the JAX tool's `ml_dtypes` casts, and the port's
  `load_thin_params` equals the JAX package's `load_thin_params`
  (carried into the port's names) bit for bit; the sidecar is JAX's with
  `thin` and `step`.
* A port `.pt` -> thin `.pt` (under 1/4 of the size) ->
  `Trainer.load_checkpoint`: params the bf16 roundings of the saved
  ones, a fresh optimizer state (count 0, zero moments), step and epoch
  from the sidecar; the resumed state trains one step (step + 1, finite
  loss).  The CLI prints the JAX tool's line; a `.msgpack` destination
  is refused (the port writes `.pt`).
* `reconstruct_sidecar` for the training flags of
  `cloud/train_overnight.sh` and the E74 / GZI runs of
  `cloud/round5_queue1.sh`: the port's JSON equals the JAX tool's as a
  dict (no field differs); the CLI form sets the epoch.
"""

import json
import re
import shlex
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train import reconstruct_sidecar as jrec
from fresnel_tpu.train import thin_ckpt as jthin
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.data.dataset import SyntheticGaussianDataset
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import reconstruct_sidecar as trec
from fresnel_tpu_torch.train import thin_ckpt as tthin
from fresnel_tpu_torch.train.harness import Trainer
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(experiment=2, epochs=1, batch_size=2, image_size=32,
           feature_size=5, feature_dim=48, gaussians_per_patch=2,
           max_per_tile=64, lpips_weight=0.0, save_interval=100, seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=True)


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


def _port_trainer(out_dir, **kw):
    return Trainer(tconfig.TrainingConfig(output_dir=str(out_dir),
                                          **dict(CFG, **kw)),
                   tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                   tconfig.HFTSConfig(), device="cpu")


def test_thin_of_jax_checkpoint(tmp_path):
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(tmp_path), **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(size=(2, 3, 32, 32)).astype(np.float32),
             "features": rng.normal(size=(2, 5, 5, 48)).astype(np.float32),
             "depth": rng.uniform(size=(2, 256, 256)).astype(np.float32)}
    state = jt.init_state(batch)
    state["step"] = jnp.asarray(41)
    full = tmp_path / "full.msgpack"
    jt.save_checkpoint(full, state, 3)
    jmeta = jthin.to_thin(full, tmp_path / "thin.msgpack")
    tmeta = tthin.to_thin(full, tmp_path / "thin.pt")
    assert tmeta == jmeta and tmeta["thin"] and tmeta["step"] == 41
    assert json.loads((tmp_path / "thin.pt.json").read_text()) == json.loads(
        (tmp_path / "thin.msgpack.json").read_text())

    # The bf16 bits: the port's leaves against ml_dtypes' casts.
    want = trainer_params(_flat(jax.tree.map(
        lambda x: np.asarray(x).astype(ml_dtypes.bfloat16).astype(
            np.float32), state["params"])))
    raw = torch.load(str(tmp_path / "thin.pt"), weights_only=True)["params"]
    assert set(raw) == set(want)
    for k, v in raw.items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v.float(), want[k]), k

    # The readers: JAX's load_thin_params against the port's.
    jparams = jthin.load_thin_params(tmp_path / "thin.msgpack",
                                     state["params"])
    jp = trainer_params(_flat(jparams))
    template = _port_trainer(tmp_path).init_state()["params"]
    for path in (tmp_path / "thin.pt", tmp_path / "thin.msgpack"):
        got = tthin.load_thin_params(path, template)
        assert set(got) == set(jp)
        for k, v in got.items():
            assert v.dtype == torch.float32 and torch.equal(v, jp[k]), k


def test_thin_pt_resumes(tmp_path, capsys):
    trainer = _port_trainer(tmp_path, epochs=9)
    state = trainer.init_state()
    state["step"] = torch.tensor(123, dtype=torch.int32)
    full = tmp_path / "full.pt"
    trainer.save_checkpoint(full, state, 7)
    assert tthin.main([str(full), str(tmp_path / "thin.pt")]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r".*full\.pt \(\d+\.\d MB\) -> .*thin\.pt "
                        r"\(\d+\.\d MB\) epoch=7 step=123", line), line
    meta = json.loads((tmp_path / "thin.pt.json").read_text())
    assert meta["thin"] and meta["step"] == 123 and meta["epoch"] == 7
    assert ((tmp_path / "thin.pt").stat().st_size
            < (tmp_path / "full.pt").stat().st_size / 4)

    back, epoch = trainer.load_checkpoint(tmp_path / "thin.pt")
    assert epoch == 7 and int(back["step"]) == 123
    for k, v in state["params"].items():
        assert torch.equal(back["params"][k],
                           v.to(torch.bfloat16).to(torch.float32)), k
    assert int(back["opt_state"]["count"]) == 0
    assert all(not t.any() for m in ("mu", "nu")
               for t in back["opt_state"][m].values())

    ds = SyntheticGaussianDataset(n_samples=2, image_size=32, feature_size=5,
                                  feature_dim=48, n_gaussians=40, seed=1,
                                  device="cpu")
    out = trainer.fit(ds, state=back, start_epoch=epoch + 1,
                      log_fn=lambda *_: None)
    assert int(out["step"]) == 124
    assert len(trainer.history["total"]) == 1
    assert np.isfinite(trainer.history["total"][0])

    with pytest.raises(ValueError, match=r"\.pt"):
        tthin.to_thin(full, tmp_path / "thin.msgpack")


def _overnight_flags():
    text = (ROOT / "cloud" / "train_overnight.sh").read_text()
    cmd = re.search(r"fresnel_tpu\.train\.train_gaussian_decoder(.*?)2>&1",
                    text, re.S).group(1)
    return [{"$DATA_DIR": "images", "$OUT": "out"}.get(a, a)
            for a in shlex.split(cmd.replace("\\\n", " "))]


def _queue1_flags(name):
    text = (ROOT / "cloud" / "round5_queue1.sh").read_text()
    return shlex.split(re.search(rf'^{name}="(.*?)"', text,
                                 re.S | re.M).group(1))


@pytest.mark.parametrize("run", ["overnight", "E74", "GZI"])
def test_reconstruct_sidecar_matches(run, tmp_path):
    flags = _overnight_flags() if run == "overnight" else _queue1_flags(run)
    assert "--experiment" in flags and "--data_dir" in flags
    jout = jrec.reconstruct(str(tmp_path / "j.msgpack"), flags, epoch=300)
    tout = trec.reconstruct(str(tmp_path / "t.pt"), flags, epoch=300)
    assert tout.name == "t.pt.json"
    assert json.loads(tout.read_text()) == json.loads(jout.read_text())


def test_reconstruct_sidecar_cli(tmp_path):
    ckpt = tmp_path / "model.pt"
    assert trec.main([str(ckpt), "--epoch", "7", "--", "--experiment", "4",
                      "--n_spiral_points", "377"]) == 0
    meta = json.loads((tmp_path / "model.pt.json").read_text())
    assert meta["epoch"] == 7
    assert tconfig.TrainingConfig(**meta["config"]).n_spiral_points == 377
    assert trec.main([str(ckpt)]) == 2
