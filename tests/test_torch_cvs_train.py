"""Port parity: CVS training (train/train_cvs.py, losses/quality_aware.py)
against the JAX package's on the CPU, at 32^2, base 32, batch 2, with
use_quality_aware and concat_input_view on.  One jitted JAX init and step
are shared by the file (module fixture): 3 steps from the JAX init, the
second with a NaN in one target pixel, the timesteps and noise drawn in
the test from each step's key exactly as the JAX step draws them and
handed to the port's step.

* Losses at each step within 1e-5 relative (measured 6e-7); the NaN step's
  all NaN on both sides.
* Params per leaf: the largest difference within 2 * lr * steps (Adam's
  first steps are about lr * sign(g)) and the mean within 1e-6 (measured
  1.8e-8 at most), except the leaves whose gradient is zero in exact
  arithmetic and which step on rounding noise of either sign: the first
  conv's bias and the time projection of the residual blocks at 32
  channels (the next GroupNorm has one channel per group, and removes a
  per-channel constant), the last conv's bias before the output
  GroupNorm, and the adapter's attention key bias (the softmax removes a
  per-query constant).
* EMA params within 2e-7 of each other everywhere (a step moves them by
  1e-4 of the params' change; measured 4.5e-8); mu and nu per held leaf
  within 1e-2 of the leaf's largest value (measured 2.8e-3); the counts
  and steps equal.
* The guard (the NaN step): both packages zero the gradients, step the
  optimizer (the moments decay by b1 / b2, the count advances), keep the
  params and move the EMA toward them.
* The three datasets at 32^2 against JAX's: views within 1e-5 (measured
  9e-7), target depths within 1e-5, poses within 1e-6, features within
  1e-4 of their largest value (the patch extractor's resizes round
  differently; test_torch_dataset.py); the GT views from 64^2 corpus_v2
  sidecars resized as jax.image.resize(antialias=True) does; each
  package's npz cache read by the other, bit for bit.
* `main` for 1 epoch on --synthetic, resume from its `.pt` with the ramp
  continuing (both schedules), and resume from a JAX `.msgpack` written
  in the test: every leaf carried over exactly.
"""

import dataclasses
import json
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import flax.serialization as ser

from fresnel_tpu.losses import quality_aware as jqa
from fresnel_tpu.train import train_cvs as J

from fresnel_tpu_torch.data import raytrace_corpus
from fresnel_tpu_torch.losses import quality_aware as tqa
from fresnel_tpu_torch.train import train_cvs as T
from fresnel_tpu_torch.train.fit_teacher import init_raw
from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.train.flax_msgpack import flatten
from fresnel_tpu_torch.weights import cvs_state
from test_torch_threads import _few_threads  # noqa: F401

S = 32
CFG = dict(epochs=3, batch_size=2, image_size=S, base_channels=32,
           use_quality_aware=True, concat_input_view=True, save_interval=100)
KEYS, CW, NT = (3, 4, 5), 0.3, 1000
LR = 1e-4
LOSS_RTOL, PARAM_MEAN_TOL, EMA_TOL, MOMENT_RTOL = 1e-5, 1e-6, 2e-7, 1e-2
ZERO_GRAD = re.compile(r"ResBlock_(0|1|16|17)\.(Conv_0\.bias|Dense_0\.)"
                       r"|^unet\.Conv_7\.bias$|key\.bias$")
IMG_TOL, POSE_TOL, FEAT_RTOL = 1e-5, 1e-6, 1e-4


def _flat_state(state):
    return {k: np.asarray(v)
            for k, v in flatten(ser.to_state_dict(state)).items()}


def _draws(key, shape):
    r1, r2 = jax.random.split(key)
    return (np.array(jax.random.randint(r1, (shape[0],), 0, NT)),
            np.array(jax.random.normal(r2, shape, jnp.float32)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cvs_train")
    jds = J.GaussianBootstrapDataset(n_scenes=1, views_per_scene=3,
                                     image_size=S, n_gaussians=20, seed=0)
    tds = T.GaussianBootstrapDataset(n_scenes=1, views_per_scene=3,
                                     image_size=S, n_gaussians=20, seed=0,
                                     device="cpu")
    jcfg = J.CVSTrainConfig(output_dir=str(root / "j"), **CFG)
    jt = J.CVSTrainer(jcfg)
    batch = next(iter(jds.batches(2, np.random.default_rng(0))))
    state = jax.jit(jt.init_state)(batch)
    step = jt._build_step()
    states, losses, batches, draws = [_flat_state(state)], [], [], []
    for i, k in enumerate(KEYS):
        b = {kk: np.array(v) for kk, v in batch.items()}
        if i == 1:
            b["target_image"][0, 0, 0, 0] = np.nan
        key = jax.random.PRNGKey(k)
        draws.append(_draws(key, b["target_image"].shape))
        state, ld = step(state, jax.tree.map(jnp.asarray, b), key,
                         jnp.float32(CW))
        batches.append(b)
        losses.append({kk: float(v) for kk, v in ld.items()})
        states.append(_flat_state(state))
    msgpack = root / "cvs.msgpack"
    msgpack.write_bytes(ser.to_bytes(state))
    (root / "cvs.msgpack.json").write_text(json.dumps(
        {"epoch": 0, "config": dataclasses.asdict(jcfg)}))

    # The port's steps from the converted init, with the same draws.
    tt = T.CVSTrainer(T.CVSTrainConfig(output_dir=str(root / "t"), **CFG),
                      device="cpu")
    tstate = cvs_state(states[0])
    tstates, tlosses = [tstate], []
    for b, (ts, noise) in zip(batches, draws):
        tstate, ld = tt.train_step(tstate, tt.device_batch(b), CW,
                                   torch.from_numpy(ts).long(),
                                   torch.from_numpy(noise))
        tstates.append(tstate)
        tlosses.append({k: float(v) for k, v in ld.items()})
    return dict(root=root, jds=jds, tds=tds, states=states, losses=losses,
                tstates=tstates, tlosses=tlosses, msgpack=msgpack)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_step_matches_jax(run, i):
    jl, tl = run["losses"][i], run["tlosses"][i]
    assert set(jl) == set(tl) == {"l1", "perceptual", "consistency", "total"}
    for k in jl:
        if i == 1:
            assert np.isnan(jl[k]) and np.isnan(tl[k])
        else:
            assert abs(tl[k] - jl[k]) <= LOSS_RTOL * abs(jl[k]), k
    js, ts = cvs_state(run["states"][i + 1]), run["tstates"][i + 1]
    steps = i + 1
    for k, want in js["params"].items():
        d = (ts["params"][k] - want).abs()
        assert float(d.max()) <= 2 * LR * steps, k
        if not ZERO_GRAD.search(k):
            assert float(d.mean()) <= PARAM_MEAN_TOL, k
        assert float((ts["ema_params"][k] - js["ema_params"][k]).abs()
                     .max()) <= EMA_TOL, k
    for m in ("mu", "nu"):
        for k, want in js["opt_state"][m].items():
            if ZERO_GRAD.search(k):
                continue
            err = (ts["opt_state"][m][k] - want).abs().max()
            assert float(err) <= MOMENT_RTOL * float(want.abs().max()), (m, k)
    assert int(ts["opt_state"]["count"]) == int(js["opt_state"]["count"]) \
        == steps
    assert int(ts["step"]) == int(js["step"]) == steps
    for k, v in js["perc_params"].items():
        assert torch.equal(ts["perc_params"][k], v)


def test_guard_step(run):
    """The NaN step keeps the params bit for bit, decays the moments by
    b1 / b2 on zero gradients, advances the count and moves the EMA."""
    before, after = run["tstates"][1], run["tstates"][2]
    for k, p in before["params"].items():
        assert torch.equal(after["params"][k], p)
        assert torch.equal(after["opt_state"]["mu"][k],
                           0.9 * before["opt_state"]["mu"][k])
        assert torch.equal(after["opt_state"]["nu"][k],
                           0.999 * before["opt_state"]["nu"][k])
    assert int(after["opt_state"]["count"]) == 2
    moved = [k for k in before["params"]
             if not torch.equal(after["ema_params"][k],
                                before["ema_params"][k])]
    assert moved
    # JAX's guard step kept its params too.
    jb, ja = run["states"][1], run["states"][2]
    assert all(np.array_equal(jb[k], ja[k]) for k in jb
               if k.startswith("params/"))


def _assert_samples(got, want):
    assert len(got) == len(want)
    fscale = max(np.abs(s["features"]).max() for s in want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(T.SAMPLE_KEYS)
        for k in ("input_image", "target_image", "target_depth"):
            assert np.abs(g[k] - w[k]).max() <= IMG_TOL, k
        for k in ("R_rel", "t_rel"):
            assert g[k].dtype == np.float32
            assert np.abs(g[k] - w[k]).max() <= POSE_TOL, k
        assert np.abs(g["features"] - w["features"]).max() \
            <= FEAT_RTOL * fscale


def _assert_equal_samples(a, b):
    for x, y in zip(a, b):
        for k in T.SAMPLE_KEYS:
            np.testing.assert_array_equal(x[k], y[k])


def test_bootstrap_dataset_matches_jax(run):
    _assert_samples(run["tds"]._samples, run["jds"]._samples)
    jb = list(run["jds"].batches(1, np.random.default_rng(3)))
    tb = list(run["tds"].batches(1, np.random.default_rng(3)))
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):                       # the same order
        assert np.abs(a["t_rel"] - b["t_rel"]).max() <= POSE_TOL


def _check_caches(root, jcls, tcls, **kw):
    jc, tc = str(root / "jcache.npz"), str(root / "tcache.npz")
    jd = jcls(str(root), cache=jc, **kw)
    td = tcls(str(root), cache=tc, device="cpu", **kw)
    _assert_samples(td._samples, jd._samples)
    _assert_equal_samples(tcls(str(root), cache=jc, device="cpu",
                               **kw)._samples, jd._samples)
    _assert_equal_samples(jcls(str(root), cache=tc, **kw)._samples,
                          td._samples)


def test_teacher_dataset_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        img = rng.uniform(0.2, 0.9, (S, S, 3)).astype(np.float32)
        depth = rng.uniform(0.1, 0.9, (S, S)).astype(np.float32)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            tmp_path / f"{name}.png")
        depth.tofile(tmp_path / f"{name}_depth.bin")
        raw = init_raw(np.transpose(img, (2, 0, 1)), depth,
                       Camera.default_training(S), grid=5, K=1)
        np.savez(tmp_path / f"{name}_teacher.npz", raw=raw[0],
                 depth_offset=np.float32(-2.0))
    _check_caches(tmp_path, J.TeacherMultiviewDataset,
                  T.TeacherMultiviewDataset, image_size=S,
                  views_per_scene=3, seed=1)


def test_gt_dataset_matches_jax(tmp_path):
    """corpus_v2 at 64^2 read at 32^2: the antialiased linear downscale;
    scene 0 with a feature cache, scene 1 without."""
    raytrace_corpus.generate_corpus(str(tmp_path), n_images=2,
                                    image_size=64, seed=21)
    from fresnel_tpu_torch.data.dataset import cache_paths
    feats = np.random.default_rng(2).normal(size=(37, 37, 384)).astype(
        np.float32)
    feats.tofile(cache_paths(tmp_path / "scene_0000.png", S, 384)[1])
    _check_caches(tmp_path, J.GTMultiviewDataset, T.GTMultiviewDataset,
                  image_size=S, views_per_scene=3, seed=1)


def test_quality_aware_matches_jax():
    rng = np.random.default_rng(7)
    depth = rng.uniform(0, 1, (2, 16, 16)).astype(np.float32)
    pred = rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    ema = rng.uniform(0, 1, (2, 3, 16, 16)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tqa.depth_laplacian(t(depth)).numpy(),
                               np.asarray(jqa.depth_laplacian(depth)),
                               atol=1e-6)
    qm = tqa.quality_mask(t(depth))
    np.testing.assert_allclose(qm.numpy(),
                               np.asarray(jqa.quality_mask(depth)), atol=1e-6)
    for mask in (None, qm):
        jm = None if mask is None else mask.numpy()
        assert float(tqa.gradient_penalty(t(pred), mask)) == pytest.approx(
            float(jqa.gradient_penalty(pred, jm)), rel=1e-6)
    for kw in ({}, dict(target_depth=depth, x0_ema=ema,
                        consistency_weight=0.3)):
        got = tqa.quality_aware_cvs_loss(
            t(pred), t(tgt), **{k: t(v) if isinstance(v, np.ndarray) else v
                                for k, v in kw.items()})
        want = jqa.quality_aware_cvs_loss(pred, tgt, **kw)
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)


@pytest.mark.parametrize("qa", [False, True], ids=["ramp", "staircase"])
def test_consistency_ramp(qa):
    tt = T.CVSTrainer(T.CVSTrainConfig(image_size=S, base_channels=32,
                                       use_quality_aware=qa), device="cpu")
    for epochs in (3, 10, 50):
        for e in range(epochs):
            want = (jqa.consistency_weight_schedule(e, epochs) if qa
                    else min(1.0, (e + 1) / 10))
            assert tt.consistency_weight(e, epochs) == want
            assert tqa.consistency_weight_schedule(e, epochs) == \
                jqa.consistency_weight_schedule(e, epochs)


def _main(out, *extra):
    return T.main(["--synthetic", "--n_scenes", "1", "--image_size", str(S),
                   "--base_channels", "32", "--device", "cpu",
                   "--output_dir", str(out), *extra])


def test_main_one_epoch(tmp_path):
    trainer, state = _main(tmp_path, "--epochs", "1")
    for f in ("cvs_final.pt", "cvs_final.pt.json", "loss_history.json"):
        assert (tmp_path / f).exists()
    meta = json.loads((tmp_path / "cvs_final.pt.json").read_text())
    assert meta["epoch"] == 0 and meta["config"]["image_size"] == S
    hist = json.loads((tmp_path / "loss_history.json").read_text())
    assert len(hist["total"]) == 1 and np.isfinite(hist["total"][0])
    loaded, epoch = trainer.load_checkpoint(tmp_path / "cvs_final.pt")
    assert epoch == 0
    for g in ("params", "ema_params", "perc_params"):
        for k, v in state[g].items():
            assert torch.equal(loaded[g][k], v)
    assert int(loaded["opt_state"]["count"]) == 1


@pytest.mark.parametrize("qa", [False, True], ids=["ramp", "staircase"])
def test_resume_from_pt(tmp_path, capsys, qa):
    flags = ["--use_quality_aware"] if qa else []
    _main(tmp_path, "--epochs", "3", "--stop_epoch", "2", *flags)
    meta = json.loads((tmp_path / "cvs.pt.json").read_text())
    assert meta["epoch"] == 1 and not (tmp_path / "cvs_final.pt").exists()
    _main(tmp_path, "--epochs", "3", "--resume", str(tmp_path / "cvs.pt"),
          *flags)
    out = capsys.readouterr().out
    assert "continuing at 2" in out
    cws = re.findall(r"epoch (\d)/3 cw=([\d.]+)", out)
    want = ["0.10", "0.30", "1.00"] if qa else ["0.10", "0.20", "0.30"]
    assert cws == [(str(e + 1), w) for e, w in enumerate(want)]
    assert json.loads((tmp_path / "cvs_final.pt.json").read_text())[
        "epoch"] == 2


def test_resume_from_jax_msgpack(run, tmp_path, capsys):
    tt = T.CVSTrainer(T.CVSTrainConfig(**CFG), device="cpu")
    state, epoch = tt.load_checkpoint(run["msgpack"])
    assert epoch == 0
    flat = run["states"][-1]
    want = cvs_state(flat)
    for g in ("params", "ema_params", "perc_params"):
        assert len(state[g]) == len(want[g])
        for k, v in want[g].items():
            assert torch.equal(state[g][k], v), (g, k)
    for m in ("mu", "nu"):
        for k, v in want["opt_state"][m].items():
            assert torch.equal(state["opt_state"][m][k], v)
    assert int(state["opt_state"]["count"]) == 3 and int(state["step"]) == 3
    # The port's own layout of a JAX leaf: Conv kernels HWIO -> OIHW.
    np.testing.assert_array_equal(
        state["params"]["unet.Conv_0.weight"].numpy(),
        flat["params/params/unet/Conv_0/kernel"].transpose(3, 2, 0, 1))
    _main(tmp_path, "--epochs", "2", "--use_quality_aware",
          "--concat_input_view", "--resume", str(run["msgpack"]))
    out = capsys.readouterr().out
    assert "continuing at 1" in out and "epoch 2/2" in out
    assert "epoch 1/2" not in out
