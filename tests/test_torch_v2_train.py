"""Port parity: v2 distillation training (train/train_direct_decoder.py,
data/trellis.py, weights.v2_state) against the JAX package's on the CPU,
without the render loss (test_torch_v2_render.py holds it with), at
features 32 over 16 patches, hidden 48, 2 blocks of 4 heads, 2 Gaussians
per voxel, max_coords 64, max_gaussians 128, max_match_points 64 (the
predictions subsampled), batch 2.  One jitted JAX step is shared by the
file (module fixture), both models with dropout 0 (its draws are each
package's own generator's): 3 steps from the JAX init, the second with a
NaN in one valid occupancy target.

* Losses at each step within 1e-5 relative (each term); the NaN step's
  total NaN on both sides.
* Params per leaf within 1e-6 by mean and 2 * lr * steps at most (Adam's
  first steps move a leaf by about lr); Adam's moments per leaf within
  1e-2 of the leaf's largest value; the counts and steps equal.
* The guard (the NaN step): both packages zero the gradients, step the
  optimizer (moments decayed by b1 / b2, the count advanced) and keep the
  params.
* A JAX `.msgpack` checkpoint of the state after step 3 loads into the
  port (every leaf exactly `v2_state`'s, the epoch from its sidecar), and
  one more step from it matches JAX's.
* `training_mode="end_to_end"` is inert (the step is the same, bit for
  bit); `fit` consumes one shuffle for its init batch and rewrites
  best_v2 at every `save_interval` (both packages' `fit` driven with the
  same stand-in step).
* Both datasets bit for bit with the JAX package's, with batch order; the
  TRELLIS files written by `SyntheticTrellisDataset.write` (also with
  (1, P, F) features and (N, 3) coords) read by both packages.
* `main --synthetic` on the CPU writes best_v2.pt, final_v2.pt with the
  JAX package's sidecar, and loss_history.json; `load_checkpoint` of
  final_v2.pt gives its state back.
"""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import flax.serialization as ser

from fresnel_tpu.data import trellis as JD
from fresnel_tpu.train import train_direct_decoder as J
from fresnel_tpu_torch.data import trellis as TD
from fresnel_tpu_torch.train import train_direct_decoder as T
from fresnel_tpu_torch.train.flax_msgpack import flatten
from fresnel_tpu_torch.weights import v2_state
from test_torch_threads import _few_threads  # noqa: F401

LR = 1e-4
CFG = dict(feature_dim=32, hidden_dim=48, num_layers=2, num_heads=4,
           num_gaussians_per_voxel=2, max_coords=64, max_gaussians=128,
           max_match_points=64, batch_size=2, lr=LR, save_interval=100)
DATA = dict(max_coords=64, max_gaussians=128, n_gaussians=100,
            feature_dim=32, num_patches=16)
LOSS_RTOL, PARAM_MEAN_TOL, MOMENT_RTOL = 1e-5, 1e-6, 1e-2
NAN_STEP = 1


def _flat_state(state):
    return {k: np.asarray(v)
            for k, v in flatten(ser.to_state_dict(state)).items()}


def _batches(n=4, seed=0):
    ds = JD.SyntheticTrellisDataset(n_samples=n, seed=seed, **DATA)
    return list(ds.batches(2, np.random.default_rng(0)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2_train")
    jcfg = J.V2Config(output_dir=str(root / "j"), **CFG)
    jt = J.V2Trainer(jcfg)
    jt.model = jt.model.clone(dropout=0.0)
    batches = _batches(8)
    state = jax.jit(jt.init_state)(batches[0])
    step = jt._build_step()
    states, losses, used = [_flat_state(state)], [], []
    rng = jax.random.PRNGKey(1)
    for i, b in enumerate(batches[:3]):
        b = {k: np.array(v) for k, v in b.items()}
        if i == NAN_STEP:
            b["occupancy"][0, 0] = np.nan
        rng, srng = jax.random.split(rng)
        state, ld = step(state, jax.tree.map(jnp.asarray, b), srng)
        used.append(b)
        losses.append({k: float(v) for k, v in ld.items()})
        states.append(_flat_state(state))
    jt.save_checkpoint(root / "v2.msgpack", state, 4)
    rng, srng = jax.random.split(rng)
    _, ld = step(state, jax.tree.map(jnp.asarray, batches[3]), srng)
    resumed = {k: float(v) for k, v in ld.items()}

    tt = T.V2Trainer(T.V2Config(output_dir=str(root / "t"), **CFG),
                     device="cpu")
    tt.model.dropout = 0.0
    tstate = v2_state(states[0])
    tstates, tlosses = [tstate], []
    for b in used:
        tstate, ld = tt.train_step(tstate, tt.device_batch(b))
        tstates.append(tstate)
        tlosses.append({k: float(v) for k, v in ld.items()})
    return dict(root=root, tt=tt, batches=batches, states=states,
                losses=losses, tstates=tstates, tlosses=tlosses,
                resumed=resumed)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_step_matches_jax(run, i):
    jl, tl = run["losses"][i], run["tlosses"][i]
    assert set(jl) == set(tl) == {"total", "position", "scale", "rotation",
                                  "color", "opacity", "coverage",
                                  "occupancy"}
    for k in jl:
        if i == NAN_STEP and k in ("total", "occupancy"):
            assert np.isnan(jl[k]) and np.isnan(tl[k]), k
        else:
            assert abs(tl[k] - jl[k]) <= LOSS_RTOL * abs(jl[k]), k
    js, ts = v2_state(run["states"][i + 1]), run["tstates"][i + 1]
    steps = i + 1 - (i >= NAN_STEP)
    for k, want in js["params"].items():
        d = (ts["params"][k] - want).abs()
        assert d.mean().item() <= PARAM_MEAN_TOL, k
        assert d.max().item() <= 2 * LR * max(steps, 1), k
    for m in ("mu", "nu"):
        for k, want in js["opt_state"][m].items():
            d = (ts["opt_state"][m][k] - want).abs().max().item()
            assert d <= MOMENT_RTOL * max(want.abs().max().item(), 1e-30), \
                (m, k)
    assert int(ts["opt_state"]["count"]) == int(js["opt_state"]["count"])
    assert int(ts["step"]) == int(js["step"]) == i + 1


def test_guard_keeps_params_and_steps_the_optimizer(run):
    for states in (run["tstates"],
                   [v2_state(s) for s in run["states"]]):
        before, after = states[NAN_STEP], states[NAN_STEP + 1]
        for k, v in before["params"].items():
            assert torch.equal(after["params"][k], v), k
        assert int(after["opt_state"]["count"]) == NAN_STEP + 1
        for k, v in before["opt_state"]["mu"].items():
            torch.testing.assert_close(after["opt_state"]["mu"][k], 0.9 * v,
                                       rtol=1e-6, atol=0)
            torch.testing.assert_close(after["opt_state"]["nu"][k],
                                       0.999 * before["opt_state"]["nu"][k],
                                       rtol=1e-6, atol=0)


def test_resume_from_jax_msgpack(run):
    tt = run["tt"]
    state, epoch = tt.load_checkpoint(run["root"] / "v2.msgpack")
    assert epoch == 4
    want = v2_state(run["states"][-1])
    for k, v in want["params"].items():
        assert torch.equal(state["params"][k], v), k
    for m in ("mu", "nu"):
        for k, v in want["opt_state"][m].items():
            assert torch.equal(state["opt_state"][m][k], v), (m, k)
    assert int(state["opt_state"]["count"]) == 3 and int(state["step"]) == 3
    _, ld = tt.train_step(state, tt.device_batch(run["batches"][3]))
    for k, v in run["resumed"].items():
        assert abs(float(ld[k]) - v) <= LOSS_RTOL * abs(v), k


def test_end_to_end_mode_is_inert(run):
    b = run["tt"].device_batch(run["batches"][0])
    outs = []
    for mode in ("structure_supervised", "end_to_end"):
        t = T.V2Trainer(T.V2Config(training_mode=mode, **CFG), device="cpu")
        t.model.dropout = 0.0
        outs.append(t.train_step(v2_state(run["states"][0]), b))
    (s1, l1), (s2, l2) = outs
    assert all(torch.equal(l1[k], l2[k]) for k in l1)
    assert all(torch.equal(s1["params"][k], s2["params"][k])
               for k in s1["params"])


class _Losses:
    """A stand-in step: records each batch's coords and returns the next
    total of `totals`, so `fit`'s order and checkpoint rule show."""

    def __init__(self, totals, mk):
        self.totals, self.mk, self.seen = list(totals), mk, []

    def __call__(self, state, batch, *_):
        self.seen.append(np.asarray(batch["coords"]).copy())
        return state, {"total": self.mk(self.totals.pop(0))}


def test_fit_order_and_best_at_save_interval(tmp_path):
    ds_j = JD.SyntheticTrellisDataset(n_samples=4, seed=3, **DATA)
    ds_t = TD.SyntheticTrellisDataset(n_samples=4, seed=3, **DATA)
    # Per epoch (two batches each): 1.0 (a best), 2.0 (not a best; epoch
    # 2 is a save_interval), 3.0 (neither).
    totals = [1.0, 1.0, 2.0, 2.0, 3.0, 3.0]
    saved = {}
    cfg = dict(CFG, save_interval=2, epochs=3)
    jt = J.V2Trainer(J.V2Config(output_dir=str(tmp_path / "j"), **cfg))
    jt._step = _Losses(totals, jnp.float32)
    jt.save_checkpoint = lambda p, s, e: saved.setdefault("jax", []).append(
        (p.name, e))
    jt.fit(ds_j, state={}, log_fn=lambda *_: None)
    tt = T.V2Trainer(T.V2Config(output_dir=str(tmp_path / "t"), **cfg),
                     device="cpu")
    tt.train_step = _Losses(totals, lambda v: torch.tensor(v))
    tt.save_checkpoint = lambda p, s, e: saved.setdefault("port", []).append(
        (p.name, e))
    tt.fit(ds_t, state={}, log_fn=lambda *_: None)
    assert saved["jax"] == [("best_v2.msgpack", 0), ("best_v2.msgpack", 1),
                            ("final_v2.msgpack", 2)]
    assert saved["port"] == [("best_v2.pt", 0), ("best_v2.pt", 1),
                             ("final_v2.pt", 2)]
    assert len(jt._step.seen) == len(tt.train_step.seen) == 6
    for a, b in zip(jt._step.seen, tt.train_step.seen):
        assert np.array_equal(a, b)
    # The first epoch's batches follow the init batch's shuffle.
    rng = np.random.default_rng(0)
    next(iter(ds_t.batches(2, rng)))
    first = next(iter(ds_t.batches(2, rng)))
    assert np.array_equal(first["coords"], tt.train_step.seen[0])


def _equal_samples(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a._samples, b._samples):
        assert sa.keys() == sb.keys()
        for k in sa:
            assert sa[k].dtype == np.asarray(sb[k]).dtype, k
            assert np.array_equal(sa[k], np.asarray(sb[k])), k


def test_synthetic_dataset_bit_for_bit():
    j = JD.SyntheticTrellisDataset(n_samples=5, seed=7, **DATA)
    t = TD.SyntheticTrellisDataset(n_samples=5, seed=7, **DATA)
    _equal_samples(j, t)
    jb = list(j.batches(2, np.random.default_rng(5)))
    tb = list(t.batches(2, np.random.default_rng(5)))
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("layout", ["padded", "leading_batch_xyz"])
def test_trellis_files_bit_for_bit(tmp_path, layout):
    src = TD.SyntheticTrellisDataset(n_samples=3, seed=2, **DATA)
    src.write(str(tmp_path))
    if layout == "leading_batch_xyz":
        for d in sorted(tmp_path.iterdir()):
            f = torch.load(d / "features.pt")
            torch.save(f[None], d / "features.pt")
            c = torch.load(d / "coords.pt")
            torch.save(c[:, 1:], d / "coords.pt")
    (tmp_path / "not_a_sample").mkdir()
    kw = dict(max_coords=48, max_gaussians=96)
    j = JD.TrellisDistillationDataset(str(tmp_path), **kw)
    t = TD.TrellisDistillationDataset(str(tmp_path), **kw)
    _equal_samples(j, t)
    assert len(t) == 3
    t2 = TD.TrellisDistillationDataset(str(tmp_path), max_samples=2, **kw)
    assert len(t2) == 2
    # The written rows come back: coords exactly, Gaussians within the
    # PLY's float32 log / logit round trip.
    back = TD.TrellisDistillationDataset(str(tmp_path), max_coords=64,
                                         max_gaussians=128)
    for a, b in zip(src._samples, back._samples):
        assert np.array_equal(a["coords"], b["coords"])
        assert np.array_equal(a["gaussian_mask"], b["gaussian_mask"])
        np.testing.assert_allclose(b["gaussians"], a["gaussians"],
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        TD.TrellisDistillationDataset(str(tmp_path / "not_a_sample"))


def test_synthetic_cli(tmp_path):
    out = tmp_path / "out"
    trainer, state = T.main([
        "--synthetic", "--synthetic_samples", "2", "--epochs", "2",
        "--feature_dim", "16", "--hidden_dim", "24", "--num_layers", "1",
        "--num_gaussians_per_voxel", "2", "--output_dir", str(out),
        "--device", "cpu"])
    assert trainer.cfg.max_coords == 512 and trainer.cfg.max_gaussians == 1024
    for name in ("best_v2.pt", "final_v2.pt", "loss_history.json",
                 "final_v2.pt.json", "best_v2.pt.json"):
        assert (out / name).exists(), name
    meta = json.loads((out / "final_v2.pt.json").read_text())
    assert meta["epoch"] == 1
    assert meta["config"] == dataclasses.asdict(trainer.cfg)
    assert set(meta["config"]) == {
        f.name for f in dataclasses.fields(J.V2Config)}
    hist = json.loads((out / "loss_history.json").read_text())
    assert len(hist["total"]) == 2 and np.all(np.isfinite(hist["total"]))
    assert int(state["step"]) == 2
    back, epoch = trainer.load_checkpoint(out / "final_v2.pt")
    assert epoch == 1
    for k, v in state["params"].items():
        assert torch.equal(back["params"][k], v), k
