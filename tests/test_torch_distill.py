"""Port parity: experiment 4's teacher fits and raw-head distillation
against the JAX package, on the CPU, on a 4-scene `synthetic_corpus` at
64^2 with 377 spiral points.

* `init_raw_fib`: bit for bit (the same float32 ops, and the spiral's
  sampled depths and projections in the same bits at the init).
* `fit_scene(experiment=4)`, 5 steps: the loss at each step within 1e-4
  relative, SSIM within 1e-5, PSNR within 1e-4 dB, the depth offset
  within 1e-5, raw by its mean absolute difference (1e-4; Adam's first
  steps are ~lr * sign(g), so the largest is only bounded by
  2 * lr * steps).  For one image XLA rounds a few of the sampled depths
  1 ulp apart from the port (tests/test_torch_fibonacci.py).
* Sidecars: `fit_teacher.main` writes `{stem}_teacher4.npz` with the JAX
  package's keys and dtypes, and skips a scene whose sidecar the JAX
  package wrote; both packages' `ImageDataset` read all four equal.
* The Trainer (one JAX run for the file): experiment 4 at a small width
  (feature grid 37 x 48 channels, the decoder's MLP 512 / 256 / 128, 377
  points, K 4 asked, 1 given), distill_weight 1, scale_bias -2.6,
  opacity_bias 1.5, dropout 0 on both sides (JAX's masks cannot be
  reproduced), batch 2: two steps at distill_scale 1 and 0.5 from one
  init, `total` and `distill` within 1e-5 relative at each step; `fit`
  over 2 epochs with distill_decay_epochs 2 from the same init, each
  epoch's `total` and `distill` within 1e-4 relative; `fit` from no state
  starts the depth offset at the first batch's teacher mean, as JAX's
  does; without sidecars it raises ValueError.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train import fit_teacher as jfit
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.data import dataset as tds
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import fit_teacher as tfit
from fresnel_tpu_torch.train.harness import Trainer, build_decoder
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

RES, N, STEPS, MPT, DO0 = 64, 377, 5, 256, -0.13
FIT = dict(steps=STEPS, grid=N, K=1, res=RES, max_per_tile=MPT,
           experiment=4, depth_offset_init=DO0)
K = 4
CFG = dict(experiment=4, epochs=2, batch_size=2, image_size=RES,
           feature_size=37, feature_dim=48, n_spiral_points=N,
           gaussians_per_patch=K, max_per_tile=MPT, lr=2e-4,
           weight_decay=1e-5, scale_bias=-2.6, opacity_bias=1.5,
           distill_weight=1.0, distill_decay_epochs=2, rgb_weight=1.0,
           ssim_weight=0.5, depth_weight=0.1, lpips_weight=0.0,
           use_augmentation=False, save_interval=100, seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)
DS = dict(image_size=RES, feature_size=37, feature_dim=48,
          use_augmentation=False, teacher_experiment=4)
SCALES = (1.0, 0.5)
# The schedule's length in `fit` (2 epochs of 2 steps): the JAX trainer
# compiles its step with the optimizer it has, and `fit` reuses it.
TOTAL_STEPS = 4


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in flatten_dict(v, sep="/").items():
                out[f"{k}/{kk}"] = np.array(vv)
        else:
            out[k] = np.array(v)
    return out


def _scene(data, i):
    img = jds._load_image(data / f"scene_{i:04d}.png", RES)
    depth = np.fromfile(data / f"scene_{i:04d}_depth.bin",
                        np.float32).reshape(256, 256)
    return np.ascontiguousarray(img.transpose(2, 0, 1)), depth


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus, scene 3's sidecar written by the JAX package (its
    `main`'s body), the others by the port's `main`; the JAX fit of scene
    0 with the losses of each step, replayed through its compiled step."""
    root = tmp_path_factory.mktemp("distill4")
    data = root / "data"
    jcorpus.generate_corpus(str(data), n_images=4, image_size=RES, seed=3)
    cache = {}
    image, depth = _scene(data, 3)
    teacher, _ = jfit.fit_scene(image, depth, step_fn_cache=cache, **FIT)
    np.savez(jfit.teacher_path(data / "scene_0003.png", 4), **teacher)
    image, depth = _scene(data, 0)
    jt, jm = jfit.fit_scene(image, depth, step_fn_cache=cache, **FIT)
    (entry,) = cache.values()
    raw0 = jfit.init_raw_fib(image, depth, JCamera.default_training(RES),
                             n_points=N)
    params = {"raw": jnp.asarray(raw0), "do": jnp.asarray(DO0, jnp.float32)}
    opt_state = entry["opt"].init(params)
    losses = []
    for _ in range(STEPS):
        params, opt_state, l = entry["step"](
            params, opt_state, jnp.asarray(depth)[None], jnp.asarray(image))
        losses.append(float(l))
    records = tfit.main(["--data_dir", str(data), "--experiment", "4",
                         "--grid", str(N), "--steps", str(STEPS), "--res",
                         str(RES), "--device", "cpu"])
    return dict(root=root, data=data, jax_teacher=jt, jax_metrics=jm,
                jax_losses=losses, raw0=raw0, records=records)


def test_init_raw_fib_matches_jax(corpus):
    image, depth = _scene(corpus["data"], 0)
    got = tfit.init_raw_fib(image, depth, Camera.default_training(RES),
                            n_points=N)
    assert got.shape == (1, N, 1, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, corpus["raw0"])


def test_fit_scene4_matches_jax(corpus):
    image, depth = _scene(corpus["data"], 0)
    tt, tm = tfit.fit_scene(image, depth, device="cpu", **FIT)
    jt, jm = corpus["jax_teacher"], corpus["jax_metrics"]
    np.testing.assert_allclose(tm["losses"], corpus["jax_losses"], rtol=1e-4)
    assert tm["losses"][-1] < tm["losses"][0]
    assert abs(tm["ssim"] - jm["ssim"]) <= 1e-5
    assert abs(tm["psnr"] - jm["psnr"]) <= 1e-4
    assert abs(float(tt["depth_offset"]) - float(jt["depth_offset"])) <= 1e-5
    assert tt["raw"].shape == jt["raw"].shape == (N, 1, 16)
    diff = np.abs(tt["raw"] - jt["raw"])
    assert diff.mean() <= 1e-4 and diff.max() <= 2 * 1e-2 * STEPS


def test_sidecars_cross_read(corpus):
    data = corpus["data"]
    assert [r["name"] for r in corpus["records"]] == [
        "scene_0000", "scene_0001", "scene_0002"]       # 3's was there
    for i in range(4):
        with np.load(data / f"scene_{i:04d}_teacher4.npz") as z:
            assert set(z.files) == {"raw", "depth_offset", "ssim", "psnr"}
            assert z["raw"].shape == (N, 1, 16)
            assert all(z[k].dtype == np.float32 for k in z.files)
            assert z["depth_offset"].shape == ()
    j = jds.ImageDataset(str(data), **DS)
    t = tds.ImageDataset(str(data), device="cpu", **DS)
    for a, b in zip(j._samples, t._samples):
        np.testing.assert_array_equal(a.teacher_raw, b.teacher_raw)
        np.testing.assert_array_equal(a.teacher_do, b.teacher_do)
    batch = next(iter(t.batches(2, np.random.default_rng(0))))
    assert batch["teacher_raw"].shape == (2, N, 1, 16)
    assert batch["teacher_do"].shape == (2,)


def _port_trainer(out_dir, **over):
    t = Trainer(tconfig.TrainingConfig(output_dir=str(out_dir),
                                       **dict(CFG, **over)),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    return t


def _port_state(t, flat):
    params = {k: v.clone() for k, v in trainer_params(flat).items()}
    return {"params": params, "opt_state": t.optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


@pytest.fixture(scope="module")
def run(corpus):
    root = corpus["root"]
    jdata = jds.ImageDataset(str(corpus["data"]), **DS)
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(root / "jfit"),
                                         **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig())
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(TOTAL_STEPS)
    nprng = np.random.default_rng(0)
    first = next(iter(jdata.batches(2, nprng)))
    state = jt.init_state(first)
    state["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
        float(np.mean(first["teacher_do"])), jnp.float32)
    init = _flat(state["params"])
    step_fn = jt.get_step(K, None)
    rng = jax.random.PRNGKey(1)
    batches, losses = [], []
    for batch, scale in zip(jdata.batches(2, nprng), SCALES):
        batches.append(batch)
        jb = jt._device_batch(batch, nprng)
        jb["distill_scale"] = jnp.float32(scale)
        rng, sr = jax.random.split(rng)
        state, ld = step_fn(state, jb, sr)
        losses.append({k: float(v) for k, v in ld.items()})
    # fit, reusing the compiled step: from the same init, and from no
    # state (the depth offset at the teacher mean).
    jstate = jt.init_state(first)
    jstate["params"]["model"]["params"]["depth_offset"] = jnp.asarray(
        float(np.mean(first["teacher_do"])), jnp.float32)
    jt.fit(jdata, state=jstate, log_fn=lambda *a: None)
    history = {k: list(v) for k, v in jt.history.items()}
    logs = []
    jt.history = {}
    jt.fit(jdata, log_fn=logs.append)
    return dict(root=root, init=init, batches=batches, losses=losses,
                history=history, logs=logs)


def test_distill_steps_match_jax(run):
    t = _port_trainer(run["root"] / "tstep")
    t._make_optimizer(TOTAL_STEPS)
    state = _port_state(t, run["init"])
    gen = torch.Generator().manual_seed(1)
    for batch, scale, want in zip(run["batches"], SCALES, run["losses"]):
        jb = t.device_batch(batch)
        jb["distill_scale"] = scale
        state, ld = t.train_step(state, jb, K, None, gen)
        assert set(ld) == set(want)
        for k in ("total", "distill"):
            got = float(ld[k])
            assert abs(got - want[k]) <= 1e-5 * abs(want[k]), (k, got,
                                                                want[k])
    assert want["distill"] > 0.01


def test_distill_fit_matches_jax(run):
    t = _port_trainer(run["root"] / "tfit")
    t.fit(tds.ImageDataset(str(run["root"] / "data"), device="cpu", **DS),
          state=_port_state(t, run["init"]), log_fn=lambda *a: None)
    assert len(t.history["distill"]) == 2
    for k in ("total", "distill"):
        for g, w in zip(t.history[k], run["history"][k]):
            assert abs(g - w) <= 1e-4 * abs(w), (k, g, w)


def test_distill_fit_starts_at_teacher_mean(run):
    t = _port_trainer(run["root"] / "tmean", epochs=1)
    logs = []
    state = t.fit(tds.ImageDataset(str(run["root"] / "data"), device="cpu",
                                   **DS), log_fn=logs.append)
    want = [m for m in run["logs"] if m.startswith("distill:")]
    assert want and [m for m in logs if m.startswith("distill:")] == want
    assert np.isfinite(state["params"]["model.depth_offset"].item())


def test_distill_needs_sidecars(run, tmp_path):
    jcorpus.generate_corpus(str(tmp_path), n_images=2, image_size=RES,
                            seed=4)
    t = _port_trainer(tmp_path / "out")
    with pytest.raises(ValueError, match="fit_teacher"):
        t.fit(tds.ImageDataset(str(tmp_path), device="cpu", **DS),
              log_fn=lambda *a: None)
