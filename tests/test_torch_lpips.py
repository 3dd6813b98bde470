"""Port parity: the LPIPS distance (losses/lpips.py), its loaders, and
the decoder Trainer with the LPIPS term, against the JAX package on the
CPU, float32.

* The distance from JAX's `random_lpips(seed)` params carried across by
  `weights.lpips_state_dict`, at 64^2 and 128^2, batch 2: within 1e-5
  relative (measured 4.1e-7); its gradient with respect to both images
  within 1e-5 of the gradient's largest entry (measured 2.6e-6).
* `load_lpips` on lpips-alex checkpoints written at the published shapes
  (`models.backbone_files.lpips_checkpoint`) in the lpips package's
  naming, torchvision's, and as an `.npz` of the JAX package's Flax
  names: the same parameters as JAX's `load_lpips` of the same file (a
  negative `lin` entry clamped to 0 on both sides), the same distance;
  a missing path gives None; a missing `lin`, a missing conv, a wrong
  channel count and an `.npz` short of a key raise the JAX package's
  ValueErrors.  The module is float32, frozen, in eval mode, and on the
  card unless the caller asks for the CPU.
* A two-step Trainer run at a tiny flagship-like width (experiment 2, K
  2, ImageEncoder width 8, 32^2 renders, so the term upsamples to 128^2)
  with lpips_weight 0.1, one JAX run shared by the file: `lpips` and
  `total` at each step within 1e-5 relative; the parameters after 2
  steps held by leaf as tests/test_torch_wave_train.py holds them: max at
  most 2 * lr * steps, mean at most 1e-6, but for the leaves of zero
  gradient in exact arithmetic (tests/test_torch_trainer.py).  Not 1e-7:
  Adam moves an entry whose gradient is near its epsilon (1e-8) by
  lr * g / (|g| + eps), so the rounding of such a gradient shows in the
  step.  Measured: the value bias of the second attention block has an
  entry with gradient 1.8e-8 (1.5e-8 in the port; 6e-6 of the leaf's
  largest), which parts by 8.0e-6 after 2 steps, a leaf mean of 1.7e-7;
  the same config without the LPIPS term parts by 4.7e-7 in the same
  leaf.
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
from fresnel_tpu.losses import lpips as jlp
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.losses import lpips as tlp
from fresnel_tpu_torch.models.backbone_files import (
    lpips_checkpoint, save_checkpoint)
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train.harness import Trainer, build_decoder
from fresnel_tpu_torch.weights import lpips_state_dict, trainer_params
from test_torch_threads import _few_threads  # noqa: F401


def _flat(params):
    return {k: np.asarray(v) for k, v in
            flatten_dict(params["params"], sep="/").items()}


def _port(params):
    m = tlp.LPIPS()
    m.load_state_dict(lpips_state_dict(_flat(params)))
    return m.eval().requires_grad_(False)


def _images(size, seed, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (batch, 3, size, size)).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def jax_random():
    return jlp.random_lpips(0)


@pytest.mark.parametrize("size", [64, 128])
def test_distance_and_gradients_match_jax(size, jax_random):
    apply, params = jax_random

    @jax.jit
    def value_and_grads(x, y):
        d, vjp = jax.vjp(lambda x, y: apply(params, x, y), x, y)
        return d, vjp(jnp.ones_like(d))

    a, b = _images(size, size)
    jd, (ga, gb) = value_and_grads(jnp.asarray(a), jnp.asarray(b))
    jd = np.asarray(jd)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    d = _port(params)(ta, tb)
    d.sum().backward()
    assert d.shape == (2,) and d.dtype == torch.float32
    np.testing.assert_allclose(d.detach().numpy(), jd, rtol=1e-5, atol=0)
    for got, want in ((ta.grad, ga), (tb.grad, gb)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def _write(tmp_path, naming, negative_lin=False):
    if naming == "npz":
        pth = _write(tmp_path, "lpips", negative_lin)
        path = tmp_path / "lpips_alex.npz"
        np.savez(path, **jlp.convert_torch_lpips(str(pth)))
        return path
    sd = lpips_checkpoint(naming, seed=3)
    if negative_lin:
        key = next(k for k in sd if re.match(r"^lins?\.?2\.", k))
        sd[key] = sd[key].copy()
        sd[key][0, :5] = -0.5
    path = tmp_path / f"lpips_{naming}.pth"
    save_checkpoint(str(path), sd)
    return path


@pytest.mark.parametrize("naming", ["lpips", "torchvision", "npz"])
def test_load_lpips_matches_jax(naming, tmp_path):
    path = _write(tmp_path, naming, negative_lin=True)
    apply, params = jlp.load_lpips(str(path))
    m = tlp.load_lpips(str(path), device="cpu")
    assert isinstance(m, tlp.LPIPS) and not m.training
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in m.parameters())
    want = lpips_state_dict(_flat(params))
    got = m.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert (m.lin2 >= 0).all() and (m.lin2 == 0).sum() >= 5
    a, b = _images(64, 7)
    jd = np.asarray(apply(params, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        d = m(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=0)
    with torch.no_grad():
        same = m(torch.from_numpy(a), torch.from_numpy(a))
    assert same.abs().max().item() < 1e-6


BROKEN = {
    "missing_lin": (lambda sd: sd.pop("lin3.model.1.weight"), "lin0..lin4"),
    "missing_conv": (lambda sd: [sd.pop("net.slice5.10.weight"),
                                 sd.pop("net.slice5.10.bias")],
                     "5 AlexNet convs"),
    "channels": (lambda sd: sd.update({
        "net.slice3.6.weight": np.zeros((380, 192, 3, 3), np.float32),
        "net.slice3.6.bias": np.zeros(380, np.float32)}),
        "conv2 has 380 channels"),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_load_lpips_raises_as_jax(case, tmp_path):
    edit, match = BROKEN[case]
    sd = lpips_checkpoint("lpips", seed=1)
    edit(sd)
    path = str(tmp_path / "broken.pth")
    save_checkpoint(path, sd)
    with pytest.raises(ValueError, match=match):
        jlp.load_lpips(path)
    with pytest.raises(ValueError, match=match):
        tlp.load_lpips(path, device="cpu")


def test_load_lpips_missing_and_short_npz(tmp_path):
    assert tlp.load_lpips(None, device="cpu") is None
    assert tlp.load_lpips(str(tmp_path / "none.pth"), device="cpu") is None
    assert jlp.load_lpips(str(tmp_path / "none.pth")) is None
    flat = jlp.convert_torch_lpips(str(_write(tmp_path, "lpips")))
    del flat["trunk/conv4/bias"]
    path = str(tmp_path / "short.npz")
    np.savez(path, **flat)
    for load in (jlp.load_lpips,
                 lambda p: tlp.load_lpips(p, device="cpu")):
        with pytest.raises(ValueError, match="strict weight load failed"):
            load(path)


def test_lpips_on_the_card_unless_asked(monkeypatch, tmp_path):
    path = str(_write(tmp_path, "lpips"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tlp.load_lpips(path), lambda: tlp.random_lpips(0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    m = tlp.random_lpips(0, device="cpu")
    assert all(not p.requires_grad for p in m.parameters())
    assert torch.equal(m.lin0, torch.ones(64))
    assert m.trunk.conv0.bias.abs().max().item() == 0.0
    # Fixed filters: the same seed gives the same module.
    again = tlp.random_lpips(0, device="cpu")
    for k, v in m.state_dict().items():
        assert torch.equal(again.state_dict()[k], v)


# --- the decoder Trainer with the LPIPS term ---------------------------

STEPS, K, LR = 2, 2, 2e-4
CFG = dict(experiment=2, epochs=1, batch_size=2, image_size=32,
           feature_size=5, feature_dim=48, encoder_width=8,
           gaussians_per_patch=K, max_per_tile=64, train_encoder=True,
           lr=LR, weight_decay=1e-5, scale_bias=-2.6, opacity_bias=1.5,
           depth_offset_init=-0.128, rgb_weight=1.0, ssim_weight=0.5,
           depth_weight=0.1, boundary_weight=0.0, lpips_weight=0.1,
           save_interval=100, seed=0)
HFGS = dict(use_phase_retrieval_loss=False, use_frequency_loss=False,
            learnable_wavelengths=False)
DS = dict(image_size=32, feature_size=5, feature_dim=48,
          use_augmentation=False)


def _params_flat(params):
    out = {}
    for k, v in params.items():
        for kk, vv in flatten_dict(v, sep="/").items():
            out[f"{k}/{kk}"] = np.array(vv)
    return out


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, jax_random):
    root = tmp_path_factory.mktemp("lpips_trainer")
    jcorpus.generate_corpus(str(root / "data"), n_images=4, image_size=32,
                            seed=5)
    jdata = jds.ImageDataset(str(root / "data"), **DS)
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(root / "j"), **CFG),
                  jconfig.PhysicsConfig(), jconfig.HFGSConfig(**HFGS),
                  jconfig.HFTSConfig(), lpips=jax_random)
    jt.model = jt.model.clone(dropout=0.0)
    jt._make_optimizer(STEPS)
    nprng = np.random.default_rng(0)
    batches = list(jdata.batches(2, nprng))[:STEPS]
    state = jt.init_state(batches[0])
    init = _params_flat(state["params"])
    step_fn = jt.get_step(K, None)
    rng = jax.random.PRNGKey(1)
    jlosses = []
    for batch in batches:
        rng, sr = jax.random.split(rng)
        state, ld = step_fn(state, jt._device_batch(batch, nprng), sr)
        jlosses.append({k: float(v) for k, v in ld.items()})
    jfinal = _params_flat(state["params"])

    t = Trainer(tconfig.TrainingConfig(output_dir=str(root / "t"), **CFG),
                tconfig.PhysicsConfig(), tconfig.HFGSConfig(**HFGS),
                tconfig.HFTSConfig(), lpips=_port(jax_random[1]),
                device="cpu")
    t.model = build_decoder(t.config, t.physics_config, dropout=0.0)
    t._make_optimizer(STEPS)
    params = {k: v.clone() for k, v in trainer_params(init).items()}
    tstate = {"params": params, "opt_state": t.optimizer.init(params),
              "step": torch.zeros((), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(1)
    tlosses = []
    for batch in batches:
        tstate, ld = t.train_step(tstate, t.device_batch(batch), K, None,
                                  gen)
        tlosses.append({k: float(v) for k, v in ld.items()})
    return dict(jlosses=jlosses, jfinal=jfinal, tlosses=tlosses,
                tstate=tstate, trainer=t)


def test_trainer_lpips_losses_match(trainer_runs):
    jl, tl = trainer_runs["jlosses"], trainer_runs["tlosses"]
    assert len(jl) == len(tl) == STEPS
    for want, got in zip(jl, tl):
        assert set(want) == set(got) and "lpips" in got
        for k in ("lpips", "total"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (
                k, got[k], want[k])
        for k, w in want.items():
            assert abs(got[k] - w) <= 1e-4 * max(abs(w), 1e-6), (k, got[k],
                                                                  w)


def test_trainer_lpips_params_after_two_steps(trainer_runs):
    want = trainer_params(trainer_runs["jfinal"])
    got = trainer_runs["tstate"]["params"]
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == {"model", "encoder"}
    zero_grad = re.compile(r"res\.\d\.conv1\.bias|attn\.k\.bias")
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR * STEPS, (k, d.max().item())
        if not zero_grad.search(k):
            assert d.mean().item() <= 1e-6, (k, d.mean().item())
    lp = trainer_runs["trainer"].lpips
    assert all(not p.requires_grad and p.dtype == torch.float32
               for p in lp.parameters())
