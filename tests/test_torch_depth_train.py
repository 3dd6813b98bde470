"""Port parity: `data.depth_dataset` and `train.train_depth` on the CPU.

* `SyntheticDepthDataset`, `FolderDepthDataset` (over a 4-image
  `synthetic_corpus`, colour jitter on) and `DepthAugmentation` (crop,
  flip, PIL resizes, jitter) from the same seeds: bit for bit.
  `generate_pseudo_labels` with the gradient estimator: the same files,
  within 1e-5 of each map's largest value.  NYUv2 raises
  NotImplementedError naming the network, from the class and from
  `train_depth --dataset nyuv2`.
* `TinyDepthNet` at base 8 on 32^2 images with the JAX net's params
  carried over (`weights.depth_net_state_dict`): the forward within 1e-5
  of the largest output; three Adam steps (optax's `adam`, lr 3e-4) on a
  folder dataset whose 256^2 depth maps are resized to 32^2 (antialiased
  linear): the losses within 1e-5 relative, every leaf within 1e-6 by its
  mean absolute difference (Adam's first steps are about lr * sign(g), so
  an entry with a near-zero gradient may step either way), but the output
  conv's bias: the min-max normalisation removes any constant, so its
  gradient is zero in exact arithmetic and Adam steps on rounding noise
  of either sign; it is held within 2 * lr * steps.
* `main --synthetic` writes `depth_model.pt`, `config.json` and
  `loss_history.json`.
"""

import json
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import depth_dataset as jdd
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import train_depth as jtd

from fresnel_tpu_torch.data import depth_dataset as tdd
from fresnel_tpu_torch.train import train_depth as ttd
from fresnel_tpu_torch.weights import depth_net_state_dict
from test_torch_threads import _few_threads  # noqa: F401

BASE, SIZE, LR, STEPS = 8, 32, 3e-4, 3
ZERO_GRAD = "convs.13.bias"     # the output conv's bias (see above)


@pytest.fixture(autouse=True)
def _no_backbones(monkeypatch, tmp_path):
    monkeypatch.setenv("FRESNEL_TPU_MODELS", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth") / "c"
    jcorpus.generate_corpus(str(root), n_images=4, image_size=48, seed=8)
    return root


def _equal_batches(a_iter, b_iter):
    a, b = list(a_iter), list(b_iter)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def test_datasets_match(corpus):
    j = jdd.SyntheticDepthDataset(n_samples=6, image_size=SIZE, seed=3)
    t = tdd.SyntheticDepthDataset(n_samples=6, image_size=SIZE, seed=3)
    _equal_batches(j.batches(2, np.random.default_rng(1)),
                   t.batches(2, np.random.default_rng(1)))
    j = jdd.FolderDepthDataset(str(corpus), image_size=SIZE, augment=True)
    t = tdd.FolderDepthDataset(str(corpus), image_size=SIZE, augment=True)
    for seed in (0, 5):
        _equal_batches(j.batches(2, np.random.default_rng(seed)),
                       t.batches(2, np.random.default_rng(seed)))


def test_augmentation_matches():
    rng = np.random.default_rng(2)
    rgb = rng.uniform(size=(40, 56, 3)).astype(np.float32)
    depth = rng.uniform(size=(40, 56)).astype(np.float32)
    ja, ta = jdd.DepthAugmentation(size=24), tdd.DepthAugmentation(size=24)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(8):
        for a, b in zip(ja(jr, rgb, depth), ta(tr, rgb, depth)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_pseudo_labels_and_nyuv2(corpus, tmp_path):
    src = tmp_path / "img"
    src.mkdir()
    for p in sorted(corpus.glob("*.png"))[:2]:
        shutil.copy(p, src / p.name)
    assert jdd.generate_pseudo_labels(str(src), str(tmp_path / "j"),
                                      depth_size=64,
                                      estimator="gradient") == 2
    assert tdd.main([str(src), "--out_dir", str(tmp_path / "t"),
                     "--depth_size", "64", "--estimator", "gradient",
                     "--device", "cpu"]) == 2
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        a = np.fromfile(tmp_path / "j" / n, np.float32)
        b = np.fromfile(tmp_path / "t" / n, np.float32)
        assert a.size == b.size == 64 * 64
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    with pytest.raises(NotImplementedError, match="network"):
        tdd.NYUDepthV2Dataset(image_size=SIZE)
    with pytest.raises(NotImplementedError, match="network"):
        ttd.main(["--dataset", "nyuv2", "--device", "cpu"])


def _jax_run(ds):
    model = jtd.build_depth_net(BASE)
    rng = np.random.default_rng(0)
    batches = list(ds.batches(2, rng))[:STEPS]
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(batches[0]["image"]))
    opt = optax.adam(LR)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, batch):
        def loss_fn(pp):
            pred = model.apply(pp, batch["image"])
            target = batch["depth"]
            if target.shape[-1] != pred.shape[-1]:
                target = jax.image.resize(target, pred.shape, "linear")
            return jtd.depth_losses(pred, target)

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    init = params
    pred0 = np.asarray(model.apply(params, jnp.asarray(batches[0]["image"])))
    losses = []
    for b in batches:
        params, opt_state, loss = step(params, opt_state,
                                       jax.tree.map(jnp.asarray, b))
        losses.append(float(loss))
    flat = lambda p: flatten_dict(p["params"], sep="/")  # noqa: E731
    return batches, flat(init), pred0, losses, flat(params)


def test_train_steps_match(corpus):
    ds = jdd.FolderDepthDataset(str(corpus), image_size=SIZE, augment=True)
    batches, init, pred0, jlosses, final = _jax_run(ds)
    assert batches[0]["depth"].shape[-1] == 256       # resized to 32^2

    model = ttd.TinyDepthNet(BASE)
    model.load_state_dict(depth_net_state_dict(init))
    with torch.no_grad():
        pred = model(torch.from_numpy(batches[0]["image"])).numpy()
    assert pred.shape == pred0.shape == (2, SIZE, SIZE)
    assert np.abs(pred - pred0).max() <= 1e-5 * np.abs(pred0).max()

    opt = ttd.make_optimizer(model, LR)
    losses = [float(ttd.train_step(model, opt,
                                   torch.from_numpy(b["image"]),
                                   torch.from_numpy(b["depth"]))[0])
              for b in batches]
    assert np.allclose(losses, jlosses, rtol=1e-5, atol=0), (losses, jlosses)
    want = depth_net_state_dict(final)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        bound = 2 * LR * STEPS if k == ZERO_GRAD else 1e-6
        assert (got[k] - v).abs().mean().item() <= bound, k


def test_main_writes_outputs(tmp_path):
    model, hist = ttd.main(["--synthetic", "--epochs", "2", "--image_size",
                            str(SIZE), "--base_channels", str(BASE),
                            "--batch_size", "16", "--device", "cpu",
                            "--output_dir", str(tmp_path / "o")])
    names = sorted(p.name for p in (tmp_path / "o").iterdir())
    assert names == ["config.json", "depth_model.pt", "loss_history.json"]
    assert len(hist["total"]) == 2 and np.all(np.isfinite(hist["total"]))
    assert json.loads((tmp_path / "o" / "loss_history.json").read_text()) \
        == hist
    cfg = json.loads((tmp_path / "o" / "config.json").read_text())
    assert cfg["base_channels"] == BASE and cfg["image_size"] == SIZE
    sd = torch.load(str(tmp_path / "o" / "depth_model.pt"),
                    weights_only=True)
    assert set(sd) == set(model.state_dict())
