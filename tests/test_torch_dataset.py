"""Port parity: the training data on the CPU.

* `jax_normal` (numpy threefry-2x32 + XLA's float32 erfinv) against
  `jax.random.normal(PRNGKey(seed), shape)`: within 1e-6 (measured 7.2e-7,
  the erfinv's last bits; the random bits themselves are exact).
* `PatchFeatureExtractor`: within 3e-5 absolute of JAX's on a 256^2 image
  at grid 37, dim 384 (measured 1.5e-5: the linear resizes' sums round
  differently, the weights are JAX's own) and at grid 8, dim 48.
* `ImageDataset` on a 4-scene `synthetic_corpus` at 32^2: with caches that
  the JAX package wrote, the batches of both packages from the same seed
  are equal, colour jitter included (same generator calls in the same
  order): exact.  Caches the port writes: depth exact (the corpus's own),
  features within 3e-5 of JAX's, and the JAX package reads them.
* `SyntheticGaussianDataset`: images within a mean absolute error of
  2e-5 of JAX's (isotropic `test_cloud`s: a cutoff box that ends on a pixel
  column may flip, ROADMAP Queue 3), depth maps and features shaped as
  JAX's; `batches` in the same order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.models.encoders import PatchFeatureExtractor as JPFE

from fresnel_tpu_torch.data import dataset as tds
from fresnel_tpu_torch.models.encoders import (
    PatchFeatureExtractor, create_feature_extractor, jax_normal)
from test_torch_threads import _few_threads  # noqa: F401


FEAT_TOL = 3e-5


@pytest.mark.parametrize("seed,shape", [(0, (82, 384)), (3, (82, 48)),
                                        (1, (3, 1000))])
def test_jax_normal_matches(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    np.testing.assert_allclose(jax_normal(seed, shape), want, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("grid,dim", [(37, 384), (8, 48)])
def test_patch_features_match(grid, dim):
    img = np.random.default_rng(grid).uniform(size=(256, 256, 3)).astype(
        np.float32)
    want = np.asarray(JPFE(grid=grid, dim=dim)(jnp.asarray(img)))
    got = PatchFeatureExtractor(grid=grid, dim=dim)(torch.from_numpy(img))
    assert got.shape == want.shape == (grid, grid, dim)
    assert np.abs(got.numpy() - want).max() <= FEAT_TOL


def test_feature_extractor_factory(monkeypatch, tmp_path):
    monkeypatch.setenv("FRESNEL_TPU_MODELS", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert create_feature_extractor("auto", grid=4, dim=8).kind == "patch"
    # A found file that does not load raises; it never falls back to the
    # patch extractor.
    (tmp_path / "dinov2_small.pth").write_bytes(b"x")
    with pytest.raises(ValueError, match="DINOv2"):
        create_feature_extractor("auto", dim=384, device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    jcorpus.generate_corpus(str(root / "j"), n_images=4, image_size=32,
                            seed=2)
    jcorpus.generate_corpus(str(root / "t"), n_images=4, image_size=32,
                            seed=2)
    return root


def _batches(ds, seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.extend(ds.batches(2, rng))
    return out


def test_image_dataset_batches_match(corpus):
    kw = dict(image_size=32, feature_size=6, feature_dim=48,
              use_augmentation=True)
    j = jds.ImageDataset(str(corpus / "j"), **kw)       # writes the caches
    t = tds.ImageDataset(str(corpus / "j"), device="cpu", **kw)
    assert len(j) == len(t) == 4
    jb, tb = _batches(j, 5, 3), _batches(t, 5, 3)
    assert len(jb) == len(tb) == 6
    for a, b in zip(jb, tb):
        assert set(a) == set(b) == {"image", "features", "depth"}
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_caches_interchange(corpus):
    kw = dict(image_size=32, feature_size=6, feature_dim=48,
              use_augmentation=False)
    t = tds.ImageDataset(str(corpus / "t"), device="cpu", **kw)  # writes
    j = jds.ImageDataset(str(corpus / "t"), **kw)                # reads
    feats = sorted((corpus / "t").glob("*_dinov2_48.bin"))
    assert len(feats) == 4
    for a, b in zip(j._samples, t._samples):
        assert np.array_equal(a.depth, b.depth)
        assert np.array_equal(a.features, b.features)
        fresh = np.asarray(JPFE(grid=6, dim=48)(jnp.asarray(a.image)))
        assert np.abs(fresh - b.features).max() <= FEAT_TOL


def test_color_jitter_matches():
    img = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    a = jds.color_jitter(np.random.default_rng(1), img)
    b = tds.color_jitter(np.random.default_rng(1), img)
    assert np.array_equal(a, b)


def test_synthetic_dataset_matches():
    kw = dict(n_samples=3, image_size=32, feature_size=4, feature_dim=48,
              n_gaussians=40, seed=1)
    j = jds.SyntheticGaussianDataset(**kw)
    t = tds.SyntheticGaussianDataset(device="cpu", **kw)
    for a, b in zip(j._samples, t._samples):
        assert a.image.shape == b.image.shape == (32, 32, 3)
        assert np.abs(a.image - b.image).mean() <= 2e-5
        assert a.features.shape == b.features.shape == (4, 4, 48)
        assert a.depth.shape == b.depth.shape == (256, 256)
    ja, ta = _batches(j, 3, 1), _batches(t, 3, 1)
    assert [len(x) for x in (ja, ta)] == [1, 1]
    assert np.abs(ja[0]["image"] - ta[0]["image"]).mean() <= 2e-5
