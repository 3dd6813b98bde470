"""Port parity: `data.preprocess` and `data.streaming` on the CPU.

* `preprocess_dataset` on 3 `synthetic_corpus` images at its defaults
  (518^2, the patch extractor and the gradient estimator: no weights
  under $FRESNEL_TPU_MODELS): the same cache files at the same byte
  sizes as the JAX package's, features and depth within 1e-5 of each
  cache's largest value; a second run writes nothing; `--vlm_density`
  raises NotImplementedError.
* `StreamingImageDataset` over caches the JAX package wrote (32^2, grid
  6, dim 48): the batches of two epochs equal bit for bit the JAX class's
  synchronous batches (`prefetch=False`, its `_load_sync`) for the same
  seed, with colour jitter on and off, through the prefetch thread and
  without it; `vlm_density` only when every sample has one.  A depth cache of the wrong size is recomputed at 256^2
  with a warning.  An error raised in the prefetch thread reaches the
  consumer, and the thread ends, also when the consumer stops early; the
  hand-over holds under a shortened thread switch interval.
"""

import shutil
import sys
import threading

import numpy as np
import pytest

from fresnel_tpu.data import preprocess as jpre
from fresnel_tpu.data import streaming as jstream
from fresnel_tpu.data import synthetic_corpus as jcorpus

from fresnel_tpu_torch.data import preprocess as tpre
from fresnel_tpu_torch.data import streaming as tstream
from test_torch_threads import _few_threads  # noqa: F401

DS = dict(image_size=32, feature_size=6, feature_dim=48)


@pytest.fixture(autouse=True)
def _no_backbones(monkeypatch, tmp_path):
    # No DINOv2 / Depth-Anything files anywhere the factories look.
    monkeypatch.setenv("FRESNEL_TPU_MODELS", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)


def test_preprocess_matches(tmp_path):
    jcorpus.generate_corpus(str(tmp_path / "j"), n_images=3, image_size=48,
                            seed=4)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    assert jpre.preprocess_dataset(str(tmp_path / "j")) == 3
    assert tpre.main([str(tmp_path / "t"), "--device", "cpu"]) == 3
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    bins = [n for n in names if n.endswith(".bin")]
    assert len(bins) == 6
    for n in bins:
        a = np.fromfile(tmp_path / "j" / n, np.float32)
        b = np.fromfile(tmp_path / "t" / n, np.float32)
        assert a.nbytes == b.nbytes == (37 * 37 * 384 * 4 if "dinov2" in n
                                        else 256 * 256 * 4)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max(), n
    assert tpre.preprocess_dataset(str(tmp_path / "t"), device="cpu") == 0
    with pytest.raises(NotImplementedError, match="vlm_guidance"):
        tpre.main([str(tmp_path / "t"), "--vlm_density", "--device", "cpu"])


@pytest.fixture
def caches(tmp_path):
    """A 5-image corpus whose stream caches the JAX package wrote."""
    root = tmp_path / "c"
    jcorpus.generate_corpus(str(root), n_images=5, image_size=32, seed=6)
    jstream.StreamingImageDataset(str(root), prefetch=False, **DS)
    return root


def _epochs(ds, seed, n=2, bs=2):
    rng = np.random.default_rng(seed)
    return [b for _ in range(n) for b in ds.batches(bs, rng)]


@pytest.mark.parametrize("aug", [True, False])
@pytest.mark.parametrize("prefetch", [True, False])
def test_batches_match_jax(caches, aug, prefetch):
    j = jstream.StreamingImageDataset(str(caches), prefetch=False,
                                      use_augmentation=aug, **DS)
    t = tstream.StreamingImageDataset(str(caches), prefetch=prefetch,
                                      use_augmentation=aug, device="cpu",
                                      **DS)
    jb, tb = _epochs(j, 7), _epochs(t, 7)
    assert len(jb) == len(tb) == 4
    for a, b in zip(jb, tb):
        assert set(a) == set(b) == {"image", "features", "depth"}
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("every", [True, False])
def test_vlm_density_only_when_every_sample_has_one(caches, every):
    rng = np.random.default_rng(0)
    pngs = sorted(caches.glob("*.png"))
    for p in pngs[: len(pngs) if every else -1]:
        np.save(caches / f"{p.stem}_vlm_density.npy",
                rng.uniform(size=(4, 4)).astype(np.float32))
    j = jstream.StreamingImageDataset(str(caches), prefetch=False, **DS)
    t = tstream.StreamingImageDataset(str(caches), device="cpu", **DS)
    jb, tb = _epochs(j, 2, n=1, bs=5), _epochs(t, 2, n=1, bs=5)
    assert ("vlm_density" in tb[0]) == every
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_wrong_size_cache_recomputed(caches, capsys):
    depth = sorted(caches.glob("*_depth.bin"))[0]
    want = np.fromfile(depth, np.float32)
    np.zeros((128, 128), np.float32).tofile(depth)
    tstream.StreamingImageDataset(str(caches), device="cpu", **DS)
    assert "unexpected size" in capsys.readouterr().err
    got = np.fromfile(depth, np.float32)
    assert got.size == 256 * 256
    # The corpus's own depth map is not the estimator's; the recomputed
    # one is the estimator's on the 32^2 image, as the JAX class writes.
    np.zeros((128, 128), np.float32).tofile(depth)
    jstream.StreamingImageDataset(str(caches), prefetch=False, **DS)
    jgot = np.fromfile(depth, np.float32)
    assert np.abs(got - jgot).max() <= 1e-5 * np.abs(jgot).max()
    assert not np.array_equal(got, want)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "streaming-prefetch"]


def test_prefetch_error_reaches_consumer(caches, monkeypatch):
    t = tstream.StreamingImageDataset(str(caches), device="cpu", **DS)
    read = t._read
    calls = []

    def flaky(idx):
        calls.append(len(idx))
        if len(calls) == 2:
            raise OSError("disk went away")
        return read(idx)

    monkeypatch.setattr(t, "_read", flaky)
    it = t.batches(2, np.random.default_rng(0))
    assert next(it)["image"].shape == (2, 3, 32, 32)
    with pytest.raises(OSError, match="disk went away"):
        next(it)
    assert not _prefetch_threads()


def test_prefetch_under_fast_switching(caches):
    """The hand-over between the thread and the consumer under a
    shortened switch interval: 5 epochs of batch 1 equal the synchronous
    reads, and no thread is left."""
    kw = dict(device="cpu", use_augmentation=True, **DS)
    sync = tstream.StreamingImageDataset(str(caches), prefetch=False, **kw)
    want = _epochs(sync, 3, n=5, bs=1)
    t = tstream.StreamingImageDataset(str(caches), **kw)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _epochs(t, 3, n=5, bs=1)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == len(want) == 25
    for a, b in zip(want, got):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert not _prefetch_threads()


def test_early_stop_ends_thread(caches):
    t = tstream.StreamingImageDataset(str(caches), device="cpu", **DS)
    first = next(iter(t.batches(1, np.random.default_rng(0))))
    assert first["depth"].shape == (1, 256, 256)
    assert not _prefetch_threads()
