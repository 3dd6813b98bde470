"""Port parity: DINOv2 and Depth-Anything weights from a local path, on
the CPU, against the JAX package.

The files are random state dicts in the published layouts
(`models/backbone_files.py`: HF-transformers naming, facebook-research
naming with its fused qkv, Depth-Anything-V2's HF naming), written as
`.pth` and `.safetensors`; their names and shapes are held against the
`transformers` modules where that package is installed.

* Converters: the port's flat dicts equal `convert_dinov2_torch` /
  `convert_depth_anything_torch`'s key for key and bit for bit, in both
  namings and both formats (the pos_embed of a 16^2 grid resized to 37^2
  by the same float64 bicubic matrix).  `strip_prefix` and
  `checkpoint_out_indices` as the JAX package's.
* The safetensors reader: F32 and F16 bit for bit against
  `safetensors.numpy`, BF16 against an `ml_dtypes` upcast; F64; other
  dtypes and malformed files raise.  The port's writer reads back with
  `safetensors.numpy`.
* Forwards at narrow trunks (width 64, heads 2; depth 2 for DINOv2 at
  grid 8, depth 12 for Depth-Anything, whose taps are (3, 6, 9, 12), at
  518^2): float32 within 1e-4 of the largest JAX value; bf16 no further
  from JAX's bf16 than twice JAX's own bf16-against-float32 gap at the
  same input (the rounding of each layer differs between XLA and torch,
  so the gaps are of one size, not equal).
* The fused trunk against the separate route in the port (float32 within
  1e-5 of the largest value) and against JAX's FusedDinoDepthEncoder.
* The factories find and load both files, and the training dataset's
  caches come from the found backbones.  `cli infer` at full width is
  held by tests/test_torch_backbone_infer.py.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fresnel_tpu.models.encoders as je
import fresnel_tpu.models.vit as jv

import fresnel_tpu_torch.models.encoders as te
import fresnel_tpu_torch.models.vit as tv
from fresnel_tpu_torch.models import backbone_files as bf
from fresnel_tpu_torch.train.safetensors_file import (
    read_safetensors, write_safetensors)
from test_torch_threads import _few_threads  # noqa: F401

TINY = dict(width=64, depth=2, heads=2)
TINY_DA = dict(width=64, depth=12, heads=2)
F32_TOL, FUSED_TOL = 1e-4, 1e-5


def _image(seed, size=96):
    return np.random.default_rng(seed).uniform(
        size=(size, size, 3)).astype(np.float32)


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def tiny(monkeypatch):
    """A "tiny" ViT config and a 64-wide DINOv2 size in both packages."""
    for mod in (jv, tv):
        monkeypatch.setitem(mod.VIT_CONFIGS, "tiny", TINY)
        monkeypatch.setitem(mod.VIT_CONFIGS, "tiny_da", TINY_DA)
    for mod in (je, te):
        monkeypatch.setitem(mod._DIM_TO_SIZE, 64, "tiny")


# ----------------------------------------------------------------------
# Names against transformers, converters, reader
# ----------------------------------------------------------------------

def test_layouts_match_transformers():
    pytest.importorskip("transformers")
    os.environ.setdefault("USE_TF", "0")
    from transformers import (DepthAnythingConfig,
                              DepthAnythingForDepthEstimation, Dinov2Config,
                              Dinov2Model)
    kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
              mlp_ratio=4, image_size=224, patch_size=14)
    hf = {k: tuple(v.shape) for k, v in
          Dinov2Model(Dinov2Config(**kw)).state_dict().items()}
    ours = bf.dinov2_checkpoint("hf", grid=16, **TINY)
    assert hf == {k: v.shape for k, v in ours.items()}
    cfg = DepthAnythingConfig(
        backbone_config=dict(model_type="dinov2", out_indices=[1, 2],
                             apply_layernorm=True,
                             reshape_hidden_states=False, **kw),
        reassemble_hidden_size=64, patch_size=14,
        neck_hidden_sizes=list(tv.DA_NECK_CHANNELS),
        fusion_hidden_size=tv.DA_FUSION, head_hidden_size=tv.DA_HEAD_HIDDEN,
        depth_estimation_type="relative")
    da = {k: tuple(v.shape) for k, v in DepthAnythingForDepthEstimation(
        cfg).state_dict().items()}
    ours = bf.depth_anything_checkpoint(grid=16, **TINY)
    assert da == {k: v.shape for k, v in ours.items()}


def _with_tiny(fn, *a, **k):
    backup = dict(jv.VIT_CONFIGS), dict(tv.VIT_CONFIGS)
    jv.VIT_CONFIGS.update(tiny=TINY)
    tv.VIT_CONFIGS.update(tiny=TINY)
    try:
        return fn(*a, **k)
    finally:
        for mod, b in zip((jv, tv), backup):
            mod.VIT_CONFIGS.clear()
            mod.VIT_CONFIGS.update(b)


def _bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("naming,suffix,prefix", [
    ("hf", ".pth", ""), ("hf", ".safetensors", ""),
    ("facebook", ".pth", ""), ("facebook", ".safetensors", "module."),
    ("hf", ".pth", "dinov2.")])
def test_dinov2_converter_matches_jax(tmp_path, naming, suffix, prefix):
    path = str(tmp_path / f"d{suffix}")
    bf.save_checkpoint(path, bf.dinov2_checkpoint(naming, grid=16,
                                                   prefix=prefix, **TINY))
    got = _with_tiny(tv.convert_dinov2_torch, path, "tiny", image_size=518)
    want = _with_tiny(jv.convert_dinov2_torch, path, "tiny", image_size=518)
    _bitwise(got, want)
    assert got["pos_embed"].shape == (1, 37 * 37 + 1, 64)


@pytest.mark.parametrize("suffix", [".pth", ".safetensors"])
def test_depth_anything_converter_matches_jax(tmp_path, suffix):
    path = str(tmp_path / f"da{suffix}")
    bf.save_checkpoint(path, bf.depth_anything_checkpoint(grid=16, **TINY))
    got = _with_tiny(tv.convert_depth_anything_torch, path, "tiny")
    want = _with_tiny(jv.convert_depth_anything_torch, path, "tiny")
    _bitwise(got, want)
    assert not any("fusion_0/res1" in k for k in got)


def test_strip_prefix_and_out_indices_match_jax(tmp_path):
    sd = {"module.a": 1, "module.b": 2}
    assert tv.strip_prefix(sd) == jv._strip_prefix(sd) == {"a": 1, "b": 2}
    mixed = {"module.a": 1, "b": 2}
    assert tv.strip_prefix(mixed) == jv._strip_prefix(mixed) == mixed
    w = tmp_path / "model.pth"
    w.write_bytes(b"")
    cases = [None, {"backbone_config": {"out_indices": [3, 6, 9, 12]}},
             {"backbone_config": {}}, "{not json"]
    for cfg in cases:
        cj = tmp_path / "config.json"
        if cfg is None:
            cj.unlink(missing_ok=True)
        else:
            cj.write_text(cfg if isinstance(cfg, str) else json.dumps(cfg))
        assert tv.checkpoint_out_indices(str(w)) == \
            jv._checkpoint_out_indices(str(w))
    (tmp_path / "config.json").write_text(json.dumps(
        {"backbone_config": {"out_indices": [3, 6, 9, 12]}}))
    assert tv.checkpoint_out_indices(str(w)) == (3, 6, 9, 12)


def test_safetensors_reader_and_writer(tmp_path):
    from safetensors.numpy import load_file, save_file
    import ml_dtypes
    rng = np.random.default_rng(0)
    arrs = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "f16": rng.normal(size=(7,)).astype(np.float16),
            "f64": rng.normal(size=(2, 2, 2)),
            "scalar": np.asarray(1.5, np.float32),
            "empty": np.zeros((0, 4), np.float32)}
    path = str(tmp_path / "a.safetensors")
    save_file(arrs, path, metadata={"format": "pt"})
    got = read_safetensors(path)
    ref = load_file(path)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].numpy().dtype == ref[k].dtype
        assert np.array_equal(got[k].numpy(), ref[k]), k
    bf16 = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)).to(
        torch.bfloat16)
    path2 = str(tmp_path / "b.safetensors")
    write_safetensors(path2, {"w": bf16, "x": torch.from_numpy(arrs["f32"])})
    back = load_file(path2)
    want = back["w"].astype(ml_dtypes.bfloat16).astype(np.float32) \
        if back["w"].dtype != np.float32 else back["w"]
    assert np.array_equal(read_safetensors(path2)["w"].float().numpy(), want)
    assert np.array_equal(back["x"], arrs["f32"])
    save_file({"i": np.arange(3, dtype=np.int32)}, str(tmp_path / "c.st"))
    with pytest.raises(ValueError, match="I32"):
        read_safetensors(str(tmp_path / "c.st"))
    (tmp_path / "d.st").write_bytes(b"\x10\x00")
    with pytest.raises(ValueError):
        read_safetensors(str(tmp_path / "d.st"))


def test_strict_load_and_refusals(tmp_path):
    path = str(tmp_path / "d.pth")
    sd = bf.dinov2_checkpoint("facebook", grid=4, **TINY)
    bf.save_checkpoint(path, sd)
    flat = _with_tiny(tv.convert_dinov2_torch, path, "tiny", image_size=56)
    from fresnel_tpu_torch.weights import dinov2_state_dict
    model = tv.DINOv2(image_size=56, **TINY)
    assert tv.load_state_dict_strict(model, dinov2_state_dict(flat)) == \
        len(flat)
    for mutate, what in (
            (lambda s: s.pop("norm.weight"), "not in checkpoint"),
            (lambda s: s.update(bogus=torch.zeros(3)), "no parameter"),
            (lambda s: s.update(cls_token=torch.zeros(1, 1, 8)),
             "shape mismatches \\(1\\)")):
        state = dinov2_state_dict(flat)
        mutate(state)
        with pytest.raises(ValueError, match=what):
            tv.load_state_dict_strict(model, state)
    # A key no parameter takes, in the file, raises; so does a
    # backbone-only file handed to the Depth-Anything converter.
    bf.save_checkpoint(path, dict(sd, **{"blocks.0.extra.weight":
                                         np.zeros(3, np.float32)}))
    with pytest.raises(ValueError, match="no parameter takes"):
        _with_tiny(tv.convert_dinov2_torch, path, "tiny", image_size=56)
    bf.save_checkpoint(path, sd)
    with pytest.raises(ValueError, match="no DPT neck"):
        _with_tiny(tv.convert_depth_anything_torch, path, "tiny")


def test_loaders_read_config_out_indices(tmp_path, tiny):
    d_path = str(tmp_path / "d.safetensors")
    a_path = str(tmp_path / "da.pth")
    bf.save_checkpoint(d_path, bf.dinov2_checkpoint("hf", grid=4, **TINY))
    bf.save_checkpoint(a_path, bf.depth_anything_checkpoint(grid=4, **TINY))
    assert tv.load_dinov2("tiny", str(tmp_path / "absent.pth")) is None
    assert tv.load_depth_anything("tiny", None) is None
    dino = tv.load_dinov2("tiny", d_path, image_size=56, device="cpu")
    assert not dino.training and dino.width == 64
    # The sidecar's taps win; 2 taps for a 4-level neck fail loudly.
    (tmp_path / "config.json").write_text(json.dumps(
        {"backbone_config": {"out_indices": [1, 2]}}))
    model = tv.load_depth_anything("tiny", a_path, out_size=32,
                                   device="cpu")
    assert model.out_indices == (1, 2)
    with pytest.raises(ValueError, match="expected 4 taps"):
        model(torch.zeros(1, 518, 518, 3))


# ----------------------------------------------------------------------
# Forwards against JAX
# ----------------------------------------------------------------------

def _dino_pair(path, grid, dtype):
    j = je.DINOv2FeatureExtractor(path, grid=grid, dim=64,
                                  compute_dtype=dtype[0])
    t = te.DINOv2FeatureExtractor(path, grid=grid, dim=64,
                                  compute_dtype=dtype[1], device="cpu")
    return j, t


F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


def test_dinov2_extractor_matches_jax(tmp_path, tiny):
    path = str(tmp_path / "dinov2_small.pth")
    bf.save_checkpoint(path, bf.dinov2_checkpoint("hf", grid=16, **TINY))
    img = _image(1)
    out = {}
    for name, dt in (("f32", F32), ("bf16", BF16)):
        j, t = _dino_pair(path, 8, dt)
        out[name] = (np.asarray(j(jnp.asarray(img))), t(img))
    assert out["f32"][1].shape == (8, 8, 64)
    assert out["bf16"][1].dtype == torch.float32
    assert _rel(out["f32"][1], out["f32"][0]) <= F32_TOL
    jax_gap = _rel(out["bf16"][0], out["f32"][0])
    assert 0 < _rel(out["bf16"][1], out["bf16"][0]) <= 2 * jax_gap


def test_depth_estimator_matches_jax(tmp_path, tiny):
    path = str(tmp_path / "depth_anything_v2_small.safetensors")
    bf.save_checkpoint(path, bf.depth_anything_checkpoint(grid=37,
                                                          **TINY_DA))
    img = _image(2)
    out = {}
    for name, dt in (("f32", F32), ("bf16", BF16)):
        j = je.DepthAnythingEstimator(path, size="tiny_da",
                                      compute_dtype=dt[0])
        t = te.DepthAnythingEstimator(path, size="tiny_da",
                                      compute_dtype=dt[1], device="cpu")
        out[name] = (np.asarray(j(jnp.asarray(img), 64)), t(img, 64))
    got32 = out["f32"][1]
    assert got32.shape == (64, 64) and 0.0 <= got32.min() <= got32.max() \
        <= 1.0
    assert _rel(got32, out["f32"][0]) <= F32_TOL
    jax_gap = _rel(out["bf16"][0], out["f32"][0])
    assert _rel(out["bf16"][1], out["bf16"][0]) <= 2 * jax_gap


# ----------------------------------------------------------------------
# Fused trunk, factories, cli infer
# ----------------------------------------------------------------------

@pytest.fixture
def models_dir(tmp_path, monkeypatch, tiny):
    """Both files found under FRESNEL_TPU_MODELS, at the narrow trunk
    (DINOv2 at depth 12 too, so the two trunks fuse), registered as the
    "small" size of both packages (a 64-wide extractor under dim 384)."""
    for mod in (jv, tv):
        monkeypatch.setitem(mod.VIT_CONFIGS, "small", TINY_DA)
    for mod in (je, te):
        monkeypatch.setitem(mod._DIM_TO_SIZE, 384, "small")
    d = tmp_path / "models"
    d.mkdir()
    bf.save_checkpoint(str(d / "dinov2_small.safetensors"),
                       bf.dinov2_checkpoint("hf", grid=16, seed=4,
                                            **TINY_DA))
    bf.save_checkpoint(str(d / "depth_anything_v2_small.pth"),
                       bf.depth_anything_checkpoint(grid=37, seed=5,
                                                    **TINY_DA))
    monkeypatch.setenv("FRESNEL_TPU_MODELS", str(d))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    return d


def test_factories_find_and_load(models_dir):
    ext = te.create_feature_extractor("auto", dim=384, device="cpu",
                                      compute_dtype=torch.float32)
    est = te.create_depth_estimator("depth_anything", device="cpu",
                                    compute_dtype=torch.float32)
    assert ext.kind == "dinov2" and ext.weights_path.endswith(
        "dinov2_small.safetensors")
    assert est.kind == "depth_anything" and est.weights_path.endswith(
        "depth_anything_v2_small.pth")
    img = _image(6)
    assert ext(img).shape == (37, 37, 64)
    assert est(img, 32).shape == (32, 32)
    assert te.create_depth_estimator("gradient").kind == "gradient"
    assert te.create_feature_extractor("patch").kind == "patch"
    # Mismatched dtypes: no fused encoder; matching: one.
    est16 = te.create_depth_estimator(device="cpu")
    assert est16.model.backbone.dtype == torch.bfloat16
    assert te.create_fused_encoder(ext, est16) is None
    assert te.create_fused_encoder(ext, est) is not None
    assert te.create_fused_encoder(ext, te.FallbackDepthEstimator(
        "gradient")) is None


def test_fused_matches_separate_and_jax(models_dir):
    img = _image(7)
    ext = te.create_feature_extractor(device="cpu",
                                      compute_dtype=torch.float32)
    est = te.create_depth_estimator(device="cpu",
                                    compute_dtype=torch.float32)
    fused = te.create_fused_encoder(ext, est)
    f, d = fused(img, 64)
    assert _rel(f, ext(img)) <= FUSED_TOL
    assert _rel(d, est(img, 64)) <= FUSED_TOL
    jf = je.create_fused_encoder(
        je.DINOv2FeatureExtractor(ext.weights_path,
                                  compute_dtype=jnp.float32),
        je.DepthAnythingEstimator(est.weights_path,
                                  compute_dtype=jnp.float32))
    jfeat, jdepth = jf(jnp.asarray(img), 64)
    assert _rel(f, jfeat) <= F32_TOL and _rel(d, jdepth) <= F32_TOL


def test_dataset_caches_use_the_found_backbones(models_dir):
    from fresnel_tpu_torch.data.dataset import ImageDataset
    from PIL import Image

    data = models_dir.parent / "data"
    data.mkdir()
    Image.fromarray((_image(9, 64) * 255).astype(np.uint8)).save(
        data / "a.png")
    ds = ImageDataset(str(data), image_size=64, feature_dim=384,
                      device="cpu")
    s = ds._samples[0]
    assert ds._extractor.kind == "dinov2"
    assert ds._depth_estimator.kind == "depth_anything"
    np.testing.assert_array_equal(
        s.features, ds._extractor(torch.from_numpy(s.image)).numpy())
    assert s.depth.shape == (256, 256)
