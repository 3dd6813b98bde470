"""Port parity: `cli eval` and `evaluation/` (spectrum, visual_eval,
novel_view_eval, compare_decoders) against the JAX package's, on the CPU
(`cli infer` is held in tests/test_torch_infer_cli.py, which shares this
file's helpers).

* `spectrum.band_power_ratio` bit for bit; `compute_ssim` within 1e-5
  (float32 means over the window maps; measured 2.2e-6) and `compute_psnr`
  within 1e-4 dB, 99.0 at a zero error.
* `evaluate_novel_views` on 2 clouds decoded by `results/exp2_model`, at
  render size 64, with and without GT views (given at 128^2, so resized):
  the same keys in the same order; coverage within 2 / 64^2 per view;
  frontal and per-view SSIM within 1e-4, PSNR within 1e-3 dB;
  view_consistency within 1e-3; the spectrum ratios (rounded to 4 places)
  within 2e-4.
* `cli eval --synthetic --max_images 2 --size 64 --save_grid` of exp2
  against JAX's `cmd_eval`, end to end: the patch extractor's features
  differ from JAX's by up to 1.6e-4 (its float32 standardisation), which
  the trained decoder carries into positions (up to 1.4e-4) and 64^2
  renders (mean 4.5e-4).  So the same keys and coverage bound, frontal
  SSIM within 1e-3 and PSNR within 0.05 dB (measured 1.3e-4 and 0.0115),
  spectrum ratios within 2e-4 + 1e-2 of the value (measured 0.32 %); the
  grid PNG of the same size within 8 / 255 per pixel.
* `compare_decoders`: exp2's decoded cloud within 1e-4 of JAX's
  `load_and_decode` (a thin checkpoint's read is held by
  tests/test_torch_trained_ckpt.py), and the grid PNG within 2 / 255 per
  pixel.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from fresnel_tpu import cli as jcli
from fresnel_tpu.evaluation import compare_decoders as jcmp
from fresnel_tpu.evaluation import novel_view_eval as jnve
from fresnel_tpu.evaluation import spectrum as jspec
from fresnel_tpu.evaluation import visual_eval as jve

from fresnel_tpu_torch import cli
from fresnel_tpu_torch.evaluation import compare_decoders as tcmp
from fresnel_tpu_torch.evaluation import novel_view_eval as tnve
from fresnel_tpu_torch.evaluation import spectrum as tspec
from fresnel_tpu_torch.evaluation import visual_eval as tve
from fresnel_tpu_torch.models.encoders import create_feature_extractor
from fresnel_tpu_torch.train.harness import trainer_from_checkpoint
from test_torch_threads import _few_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K8 = os.path.join(ROOT, "results", "exp2_k8_model.msgpack")
EXP2 = os.path.join(ROOT, "results", "exp2_model.msgpack")
FIELDS = ("positions", "scales", "rotations", "colors", "opacities")
S = 64


def _scene(size, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (rng.uniform(1, 3) * x
                                                     + rng.uniform(0, 1)))
                    * np.cos(2 * np.pi * rng.uniform(1, 3) * y)
                    for _ in range(3)], -1)
    for _ in range(3):
        cx, cy, r = rng.uniform(0.25, 0.75, 2).tolist() + [
            rng.uniform(0.05, 0.15)]
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 1, 3)
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def image_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("infer") / "scene.png"
    Image.fromarray((_scene(512, 0) * 255).astype(np.uint8)).save(p)
    return str(p)


def _close_clouds(got, want, atol=1e-4):
    assert got["positions"].shape == want["positions"].shape
    for k in FIELDS:
        np.testing.assert_allclose(got[k], want[k], atol=atol, err_msg=k)


def test_spectrum_bit_for_bit():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(3, 48, 48)).astype(np.float32)
    b = rng.uniform(size=(48, 48, 3)).astype(np.float32)
    for x in (a, b, b[..., 0]):
        je, jp = jspec.radial_power(x, 6)
        te, tp = tspec.radial_power(x, 6)
        assert je.tobytes() == te.tobytes() and jp.tobytes() == tp.tobytes()
    je, jr = jspec.band_power_ratio(a, b)
    te, tr = tspec.band_power_ratio(a, b)
    assert jr.tobytes() == tr.tobytes()
    assert jspec.band_labels(je) == tspec.band_labels(te)


def test_ssim_and_psnr_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(size=(3, 40, 40)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    assert abs(tve.compute_ssim(a, b) - jve.compute_ssim(a, b)) <= 1e-5
    assert abs(tve.compute_ssim(a[None], b[None])
               - jve.compute_ssim(a[None], b[None])) <= 1e-5
    assert abs(tve.compute_psnr(a, b) - jve.compute_psnr(a, b)) <= 1e-4
    assert tve.compute_psnr(a, a) == jve.compute_psnr(a, a) == 99.0


SAME_CLOUDS = dict(ssim=1e-4, psnr=1e-3, spec_rel=0.0)
END_TO_END = dict(ssim=1e-3, psnr=0.05, spec_rel=1e-2)


def _check_results(got, want, S, tol):
    assert list(got) == list(want)
    for k, w in want["per_view_coverage"].items():
        assert abs(got["per_view_coverage"][k] - w) <= 2 / S ** 2, k
    assert abs(got["frontal_ssim"] - want["frontal_ssim"]) <= tol["ssim"]
    assert abs(got["frontal_psnr"] - want["frontal_psnr"]) <= tol["psnr"]
    assert abs(got["view_consistency"] - want["view_consistency"]) <= 1e-3
    assert got["num_samples"] == want["num_samples"]
    assert list(got["spectrum_band_ratio"]) == list(
        want["spectrum_band_ratio"])
    for k, w in want["spectrum_band_ratio"].items():
        assert abs(got["spectrum_band_ratio"][k] - w) <= (
            2e-4 + tol["spec_rel"] * abs(w)), k
    if "per_view_ssim" in want:
        for k, w in want["per_view_ssim"].items():
            assert abs(got["per_view_ssim"][k] - w) <= tol["ssim"], k
            assert abs(got["per_view_psnr"][k]
                       - want["per_view_psnr"][k]) <= tol["psnr"], k
        for k in ("side_view_ssim", "novel_view_ssim"):
            assert abs(got[k] - want[k]) <= tol["ssim"], k


@pytest.fixture(scope="module")
def decoded():
    """Two clouds of exp2 (5 476 Gaussians each) with their targets."""
    t = trainer_from_checkpoint(EXP2, device="cpu")
    state, _ = t.load_checkpoint(EXP2)
    ext = create_feature_extractor("patch")
    out = []
    for seed in (3, 4):
        img = _scene(256, seed)
        feats = ext(torch.from_numpy(img))[None]
        depth = np.random.default_rng(seed).uniform(
            0.3, 0.7, (1, 256, 256)).astype(np.float32)
        g = t.decode(state["params"], feats, depth)
        out.append(({k: g[k][0] for k in FIELDS},
                    img.transpose(2, 0, 1).copy()))
    return out


@pytest.mark.parametrize("with_views", [False, True])
def test_evaluate_novel_views_matches_jax(decoded, with_views):
    t_samples, j_samples = [], []
    for i, (g, target) in enumerate(decoded):
        views = np.stack([_scene(128, 10 * i + v).transpose(2, 0, 1)
                          for v in range(8)])
        ts = {"gaussians": g, "target": target}
        js = {"gaussians": {k: jnp.asarray(v.numpy()) for k, v in g.items()},
              "target": target}
        if with_views:
            ts["views"] = js["views"] = views
        t_samples.append(ts)
        j_samples.append(js)
    want = jnve.evaluate_novel_views(j_samples, render_size=S,
                                     max_per_tile=1024)
    got = tnve.evaluate_novel_views(t_samples, render_size=S,
                                    max_per_tile=1024)
    assert ("per_view_ssim" in got) == with_views
    _check_results(got, want, S, SAME_CLOUDS)


def _png(path):
    return np.asarray(Image.open(path), np.int16)


def test_cli_eval_synthetic_matches_jax(tmp_path):
    jj, tj = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jg, tg = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    common = ["--synthetic", "--max_images", "2", "--size", str(S)]
    assert jcli.cmd_eval(jcli.build_parser().parse_args(
        ["eval", EXP2, "--output_json", jj, "--save_grid", jg]
        + common)) == 0
    assert cli.main(["eval", EXP2, "--output_json", tj, "--save_grid", tg,
                     "--device", "cpu"] + common) == 0
    with open(jj) as f, open(tj) as g:
        want, got = json.load(f), json.load(g)
    assert want["num_samples"] == got["num_samples"] == 2
    _check_results(got, want, S, END_TO_END)
    a, b = _png(tg), _png(jg)
    assert a.shape == b.shape == (2 * S, 2 * S, 3)
    assert np.abs(a - b).max() <= 8


def test_compare_decoders_matches_jax(image_path, tmp_path):
    img = np.asarray(Image.open(image_path).convert("RGB").resize(
        (512, 512)), np.float32) / 255.0
    want = jcmp.load_and_decode(EXP2, jnp.asarray(img))
    got = tcmp.load_and_decode(EXP2, torch.from_numpy(img), "cpu")
    _close_clouds({k: v.numpy() for k, v in got.items()},
                  {k: np.asarray(v) for k, v in want.items()})
    jp, tp = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    jcmp.compare([EXP2], image_path, jp, render_size=S)
    tcmp.main([EXP2, "--image", image_path, "--out", tp, "--size", str(S),
               "--device", "cpu"])
    a, b = _png(tp), _png(jp)
    assert a.shape == b.shape == (S, 4 * S, 3)
    assert np.abs(a - b).max() <= 2
