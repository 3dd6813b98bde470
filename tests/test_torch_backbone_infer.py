"""Port parity: `cli infer` with DINOv2 and Depth-Anything weights found
under FRESNEL_TPU_MODELS, at full width, on the CPU, against the JAX
package's `cmd_infer`.

The one full-width case of the backbone tests (module fixture): ViT-S/14
DINOv2 (HF naming, `.safetensors`) and Depth-Anything-V2-Small (`.pth`)
at the published shapes (22.1 M and 24.8 M parameters, random from a
seed: `models/backbone_files.py`), and `infer` of one image by the JAX
package and by the port, on the separate route and with
`--fused_encoder`, in float32 (both packages' backbones built in float32;
the default bf16 is held by tests/test_torch_backbones.py).  Both routes
are held against the JAX package's separate route (its fused one against
its separate one is JAX's own test; the narrow fused trunks of both
packages are held by tests/test_torch_backbones.py).  The decoder is the port's seed-0 init on
both sides.  Each field within 1e-5 of its largest value (measured below
6e-7), rotations within 1e-4 (ROT_TOL says why); the port's two routes
against each other at the same tolerances; the route printed.
"""

import contextlib
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import fresnel_tpu.models.encoders as je
from fresnel_tpu import cli as jcli
from fresnel_tpu.models.decoders import DirectPatchDecoder as JDecoder

import fresnel_tpu_torch.models.encoders as te
from fresnel_tpu_torch import cli
from fresnel_tpu_torch.core import io as gio
from fresnel_tpu_torch.models import backbone_files as bf
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder
from fresnel_tpu_torch.weights import init_flax_like_
from test_torch_threads import _few_threads  # noqa: F401

CLI_TOL = 1e-5
# Rotations come from the head's 6D vectors by Gram-Schmidt, which divides
# by the sine of the angle between them: where the two are nearly
# parallel it multiplies the raw outputs' ~5e-7 differences by ~100
# (measured 6.4e-5 against JAX, 2.5e-5 fused against separate).
ROT_TOL = 1e-4
FIELDS = ("positions", "scales", "rotations", "colors", "opacities")


def _image(seed, size):
    return np.random.default_rng(seed).uniform(
        size=(size, size, 3)).astype(np.float32)


def _cloud_errs(got, want):
    """Each field's max abs difference over its largest value."""
    return {k: float(np.abs(getattr(got, k).numpy() - getattr(want, k).numpy()
                            ).max() / np.abs(getattr(want, k).numpy()).max())
            for k in FIELDS}


def _within(errs):
    return all(e <= (ROT_TOL if k == "rotations" else CLI_TOL)
               for k, e in errs.items())


def _float32_factories(mp):
    """Both packages' factories build float32 backbones."""
    for cls in ("DINOv2FeatureExtractor", "DepthAnythingEstimator"):
        base = getattr(je, cls)
        mp.setattr(je, cls, type(cls, (base,), {
            "__init__": lambda self, *a, _b=base, **k: _b.__init__(
                self, *a, compute_dtype=jnp.float32, **k)}))
    for name in ("create_depth_estimator", "create_feature_extractor"):
        orig = getattr(te, name)
        mp.setattr(cli, name, lambda *a, _o=orig, **k: _o(
            *a, compute_dtype=torch.float32, **k))


def _flax_params(model):
    dense = {f"Dense_{i}": {"kernel": jnp.asarray(l.weight.detach().numpy().T),
                            "bias": jnp.asarray(l.bias.detach().numpy())}
             for i, l in enumerate(model.mlp.layers)}
    return {"params": {"MLP_0": dense, "depth_offset": jnp.asarray(
        model.depth_offset.detach().numpy())}}


@pytest.fixture(scope="module")
def full_width_infer(tmp_path_factory):
    """The one full-width case: ViT-S/14 DINOv2 (HF naming, .safetensors)
    and Depth-Anything-V2-Small (.pth) at the published shapes under
    FRESNEL_TPU_MODELS; `infer` of one image by the JAX package, and by
    the port on the separate route and with --fused_encoder, in float32
    (the decoder from the port's seed-0 init on both sides)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("full_width")
    d = root / "models"
    d.mkdir()
    sds = {"dinov2_small.safetensors": bf.dinov2_checkpoint("hf", seed=4),
           "depth_anything_v2_small.pth":
               bf.depth_anything_checkpoint(seed=5)}
    for name, sd in sds.items():
        bf.save_checkpoint(str(d / name), sd)
    img_path = str(root / "in.png")
    Image.fromarray((_image(8, 200) * 255).astype(np.uint8)).save(img_path)
    model = DirectPatchDecoder(gaussians_per_patch=4)
    init_flax_like_(model, torch.Generator().manual_seed(0))
    seeded = _flax_params(model)
    out = {"n_params": {k: bf.n_params(v) for k, v in sds.items()}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FRESNEL_TPU_MODELS", str(d))
        mp.setenv("HOME", str(root))
        mp.chdir(root)
        _float32_factories(mp)
        mp.setattr(JDecoder, "init", lambda self, *a, **k: seeded)
        j_out = str(root / "j.bin")
        assert jcli.cmd_infer(jcli.build_parser().parse_args(
            ["infer", img_path, j_out])) == 0
        out["jax"] = gio.load_binary(j_out)
        for fused in (False, True):
            t_out = str(root / f"t{fused}.ply")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["infer", img_path, t_out, "--device",
                                 "cpu"] + (["--fused_encoder"] if fused
                                           else [])) == 0
            out[fused] = dict(t=gio.load_ply(t_out), printed=buf.getvalue())
    return out


def test_published_shapes(full_width_infer):
    n = full_width_infer["n_params"]
    assert 22_000_000 < n["dinov2_small.safetensors"] < 22_100_000
    assert 24_700_000 < n["depth_anything_v2_small.pth"] < 24_900_000


@pytest.mark.parametrize("fused", [False, True])
def test_cli_infer_with_found_weights_matches_jax(full_width_infer, fused):
    r = full_width_infer[fused]
    assert "depth estimator: depth_anything (" in r["printed"]
    assert "feature extractor: dinov2 (" in r["printed"]
    assert ("fused dual trunk" in r["printed"]) == fused
    assert ("encoder route: separate" in r["printed"]) != fused
    jc, tc = full_width_infer["jax"], r["t"]
    assert tc.num_gaussians == jc.num_gaussians == 37 * 37 * 4
    errs = _cloud_errs(tc, jc)
    assert _within(errs), errs


def test_fused_and_separate_infer_agree(full_width_infer):
    errs = _cloud_errs(full_width_infer[True]["t"],
                       full_width_infer[False]["t"])
    assert _within(errs), errs
