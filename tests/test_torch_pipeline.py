"""Port parity for the image->3DGS slice as a whole, at a small size.

The JAX chain is composed here from fresnel_tpu modules the way bench.py
composes it (resize, DINOv2, DepthAnything, DirectPatchDecoder K = 4,
render_tiled), at a 56^2 input upsampled to 112^2 (an 8 x 8 patch grid,
256 Gaussians) and a 64^2 render.  The same JAX params go to the port
through fresnel_tpu_torch.weights.

  * positions at atol 1e-4 (the ViTs' 1e-4 bound carried through the
    decoder);
  * the image from JAX's decoder outputs, rendered by both renderers, at
    atol 2e-5;
  * the image from the whole chain at a mean absolute error of 1e-4: a
    1e-6 shift of a position can move a Gaussian across a tile-interval
    floor or the 3-sigma box edge and change a few pixels by much more,
    so the whole-chain image is held on average, not pixel by pixel.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import flatten_dict

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.models.decoders import DirectPatchDecoder as JDecoder
from fresnel_tpu.models.vit import DINOv2 as JDINOv2
from fresnel_tpu.models.vit import DepthAnything as JDepth
from fresnel_tpu.render.tile import render_tiled as j_render

from fresnel_tpu_torch import weights
from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder as TDecoder
from fresnel_tpu_torch.models.vit import DINOv2 as TDINOv2
from fresnel_tpu_torch.models.vit import DepthAnything as TDepth
from fresnel_tpu_torch.pipeline import Models, build_models, image_to_3dgs
from fresnel_tpu_torch.render.tile import render_tiled as t_render
from test_torch_threads import _few_threads  # noqa: F401


IMG = 112
RENDER = 64
TRUNK = dict(width=64, depth=4, heads=2, image_size=IMG)
DA = dict(out_size=32, out_indices=(1, 2, 3, 4), neck_channels=(8, 16, 32, 64),
          fusion=16, head_hidden=8, **TRUNK)
DEC = dict(feature_dim=64, gaussians_per_patch=4, hidden_dims=(64, 32))
KEYS = ("positions", "scales", "rotations", "colors", "opacities")


def _flat(params):
    return {k: np.asarray(v)
            for k, v in flatten_dict(params["params"], sep="/").items()}


@pytest.fixture(scope="module")
def chains():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jdino, jda, jdec = JDINOv2(**TRUNK), JDepth(**DA), JDecoder(**DEC)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    x0 = jnp.zeros((1, IMG, IMG, 3))
    dp = jax.jit(jdino.init)(k1, x0)
    ap = jax.jit(jda.init)(k2, x0)
    cp = jdec.init(k3, jdino.apply(dp, x0), jda.apply(ap, x0))
    camera = JCamera.default_training(RENDER)

    @jax.jit
    def j_chain(image):
        x = jax.image.resize(image, (IMG, IMG, 3), "linear")[None]
        out = jdec.apply(cp, jdino.apply(dp, x), jda.apply(ap, x))
        img = j_render(out["positions"][0], out["scales"][0],
                       out["rotations"][0], out["colors"][0],
                       out["opacities"][0], camera)
        return out, img

    tdino, tda, tdec = TDINOv2(**TRUNK), TDepth(**DA), TDecoder(**DEC)
    tdino.load_state_dict(weights.dinov2_state_dict(_flat(dp)), strict=True)
    tda.load_state_dict(weights.depth_anything_state_dict(_flat(ap)),
                        strict=True)
    tdec.load_state_dict(weights.decoder_state_dict(_flat(cp)), strict=True)
    models = Models(dino=tdino.eval(), depth=tda.eval(), decoder=tdec.eval())
    return j_chain, models


def _image(seed):
    return np.random.default_rng(seed).uniform(size=(56, 56, 3)).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_whole_chain(chains, seed):
    j_chain, models = chains
    image = _image(seed)
    jout, jimg = j_chain(jnp.asarray(image))
    pos, img = image_to_3dgs(models, torch.from_numpy(image),
                             TCamera.default_training(RENDER), device="cpu")
    assert pos.shape == (1, 256, 3) and img.shape == (3, RENDER, RENDER)
    np.testing.assert_allclose(pos.numpy(), np.asarray(jout["positions"]),
                               atol=1e-4)
    err = np.abs(img.numpy() - np.asarray(jimg))
    assert err.mean() <= 1e-4, err.mean()
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_render_of_jax_decoder_outputs(chains):
    j_chain, _ = chains
    jout, jimg = j_chain(jnp.asarray(_image(2)))
    args = [torch.from_numpy(np.array(jout[k][0])) for k in KEYS]
    img = t_render(*args, TCamera.default_training(RENDER))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=2e-5)


def test_build_models_full_width_on_cpu():
    m = build_models(seed=0, device="cpu", dtype=torch.float32)
    assert sum(p.numel() for p in m.dino.parameters()) == 22_056_192
    assert m.decoder.gaussians_per_patch == 4
    assert m.dino.image_size == 518 and m.depth.out_size == 256
    m2 = build_models(seed=0, device="cpu", dtype=torch.float32)
    assert torch.equal(m.decoder.mlp.layers[0].weight,
                       m2.decoder.mlp.layers[0].weight)
