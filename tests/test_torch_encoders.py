"""Port parity: the procedural depth estimators and the resize they use,
against the JAX package on the CPU, and the depth-estimator factory.

Float32 on both sides; the port's Sobel, box blur and linspace round
differently in the last bits: maps within 1e-6 (resize 5e-7).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.models import encoders as je

from fresnel_tpu_torch.models import encoders as te
from test_torch_threads import _few_threads  # noqa: F401


@pytest.mark.parametrize("hw,out", [((96, 80), (64, 64)), ((40, 40), (64, 64)),
                                    ((300, 200), (128, 128)), ((64, 64), (64, 64))])
def test_resize_linear_matches_jax(hw, out):
    x = np.random.default_rng(hw[0]).uniform(size=(2,) + hw).astype(np.float32)
    j = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + out, "linear"))
    t = te.resize_linear(torch.from_numpy(x), *out)
    np.testing.assert_allclose(t.numpy(), j, atol=5e-7)


@pytest.mark.parametrize("k", [5, 7])
def test_box_blur_matches_jax(k):
    x = np.random.default_rng(k).uniform(size=(2, 19, 23)).astype(np.float32)
    np.testing.assert_allclose(te._box_blur(torch.from_numpy(x), k).numpy(),
                               np.asarray(je._box_blur(jnp.asarray(x), k)),
                               atol=1e-6)


@pytest.mark.parametrize("hw,out", [((100, 90), 64), ((64, 64), 64),
                                    ((48, 40), 128)])
def test_depth_estimates_match_jax(hw, out):
    img = np.random.default_rng(out).uniform(size=hw + (3,)).astype(np.float32)
    for jf, tf in ((je.gradient_depth_estimate, te.gradient_depth_estimate),
                   (je.center_depth_estimate, te.center_depth_estimate)):
        j = np.asarray(jf(jnp.asarray(img), out))
        t = tf(torch.from_numpy(img), out)
        assert t.shape == (out, out)
        np.testing.assert_allclose(t.numpy(), j, atol=1e-6)


class TestFactory:
    @pytest.fixture(autouse=True)
    def _no_weights(self, tmp_path, monkeypatch):
        monkeypatch.setenv("FRESNEL_TPU_MODELS", str(tmp_path))
        monkeypatch.setenv("HOME", str(tmp_path))
        monkeypatch.chdir(tmp_path)
        self.models = tmp_path

    def test_auto_without_weights_is_gradient(self):
        est = te.create_depth_estimator("auto")
        assert est.kind == "gradient" and est.weights_path is None
        img = torch.rand(32, 32, 3)
        torch.testing.assert_close(est(img, 32),
                                   te.gradient_depth_estimate(img, 32))

    def test_center_and_unknown(self):
        assert te.create_depth_estimator("center").kind == "center"
        with pytest.raises(ValueError):
            te.create_depth_estimator("midas")

    def test_depth_anything_without_weights_raises(self):
        with pytest.raises(FileNotFoundError):
            te.create_depth_estimator("depth_anything")

    @pytest.mark.parametrize("kind", ["auto", "depth_anything"])
    def test_found_weights_are_not_ported(self, kind):
        """Found weights load (tests/test_torch_backbones.py); a found
        file that is unreadable, or a DINOv2 backbone without the DPT
        neck, raises and never falls back to the gradient estimator."""
        path = self.models / "depth_anything_v2_small.pth"
        path.write_bytes(b"")
        with pytest.raises(ValueError, match="cannot read"):
            te.create_depth_estimator(kind, device="cpu")
        torch.save({"backbone.patch_embed.proj.weight":
                    torch.zeros(384, 3, 14, 14)}, path)
        with pytest.raises(ValueError, match="no DPT neck"):
            te.create_depth_estimator(kind, device="cpu")
