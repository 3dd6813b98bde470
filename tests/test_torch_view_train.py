"""Port parity: view-aware training from `results/v2combo_model.msgpack`
(thin params, `view_weight` 0.5, `z_offset_scale` 0.2, `depth_z_scale` 2)
on a 2-scene corpus_v2 at 64^2, 2 steps against the JAX package's
Trainer on the CPU; the case, its bounds and the measured values are set
out in tests/test_torch_resume_view.py, whose helpers it shares.  Also:
`device_batch` refuses GT views without the batches' generator."""

import numpy as np
import jax.numpy as jnp
import pytest

from fresnel_tpu.data import raytrace_corpus as jrc

from test_torch_resume_view import (
    SIZE, STEPS, _check_losses, _check_state, _run)
from test_torch_threads import _few_threads  # noqa: F401


@pytest.fixture(scope="module")
def view(tmp_path_factory):
    root = tmp_path_factory.mktemp("view")
    jrc.generate_corpus(str(root / "data"), n_images=2, image_size=SIZE,
                        seed=21)
    return _run("v2combo", str(root / "data"), root / "out")


def test_view_losses_match_jax(view):
    _check_losses(view)
    assert view["tl"][0]["view"] > 0
    assert "view_overflow_dropped_frac" in view["tl"][0]


def test_view_draws_match_jax(view):
    assert len(view["drawn"]) == STEPS
    for jgt, tgt, jaz, taz in view["drawn"]:
        assert jgt.tobytes() == tgt.tobytes()
        np.testing.assert_array_equal(
            np.asarray(jnp.radians(jnp.asarray(jaz))), taz)
        assert np.all(jaz != 0.0)


def test_view_state_matches_jax(view):
    _check_state(view, 0)
    assert view["t"].config.z_offset_scale == 0.2


def test_device_batch_needs_the_generator(view):
    batch = {"image": np.zeros((1, 3, 8, 8), np.float32),
             "views": np.zeros((1, 8, 3, 8, 8), np.float32),
             "view_azimuths_deg": np.arange(8, dtype=np.float32) * 45}
    with pytest.raises(ValueError, match="nprng"):
        view["t"].device_batch(batch)
