"""Port parity: `Trainer` steps on the route of `--use_fourier_renderer
--use_phase_output` (the tiled renderer with phase blending at amplitude
0.3, blending the decoder's phases: K1-phi / K2-phi on the card), against
the JAX package's, on the CPU at 48^2 (tests/test_torch_wave_train.py
states the config and the tolerances)."""

import pytest

from test_torch_threads import _few_threads  # noqa: F401
from test_torch_wave_train import check_parity, run_both

FLAGS = ["--use_fourier_renderer", "--use_phase_output", "--image_size",
         "48"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("fourier_renderer"), FLAGS, 48)


def test_fourier_renderer_route_matches_jax(run):
    cfg = run["trainer"].renderer.config
    assert type(run["trainer"].renderer).__name__ == "TileRenderer"
    assert cfg.use_phase_blending and cfg.phase_amplitude == 0.3
    check_parity(run)
