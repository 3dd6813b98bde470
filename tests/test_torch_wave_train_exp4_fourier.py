"""Port parity: `Trainer` steps on experiment 4's Fourier route,
`--experiment 4 --use_phase_blending` (the Fibonacci spiral decoder, 55
points here, through the Fourier renderer's spatial mode: K5 / K6 on the
card), against the JAX package's, on the CPU at 48^2
(tests/test_torch_wave_train.py states the config and the tolerances)."""

import pytest

from test_torch_threads import _few_threads  # noqa: F401
from test_torch_wave_train import check_parity, run_both

FLAGS = ["--experiment", "4", "--use_phase_blending", "--n_spiral_points",
         "55", "--image_size", "48"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("exp4_fourier"), FLAGS, 48)


def test_exp4_fourier_route_matches_jax(run):
    assert type(run["trainer"].renderer).__name__ == "FourierRenderer"
    assert "overflow_dropped_frac" not in run["tlosses"][0]
    check_parity(run)
