"""Port parity: `Trainer` steps on the QSR route, `--use_qsr` (phase
output with per-RGB phases, the wave-field renderer, the phase-retrieval
loss), against the JAX package's, on the CPU at 48^2
(tests/test_torch_wave_train.py states the config and the tolerances)."""

import pytest

from test_torch_threads import _few_threads  # noqa: F401
from test_torch_wave_train import check_parity, run_both

FLAGS = ["--use_qsr", "--image_size", "48"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("qsr"), FLAGS, 48)


def test_qsr_route_matches_jax(run):
    t = run["trainer"]
    assert type(t.renderer).__name__ == "WaveRenderer"
    assert type(t.model).__name__ == "DirectPatchDecoder"
    assert t.model.use_phase_output
    assert "phase_retrieval" in run["tlosses"][0]
    assert "overflow_dropped_frac" not in run["tlosses"][0]
    check_parity(run)
