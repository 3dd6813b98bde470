"""Port parity: `train.auto_tune` and `train.hyperparam_search` on the CPU.

* `sample_params`, `_to_unit` / `_from_unit`, a 30-step `TPESampler`
  loop on a known objective (its normal and integer draws) and
  `heuristic_tune`: bit for bit (the objectives:
  tests/test_torch_tuner_scores.py).
* `SelfImprovingTuner.run` and `run_search` on the port's CPU, 2 trials
  of 1 epoch: `study.json` / `results.json` with the JAX files' keys and
  the JAX Halton parameters, `best_tuned.pt` with its sidecar.
  `--use_vlm_scoring` raises NotImplementedError.
"""

import json
import math

import numpy as np
import pytest

from fresnel_tpu.train import auto_tune as jat
from fresnel_tpu.train import config as jconfig

from fresnel_tpu_torch.train import auto_tune as tat
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import hyperparam_search as ths
from test_torch_threads import _few_threads  # noqa: F401


def _objective(p):
    lr_u = (math.log(p["lr"]) - math.log(1e-5)) / math.log(100.0)
    return -(lr_u - 0.5) ** 2 - (p["ssim_weight"] - 0.6) ** 2


def test_sampler_matches():
    for t in range(12):
        assert tat.sample_params(t) == jat.sample_params(t)
    for name, (lo, hi, _) in tat.SEARCH_SPACE.items():
        for u in (-0.1, 0.0, 0.37, 1.0, 1.2):
            assert tat._from_unit(name, u) == jat._from_unit(name, u)
        x = 0.5 * (lo + hi)
        assert tat._to_unit(name, x) == jat._to_unit(name, x)
    js, ts = jat.TPESampler(n_startup=6, seed=3), tat.TPESampler(
        n_startup=6, seed=3)
    jobs, tobs = [], []
    for _ in range(30):
        a, b = js.suggest(jobs), ts.suggest(tobs)
        assert a == b
        jobs.append((a, _objective(a)))
        tobs.append((b, _objective(b)))


@pytest.mark.parametrize("hist", [
    {"total": [1.0, 1.0, 1.0, 1.0], "ssim": [0.6] * 4},
    {"total": [3.0, 2.0, 1.0], "depth": [1.5]},
    {"total": [1.0], "ssim": [0.2], "depth": [0.1]}])
def test_heuristic_tune_matches(hist):
    assert tat.heuristic_tune(hist, tconfig.TrainingConfig()) == \
        jat.heuristic_tune(hist, jconfig.TrainingConfig())


def _params_ok(got, trial):
    assert set(got) == set(tat.SEARCH_SPACE)
    assert got == jat.sample_params(trial)


def test_tuner_runs(tmp_path):
    base = ["--synthetic", "--trials", "2", "--trial_epochs", "1",
            "--image_size", "32", "--device", "cpu"]
    best = tat.main(base + ["--output_dir", str(tmp_path / "at")])
    study = json.loads((tmp_path / "at" / "study.json").read_text())
    assert set(study) == {"trials", "best"} and study["best"] == best
    assert len(study["trials"]) == 2        # one survivor ends the study
    for i, s in enumerate(study["trials"]):
        assert set(s) == {"rung", "trial", "params", "score"}
        assert (s["rung"], s["trial"]) == (0, i) and np.isfinite(s["score"])
        _params_ok(s["params"], i)          # both trials in the startup
    assert (tmp_path / "at" / "best_tuned.pt").exists()
    meta = json.loads((tmp_path / "at" / "best_tuned.pt.json").read_text())
    assert meta["epoch"] == 1 and meta["config"]["image_size"] == 32

    best = ths.main(base + ["--output_dir", str(tmp_path / "hs")])
    res = json.loads((tmp_path / "hs" / "results.json").read_text())
    assert set(res) == {"trials", "best"} and res["best"] == best
    for i, r in enumerate(res["trials"]):
        assert set(r) == {"trial", "params", "chamfer"} and r["trial"] == i
        assert np.isfinite(r["chamfer"])
        _params_ok(r["params"], i)

    with pytest.raises(NotImplementedError, match="vlm_guidance"):
        tat.main(base + ["--use_vlm_scoring"])
