"""Self-improving hyperparameter tuning.

Counterpart of fresnel_tpu/train/auto_tune.py, the reference's two tuners:
  * SelfImprovingTuner: the v2 tuner (reference:
    scripts/training/auto_tune_v2.py:53-606): short training trials on the
    port's `Trainer` (on the card unless `device="cpu"`), scored by
    rendered SSIM (`VisualEvaluator`), warm-started from the best prior
    state, with successive-halving rungs and a TPE sampler (Optuna is not
    available offline); `study.json` and `best_tuned.pt` in the output
    directory.  VLM score blending needs utils/vlm_guidance.py, which is
    not ported: `use_vlm_scoring` raises NotImplementedError.
  * heuristic_tune: the legacy analyze-and-adjust loop (reference:
    scripts/training/auto_tune_legacy.py:168-243).
The search space, the Halton sweep and the sampler are a numpy copy of
the JAX package's, drawing from `default_rng(seed)` in the same order, so
they suggest the same parameters.

Run:  python -m fresnel_tpu_torch.train.auto_tune --synthetic --trials 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from fresnel_tpu_torch.device import resolve_device

SEARCH_SPACE: Dict[str, Tuple[float, float, bool]] = {
    # name: (low, high, log_scale)
    "lr": (1e-5, 1e-3, True),
    "ssim_weight": (0.1, 1.0, False),
    "depth_weight": (0.0, 0.3, False),
    "boundary_weight": (0.0, 0.3, False),
    "edge_scale_factor": (0.2, 0.8, False),
    "phase_amplitude": (0.1, 0.4, False),
}

VLM_NOT_PORTED = ("VLM scoring needs utils/vlm_guidance.py (an LM Studio "
                  "endpoint), which is not ported (ROADMAP.md, Not queued)")


def _halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def sample_params(trial: int) -> Dict[str, float]:
    """Quasi-random (Halton) sample of the search space: deterministic,
    well-spread coverage; the TPE startup trials."""
    primes = [2, 3, 5, 7, 11, 13]
    out = {}
    for (name, (lo, hi, log)), p in zip(SEARCH_SPACE.items(), primes):
        u = _halton(trial + 1, p)
        if log:
            out[name] = float(math.exp(
                math.log(lo) + u * (math.log(hi) - math.log(lo))))
        else:
            out[name] = float(lo + u * (hi - lo))
    return out


def _to_unit(name: str, x: float) -> float:
    lo, hi, log = SEARCH_SPACE[name]
    if log:
        return (math.log(x) - math.log(lo)) / (math.log(hi) - math.log(lo))
    return (x - lo) / (hi - lo)


def _from_unit(name: str, u: float) -> float:
    lo, hi, log = SEARCH_SPACE[name]
    u = min(max(u, 0.0), 1.0)
    if log:
        return float(math.exp(
            math.log(lo) + u * (math.log(hi) - math.log(lo))))
    return float(lo + u * (hi - lo))


class TPESampler:
    """Univariate Tree-structured Parzen Estimator (Bergstra et al. 2011),
    the sampler family of Optuna's default TPESampler, which the
    reference's tuner uses.

    For each parameter independently (in unit / log space): past trials
    are split at the `gamma` score quantile into good and bad sets, each
    a Parzen mixture of Gaussians (bandwidth by Scott's rule with a
    floor); `n_ei` candidates are drawn from the good mixture and the one
    maximizing l(x) / g(x) is chosen.  The first `n_startup` suggestions
    are the Halton sweep."""

    def __init__(self, n_startup: int = 4, gamma: float = 0.25,
                 n_ei: int = 24, seed: int = 0):
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_ei = n_ei
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def _mixture_logpdf(x: np.ndarray, mus: np.ndarray,
                        sigma: float) -> np.ndarray:
        # (candidates, components) log-density of an equal-weight
        # Gaussian mixture, reduced over components.
        d = (x[:, None] - mus[None, :]) / sigma
        comp = -0.5 * d * d - math.log(sigma * math.sqrt(2 * math.pi))
        m = comp.max(axis=1)
        return m + np.log(np.exp(comp - m[:, None]).mean(axis=1))

    def suggest(self, observations: List[Tuple[Dict[str, float], float]]
                ) -> Dict[str, float]:
        """Next parameter set given [(params, score), ...] (higher score
        is better)."""
        if len(observations) < self.n_startup:
            return sample_params(len(observations))
        ranked = sorted(observations, key=lambda o: -o[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        good, bad = ranked[:n_good], ranked[n_good:] or ranked[-1:]
        out = {}
        for name in SEARCH_SPACE:
            gm = np.array([_to_unit(name, p[0][name]) for p in good])
            bm = np.array([_to_unit(name, p[0][name]) for p in bad])
            # Scott's rule bandwidth with a floor so tight clusters keep
            # exploring; unit space throughout.
            gs = max(float(np.std(gm)) * len(gm) ** -0.2, 0.08)
            bs = max(float(np.std(bm)) * len(bm) ** -0.2, 0.08)
            cand = self.rng.normal(
                gm[self.rng.integers(0, len(gm), self.n_ei)], gs)
            cand = np.clip(cand, 0.0, 1.0)
            ratio = (self._mixture_logpdf(cand, gm, gs)
                     - self._mixture_logpdf(cand, bm, bs))
            out[name] = _from_unit(name, float(cand[int(ratio.argmax())]))
        return out


def trial_configs():
    """The tuners' physics / HFGS / HFTS configs: the defaults with the
    phase-retrieval and frequency losses and learnable wavelengths off."""
    from fresnel_tpu_torch.train.config import (
        HFGSConfig, HFTSConfig, PhysicsConfig)

    return (PhysicsConfig(),
            HFGSConfig(use_phase_retrieval_loss=False,
                       use_frequency_loss=False, learnable_wavelengths=False),
            HFTSConfig())


class SelfImprovingTuner:
    def __init__(self, base_config, physics_config=None, hfgs_config=None,
                 hfts_config=None, output_dir: str = "autotune",
                 trial_epochs: int = 2, rungs: int = 2,
                 use_vlm_scoring: bool = False, device=None):
        if use_vlm_scoring:
            raise NotImplementedError(VLM_NOT_PORTED)
        physics, hfgs, hfts = trial_configs()
        self.base_config = base_config
        self.physics_config = physics_config or physics
        self.hfgs_config = hfgs_config or hfgs
        self.hfts_config = hfts_config or hfts
        self.output_dir = Path(output_dir)
        self.trial_epochs = trial_epochs
        self.rungs = rungs
        self.device = resolve_device(device)
        self.study: List[Dict[str, Any]] = []
        self.best_state = None
        self.best_score = -float("inf")

    def _score(self, trainer, state, dataset) -> float:
        """Rendered-SSIM objective over the dataset's first four frontal
        views (the decoder in inference mode)."""
        from fresnel_tpu_torch.evaluation.visual_eval import VisualEvaluator

        ev = VisualEvaluator(render_size=self.base_config.image_size)
        ev.camera = ev.camera.to(trainer.device)
        rng = np.random.default_rng(0)
        scores = []
        for batch in dataset.batches(1, rng, shuffle=False):
            out = trainer.decode(state["params"], batch["features"],
                                 batch["depth"])
            g = {k: v[0] for k, v in out.items()
                 if k in ("positions", "scales", "rotations", "colors",
                          "opacities")}
            scores.append(ev.evaluate(g, batch["image"][0])["ssim"])
            if len(scores) >= 4:
                break
        return float(np.mean(scores))

    def run(self, dataset, n_trials: int = 8) -> Dict[str, Any]:
        from fresnel_tpu_torch.train.harness import Trainer

        self.output_dir.mkdir(parents=True, exist_ok=True)
        # Rung 0 is sampled sequentially by TPE (Halton startup), so each
        # trial conditions on every score so far; later rungs promote
        # survivors (successive halving).
        sampler = TPESampler(n_startup=max(2, (n_trials + 1) // 2))
        candidates: List = []
        epochs = self.trial_epochs
        state_of: Dict[int, Any] = {}

        for rung in range(self.rungs):
            if rung == 0:
                candidates = [None] * n_trials        # filled by TPE below
            results = []
            for ti, params in enumerate(candidates):
                if params is None:
                    params = sampler.suggest(
                        [(s["params"], s["score"]) for s in self.study])
                cfg = dataclasses.replace(
                    self.base_config,
                    lr=params["lr"],
                    ssim_weight=params["ssim_weight"],
                    depth_weight=params["depth_weight"],
                    boundary_weight=params["boundary_weight"],
                    edge_scale_factor=params["edge_scale_factor"],
                    phase_amplitude=params["phase_amplitude"],
                    output_dir=str(self.output_dir / f"trial_{rung}_{ti}"),
                    epochs=epochs, save_interval=10_000)
                trainer = Trainer(cfg, self.physics_config, self.hfgs_config,
                                  self.hfts_config, device=self.device)
                # Warm start from the survivor's state (the
                # self-improving part).
                state = trainer.fit(dataset, epochs=epochs,
                                    state=state_of.get(ti),
                                    log_fn=lambda *_: None)
                score = self._score(trainer, state, dataset)
                results.append((score, ti, params, state))
                self.study.append({"rung": rung, "trial": ti,
                                   "params": params, "score": score})
                print(f"rung {rung} trial {ti}: ssim={score:.4f} "
                      f"lr={params['lr']:.2e}")
                if score > self.best_score:
                    self.best_score = score
                    self.best_state = state
                    trainer.save_checkpoint(
                        self.output_dir / "best_tuned.pt", state, epochs)
            # Successive halving: promote the top half with more epochs.
            results.sort(key=lambda r: -r[0])
            keep = max(1, len(results) // 2)
            candidates = [r[2] for r in results[:keep]]
            state_of = {i: r[3] for i, r in enumerate(results[:keep])}
            epochs *= 2
            if len(candidates) == 1:
                break

        best = max(self.study, key=lambda s: s["score"])
        (self.output_dir / "study.json").write_text(json.dumps(
            {"trials": self.study, "best": best}, indent=2))
        print(f"best: ssim={best['score']:.4f} params={best['params']}")
        return best


def heuristic_tune(history: Dict[str, List[float]],
                   config) -> Dict[str, float]:
    """Legacy analyze-and-adjust heuristics (reference:
    auto_tune_legacy.py:168-243): inspect the loss history and nudge
    weights."""
    adjustments: Dict[str, float] = {}
    total = history.get("total", [])
    if len(total) >= 3 and total[-1] > total[-3] * 0.99:
        adjustments["lr"] = config.lr * 0.5          # plateaued -> lower LR
    ssim_hist = history.get("ssim", [])
    if ssim_hist and ssim_hist[-1] > 0.5:
        adjustments["ssim_weight"] = min(config.ssim_weight * 1.5, 1.0)
    depth_hist = history.get("depth", [])
    if depth_hist and depth_hist[-1] > 1.0:
        adjustments["depth_weight"] = min(config.depth_weight * 1.5, 0.5)
    return adjustments


def tuner_setup(args):
    """(base TrainingConfig, dataset, device) of the tuners' CLIs:
    experiment 2, batch 2, K 1, no LPIPS term; four synthetic scenes or
    the cached images of `--data_dir`."""
    from fresnel_tpu_torch.train.config import TrainingConfig

    dev = resolve_device(args.device)
    cfg = TrainingConfig(experiment=2, image_size=args.image_size,
                         batch_size=2, gaussians_per_patch=1,
                         lpips_weight=0.0)
    if args.synthetic:
        from fresnel_tpu_torch.data.dataset import SyntheticGaussianDataset
        dataset = SyntheticGaussianDataset(
            n_samples=4, image_size=args.image_size, device=dev)
    else:
        from fresnel_tpu_torch.data.dataset import ImageDataset
        dataset = ImageDataset(args.data_dir, image_size=args.image_size,
                               device=dev)
    return cfg, dataset, dev


def main(argv=None):
    p = argparse.ArgumentParser(description="Auto-tune decoder training")
    p.add_argument("--data_dir", default="images")
    p.add_argument("--output_dir", default="autotune")
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--trial_epochs", type=int, default=2)
    p.add_argument("--rungs", type=int, default=2)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--use_vlm_scoring", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.use_vlm_scoring:
        raise NotImplementedError(VLM_NOT_PORTED)
    cfg, dataset, dev = tuner_setup(args)
    tuner = SelfImprovingTuner(
        cfg, output_dir=args.output_dir, trial_epochs=args.trial_epochs,
        rungs=args.rungs, device=dev)
    return tuner.run(dataset, n_trials=args.trials)


if __name__ == "__main__":
    main()
