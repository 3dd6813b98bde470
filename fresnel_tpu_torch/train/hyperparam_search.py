"""Hyperparameter search trial runner.

Counterpart of fresnel_tpu/train/hyperparam_search.py (reference:
scripts/training/hyperparam_search.py:94-141): short training trials on
the port's `Trainer` (on the card unless `--device cpu`) scored by a
Chamfer metric between the decoder's outputs and the SAAG cloud of each
sample's depth (`harness.saag_prior_from_depth`,
`losses.matching.gaussian_matching_loss`); the searched parameters flow
through the config.  Complements `train.auto_tune` (SSIM objective,
successive halving) with the Chamfer objective.  Writes `results.json`.

Run:  python -m fresnel_tpu_torch.train.hyperparam_search --synthetic --trials 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from fresnel_tpu_torch.train.auto_tune import (
    sample_params, trial_configs, tuner_setup)

_FIELDS = ("positions", "scales", "rotations", "colors")


def chamfer_score(trainer, state, dataset) -> float:
    """Negative symmetric Chamfer distance between decoder outputs and the
    SAAG cloud derived from each sample's depth (higher = better), over
    the dataset's first four samples."""
    from fresnel_tpu_torch.losses.matching import gaussian_matching_loss
    from fresnel_tpu_torch.train.harness import saag_prior_from_depth

    rng = np.random.default_rng(0)
    scores = []
    for batch in dataset.batches(1, rng, shuffle=False):
        out = trainer.decode(state["params"], batch["features"],
                             batch["depth"])
        depth = torch.as_tensor(batch["depth"], dtype=torch.float32,
                                device=trainer.device)
        with torch.no_grad():
            saag = saag_prior_from_depth(depth)
            pred = torch.cat([out[k] for k in _FIELDS]
                             + [out["opacities"][..., None]], -1)
            tgt = torch.cat([saag[f"saag_{k}"] for k in _FIELDS]
                            + [saag["saag_opacities"][..., None]], -1)
            ld = gaussian_matching_loss(pred, tgt, max_match_points=1024)
        scores.append(-float(ld["position"] + ld["coverage"]))
        if len(scores) >= 4:
            break
    return float(np.mean(scores))


def run_search(base_config, dataset, n_trials: int = 8,
               trial_epochs: int = 2, output_dir: str = "hyperparam_search",
               device=None):
    from fresnel_tpu_torch.train.harness import Trainer

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    results = []
    for t in range(n_trials):
        params = sample_params(t)
        cfg = dataclasses.replace(
            base_config, lr=params["lr"],
            ssim_weight=params["ssim_weight"],
            depth_weight=params["depth_weight"],
            output_dir=str(out / f"trial_{t}"), epochs=trial_epochs,
            save_interval=10_000)
        trainer = Trainer(cfg, *trial_configs(), device=device)
        state = trainer.fit(dataset, epochs=trial_epochs,
                            log_fn=lambda *_: None)
        score = chamfer_score(trainer, state, dataset)
        results.append({"trial": t, "params": params, "chamfer": score})
        print(f"trial {t}: chamfer={score:.4f} lr={params['lr']:.2e}")
    best = max(results, key=lambda r: r["chamfer"])
    (out / "results.json").write_text(json.dumps(
        {"trials": results, "best": best}, indent=2))
    print(f"best: {best}")
    return best


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", default="images")
    p.add_argument("--output_dir", default="hyperparam_search")
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--trial_epochs", type=int, default=2)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    cfg, dataset, dev = tuner_setup(args)
    return run_search(cfg, dataset, args.trials, args.trial_epochs,
                      args.output_dir, device=dev)


if __name__ == "__main__":
    main()
