"""Port parity: the tuners' objectives on the CPU.

`SelfImprovingTuner._score` (rendered SSIM through `VisualEvaluator`)
and `hyperparam_search.chamfer_score` (the SAAG prior and the matching
loss) with the same state on both sides (a JAX Trainer's init params
carried over), over an `ImageDataset` whose caches the JAX package
wrote: within 1e-5 relative.  (Each trial builds a fresh Trainer, whose
init differs between the packages, so the tuners' trials are not
compared; tests/test_torch_tuners.py runs the port's.)
"""

import numpy as np
from flax.traverse_util import flatten_dict

from fresnel_tpu.data import dataset as jds
from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import auto_tune as jat
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train import hyperparam_search as jhs
from fresnel_tpu.train.harness import Trainer as JTrainer

from fresnel_tpu_torch.data import dataset as tds
from fresnel_tpu_torch.train import auto_tune as tat
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import hyperparam_search as ths
from fresnel_tpu_torch.train.harness import Trainer
from fresnel_tpu_torch.weights import trainer_params
from test_torch_threads import _few_threads  # noqa: F401

CFG = dict(experiment=2, image_size=32, batch_size=2, gaussians_per_patch=1,
           lpips_weight=0.0, feature_size=5, feature_dim=48, seed=0)
DS = dict(image_size=32, feature_size=5, feature_dim=48,
          use_augmentation=False)
SCORE_RTOL = 1e-5


def test_scores_match(tmp_path):
    jcorpus.generate_corpus(str(tmp_path / "c"), n_images=4, image_size=32,
                            seed=5)
    jdata = jds.ImageDataset(str(tmp_path / "c"), **DS)     # writes caches
    tdata = tds.ImageDataset(str(tmp_path / "c"), device="cpu", **DS)
    physics, hfgs, hfts = (jconfig.PhysicsConfig(), jconfig.HFGSConfig(
        use_phase_retrieval_loss=False, use_frequency_loss=False,
        learnable_wavelengths=False), jconfig.HFTSConfig())
    jt = JTrainer(jconfig.TrainingConfig(output_dir=str(tmp_path), **CFG),
                  physics, hfgs, hfts)
    jstate = jt.init_state(next(iter(jdata.batches(
        2, np.random.default_rng(0)))))
    tt = Trainer(tconfig.TrainingConfig(output_dir=str(tmp_path), **CFG),
                 *tat.trial_configs(), device="cpu")
    flat = {f"model/{k}": np.array(v) for k, v in flatten_dict(
        jstate["params"]["model"], sep="/").items()}
    tstate = {"params": trainer_params(flat)}
    assert set(tstate["params"]) == set(tt.init_state()["params"])

    jtuner = jat.SelfImprovingTuner(jconfig.TrainingConfig(**CFG))
    ttuner = tat.SelfImprovingTuner(tconfig.TrainingConfig(**CFG),
                                    device="cpu")
    a = jtuner._score(jt, jstate, jdata)
    b = ttuner._score(tt, tstate, tdata)
    assert abs(a - b) <= SCORE_RTOL * abs(a), (a, b)
    a = jhs.chamfer_score(jt, jstate, jdata)
    b = ths.chamfer_score(tt, tstate, tdata)
    assert abs(a - b) <= SCORE_RTOL * abs(a), (a, b)
