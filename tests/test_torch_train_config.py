"""Port parity: the training configs and the synthetic corpus, on the CPU.

* `TrainingConfig`, `PhysicsConfig`, `HFGSConfig`, `HFTSConfig`: equal
  under `dataclasses.asdict` (field names, order, defaults and values), so
  checkpoint sidecars interchange; the HFTS schedule methods equal at
  every input tried; the CLI parsers' flags and `configs_from_args`
  (with the --use_qsr and --surface_init umbrellas) equal.  Exact.
* `synthetic_corpus`: `render_scene` arrays and the files
  `generate_corpus` writes (PNG and depth cache) equal byte for byte.
"""

import dataclasses

import numpy as np
import pytest

from fresnel_tpu.data import synthetic_corpus as jcorpus
from fresnel_tpu.train import config as jconfig
from fresnel_tpu.train import train_gaussian_decoder as jcli

from fresnel_tpu_torch.data import synthetic_corpus as tcorpus
from fresnel_tpu_torch.train import config as tconfig
from fresnel_tpu_torch.train import train_gaussian_decoder as tcli

NAMES = ("TrainingConfig", "PhysicsConfig", "HFGSConfig", "HFTSConfig")


@pytest.mark.parametrize("name", NAMES)
def test_config_fields_and_defaults_match(name):
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


def test_config_values_match():
    kw = dict(experiment=2, batch_size=8, lr=2e-4, image_size=256,
              depth_offset_init=-0.128, gaussians_per_patch=8,
              train_encoder=True, max_per_tile=1024, scale_bias=-2.6,
              opacity_bias=1.5, pose_range_elevation=(-10.0, 20.0))
    assert dataclasses.asdict(jconfig.TrainingConfig(**kw)) == \
        dataclasses.asdict(tconfig.TrainingConfig(**kw))


@pytest.mark.parametrize("kw", [dict(), dict(fast_mode=True),
                                dict(progressive_schedule=True),
                                dict(train_resolution=64, stochastic_k=100)])
def test_hfts_schedule_matches(kw):
    j, t = jconfig.HFTSConfig(**kw), tconfig.HFTSConfig(**kw)
    assert j.get_effective_train_resolution(256) == \
        t.get_effective_train_resolution(256)
    for epoch in range(0, 12):
        for base in (1, 4, 8):
            assert j.get_gaussians_per_patch(epoch, 12, base) == \
                t.get_gaussians_per_patch(epoch, 12, base)
    for n in (10, 256, 300, 10952):
        assert j.get_stochastic_k(n) == t.get_stochastic_k(n)


@pytest.mark.parametrize("argv", [
    [],
    ["--use_qsr", "--surface_init", "--fast_mode", "--epochs", "3"],
    ["--train_encoder", "--gaussians_per_patch", "8", "--max_per_tile",
     "1024", "--lr", "2e-4", "--batch_size", "8", "--surface_init",
     "--depth_offset_init", "-0.128", "--no_augmentation",
     "--lpips_weight", "0"],
])
def test_cli_configs_match(argv):
    ja = jcli.build_parser().parse_args(argv)
    ta = tcli.build_parser().parse_args(argv)
    assert set(vars(ta)) - set(vars(ja)) == {"device"}
    for j, t in zip(jcli.configs_from_args(ja), tcli.configs_from_args(ta)):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("seed", [0, 7, 100003])
def test_render_scene_matches(seed):
    jr, jd = jcorpus.render_scene(seed, 48)
    tr, td = tcorpus.render_scene(seed, 48)
    assert np.array_equal(jr, tr) and np.array_equal(jd, td)


def test_generate_corpus_bytes_match(tmp_path):
    jcorpus.generate_corpus(str(tmp_path / "j"), n_images=3, image_size=32,
                            depth_size=40, seed=1)
    tcorpus.generate_corpus(str(tmp_path / "t"), n_images=3, image_size=32,
                            depth_size=40, seed=1)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 6
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "t" / n).read_bytes()
