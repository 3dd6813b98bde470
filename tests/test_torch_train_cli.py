"""The port's training CLI on the CPU (`fresnel_tpu_torch.cli train`, that
is `train.train_gaussian_decoder.main`), one tiny run shared by the file:
--synthetic, 4 scenes at 32^2, feature_size 5, K 2, --train_encoder with
width 8, 2 epochs of 2 steps.

* The checkpoints and their sidecars are written; a sidecar's configs are
  the JAX CLI's `configs_from_args` of the same flags under
  `dataclasses.asdict` (exact), with the JAX sidecar's keys.
* `load_checkpoint` returns the saved params, optimizer state and step
  bit for bit; `--resume` continues at the next epoch.
* `encode` gives (B, grid, grid, feature_dim) features.
* Flags of unported features raise NotImplementedError, and the CLI
  refuses to run without CUDA unless --device cpu is given.
  `--streaming` trains: with --synthetic on the synthetic scenes (which
  take precedence in both packages), with --data_dir over a 2-image
  corpus through the streaming dataset (its `_rgb32.bin` caches).
  `--lpips_weights` with an lpips-alex file trains with the LPIPS term;
  with a path that does not exist it drops the term, as the JAX CLI does.
* `--experiment 4` trains the spiral decoder (one Gaussian per point);
  `--experiment 1`, `3` and `5` train the SAAG refinement, the
  feature-guided SAAG and the NCA decoders (one epoch, finite losses,
  the JAX package's Gaussian counts);
  `--distill_weight` without teacher sidecars (the synthetic dataset has
  none) raises ValueError naming `fit_teacher`.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fresnel_tpu.train import train_gaussian_decoder as jcli

from fresnel_tpu_torch import cli
from fresnel_tpu_torch.data import synthetic_corpus
from fresnel_tpu_torch.models.backbone_files import (
    lpips_checkpoint, save_checkpoint)
from fresnel_tpu_torch.train import train_gaussian_decoder as tcli
from test_torch_threads import _few_threads  # noqa: F401


FLAGS = ["--synthetic", "--synthetic_samples", "4", "--batch_size", "2",
         "--epochs", "2", "--image_size", "32", "--feature_size", "5",
         "--gaussians_per_patch", "2", "--train_encoder", "--encoder_width",
         "8", "--max_per_tile", "64", "--surface_init", "--lpips_weight",
         "0"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    argv = FLAGS + ["--output_dir", str(out), "--device", "cpu"]
    trainer, state = tcli.main(argv)
    return out, argv, trainer, state


def test_writes_checkpoints_and_sidecars(trained):
    out, argv, trainer, _ = trained
    names = sorted(p.name for p in out.iterdir())
    for n in ("best_model.pt", "final_model.pt", "loss_history.json"):
        assert n in names and (not n.endswith(".pt") or n + ".json" in names)
    meta = json.loads((out / "final_model.pt.json").read_text())
    assert set(meta) == {"epoch", "config", "physics_config", "hfgs_config",
                         "hfts_config"}
    assert meta["epoch"] == 1
    want = jcli.configs_from_args(jcli.build_parser().parse_args(
        [a for a in argv if a not in ("--device", "cpu")]))
    for key, cfg in zip(("config", "physics_config", "hfgs_config",
                         "hfts_config"), want):
        assert json.loads(json.dumps(dataclasses.asdict(cfg))) == meta[key]
    hist = json.loads((out / "loss_history.json").read_text())
    assert len(hist["total"]) == 2 and np.all(np.isfinite(hist["total"]))


def test_checkpoint_round_trip(trained):
    out, _, trainer, state = trained
    back, epoch = trainer.load_checkpoint(out / "final_model.pt")
    assert epoch == 1
    assert torch.equal(back["step"], state["step"])
    assert int(state["step"]) == 4
    for k, v in state["params"].items():
        assert torch.equal(back["params"][k], v)
    assert torch.equal(back["opt_state"]["count"],
                       state["opt_state"]["count"])
    for m in ("mu", "nu"):
        for k, v in state["opt_state"][m].items():
            assert torch.equal(back["opt_state"][m][k], v)


def test_resume_and_encode(trained, tmp_path):
    out, argv, _, _ = trained
    argv2 = [a if a != str(out) else str(tmp_path) for a in argv]
    argv2[argv2.index("--epochs") + 1] = "3"
    trainer, state = tcli.main(argv2 + ["--resume",
                                        str(out / "final_model.pt")])
    assert len(trainer.history["total"]) == 1          # epoch 3 only
    assert int(state["step"]) == 6
    assert json.loads((tmp_path / "final_model.pt.json").read_text()
                      )["epoch"] == 2
    img = torch.rand(3, 3, 32, 32)
    feats = trainer.encode(state["params"], img)
    assert feats.shape == (3, 5, 5, 384) and torch.isfinite(feats).all()


def test_cli_train_subcommand(tmp_path):
    argv = [a for a in FLAGS] + ["--output_dir", str(tmp_path), "--device",
                                 "cpu"]
    argv[argv.index("--epochs") + 1] = "1"
    assert cli.main(["train"] + argv) == 0
    assert (tmp_path / "final_model.pt").exists()


# The wave-optics flags, --use_amp (bf16 decoder training),
# --lpips_weights, --streaming and --num_devices are ported: their cases
# (same ids) train one epoch on the renderer the JAX package picks.
# --num_devices 2 trains on two gloo ranks (this process and one it
# starts, on 2 threads each): its history is held against --num_devices
# 1's within 1e-5 relative (the decoder's dropout masks are drawn at the
# global batch's shape, so the runs differ only in the order the
# all-reduce sums), with the same files written.  --lpips_weights names
# a file in tmp_path: lpips.pth is written there (an lpips-alex checkpoint
# at the published shapes) and trains with the term at weight 0.1;
# missing.pth is not, and the term is dropped, as the JAX CLI drops it.
# --streaming with --synthetic trains on the synthetic scenes; with
# --data_dir (the last case) over a 2-image corpus in tmp_path.
PORTED_FLAGS = {"--use_amp": "TileRenderer",
                "--num_devices": "TileRenderer",
                "--streaming": "TileRenderer",
                "--use_phase_blending": "TileRenderer",
                "--use_qsr": "WaveRenderer",
                "--use_wave_rendering": "WaveRenderer",
                "--use_fourier_renderer": "TileRenderer",
                "--lpips_weights": "TileRenderer"}


@pytest.mark.parametrize("extra", [["--streaming"], ["--use_amp"],
                                   ["--use_phase_blending"],
                                   ["--num_devices", "2"],
                                   ["--use_qsr"],
                                   ["--use_wave_rendering"],
                                   ["--use_fourier_renderer"],
                                   ["--lpips_weights", "lpips.pth"],
                                   ["--lpips_weights", "missing.pth"],
                                   ["--streaming", "--data_dir", "corpus"]])
def test_unported_flags_raise(extra, tmp_path, monkeypatch):
    argv = FLAGS + ["--output_dir", str(tmp_path), "--device", "cpu",
                    "--synthetic_samples", "2"] + extra
    if "--data_dir" in extra:
        corpus = tmp_path / extra[2]
        synthetic_corpus.generate_corpus(str(corpus), n_images=2,
                                         image_size=32, seed=1)
        argv.remove("--synthetic")
        argv[argv.index(extra[2])] = str(corpus)
    if extra[0] == "--lpips_weights":
        path = tmp_path / extra[1]
        argv[argv.index(extra[1])] = str(path)
        argv[argv.index("--lpips_weight") + 1] = "0.1"
        if extra[1] == "lpips.pth":
            save_checkpoint(str(path), lpips_checkpoint("lpips", seed=0))
    if extra[0] == "--num_devices":
        monkeypatch.setenv("OMP_NUM_THREADS", "2")
    if extra[0] in PORTED_FLAGS:
        argv[argv.index("--epochs") + 1] = "1"
        trainer, _ = tcli.main(argv)
        assert type(trainer.renderer).__name__ == PORTED_FLAGS[extra[0]]
        assert np.isfinite(trainer.history["total"][0])
        if extra[0] == "--lpips_weights":
            found = extra[1] == "lpips.pth"
            assert (trainer.lpips is not None) == found
            assert ("lpips" in trainer.history) == found
            assert trainer.config.lpips_weight == (0.1 if found else 0.0)
            meta = json.loads((tmp_path / "final_model.pt.json").read_text())
            assert meta["config"]["lpips_weight"] == (0.1 if found else 0.0)
            if found:
                assert trainer.history["lpips"][0] > 0
        if "--data_dir" in extra:
            assert len(list(corpus.glob("*_rgb32.bin"))) == 2
        if extra[0] == "--num_devices":
            assert trainer.config.num_devices == 2
            one = tmp_path / "one"
            argv[argv.index(str(tmp_path))] = str(one)
            argv[argv.index("--num_devices") + 1] = "1"
            one_trainer, _ = tcli.main(argv)
            h1, h2 = one_trainer.history, trainer.history
            assert set(h1) == set(h2)
            for k, v in h1.items():
                assert abs(h2[k][0] - v[0]) <= 1e-5 * max(abs(v[0]), 1e-6), k
            assert sorted(p.name for p in one.iterdir()) == sorted(
                p.name for p in tmp_path.iterdir() if p.name != "one")
        return
    with pytest.raises(NotImplementedError):
        tcli.main(argv)


@pytest.mark.parametrize("exp,n", [(1, 1024), (3, 1024), (5, 55)])
def test_experiments_135_train(exp, n, tmp_path):
    argv = ["--synthetic", "--synthetic_samples", "2", "--batch_size", "2",
            "--epochs", "1", "--image_size", "32", "--max_per_tile", "64",
            "--lpips_weight", "0", "--n_spiral_points", "55", "--nca_steps",
            "2", "--experiment", str(exp), "--output_dir", str(tmp_path),
            "--device", "cpu"]
    trainer, state = tcli.main(argv)
    assert trainer._total_gaussians(1) == n     # 256^2 depth / 8, squared
    assert np.isfinite(trainer.history["total"][0])
    meta = json.loads((tmp_path / "final_model.pt.json").read_text())
    assert meta["config"]["experiment"] == exp


def test_experiment4_trains(tmp_path):
    argv = FLAGS + ["--output_dir", str(tmp_path), "--device", "cpu",
                    "--experiment", "4", "--n_spiral_points", "60"]
    argv[argv.index("--epochs") + 1] = "1"
    trainer, state = tcli.main(argv)
    assert type(trainer.model).__name__ == "FibonacciPatchDecoder"
    assert trainer._total_gaussians(2) == 60
    assert np.isfinite(trainer.history["total"][0])
    assert "model.mlp.layers.3.weight" in state["params"]   # 512/256/128


def test_distill_needs_teacher_sidecars(tmp_path):
    argv = FLAGS + ["--output_dir", str(tmp_path), "--device", "cpu",
                    "--distill_weight", "0.5"]
    with pytest.raises(ValueError, match="fit_teacher"):
        tcli.main(argv)


def test_refuses_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(FLAGS + ["--output_dir", str(tmp_path)])
