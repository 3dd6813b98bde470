"""Port parity: `Trainer` steps on the physics decoder's route,
`--use_wave_rendering --learnable_wavelength --use_diffraction_placement`
(experiment 2 without phase output: `PhysicsDirectPatchDecoder` through
the wave-field renderer), against the JAX package's, on the CPU at 48^2
(tests/test_torch_wave_train.py states the config and the tolerances);
the decoder's `wavelength_raw` after the steps within 1e-5 relative.
The port's checkpoint of the run rebuilds the physics decoder through
`trainer_from_checkpoint` and runs through `cli infer`."""

import numpy as np
import pytest
import torch

from test_torch_threads import _few_threads  # noqa: F401
from test_torch_wave_train import check_parity, run_both

FLAGS = ["--use_wave_rendering", "--learnable_wavelength",
         "--use_diffraction_placement", "--image_size", "48"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("physics"), FLAGS, 48)


def test_physics_route_matches_jax(run):
    t = run["trainer"]
    assert type(t.renderer).__name__ == "WaveRenderer"
    assert type(t.model).__name__ == "PhysicsDirectPatchDecoder"
    assert t.model.use_diffraction_placement
    check_parity(run)
    got = float(run["state"]["params"]["model.wavelength_raw"])
    want = float(run["final"]["model.wavelength_raw"])
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_physics_checkpoint_runs_through_infer(run, tmp_path):
    from PIL import Image

    from fresnel_tpu_torch import cli
    from fresnel_tpu_torch.core import io as gio
    from fresnel_tpu_torch.train.harness import trainer_from_checkpoint

    t = run["trainer"]
    ckpt = tmp_path / "physics.pt"
    t.save_checkpoint(ckpt, run["state"], 0)
    back = trainer_from_checkpoint(ckpt, device="cpu")
    assert type(back.model).__name__ == "PhysicsDirectPatchDecoder"
    state, epoch = back.load_checkpoint(ckpt)
    assert epoch == 0
    for k, v in run["state"]["params"].items():
        assert torch.equal(state["params"][k], v), k
    img = tmp_path / "img.png"
    Image.fromarray((np.random.default_rng(0).uniform(size=(48, 48, 3))
                     * 255).astype(np.uint8)).save(img)
    out = tmp_path / "out.ply"
    cli.main(["infer", str(img), str(out), "--checkpoint", str(ckpt),
              "--device", "cpu"])
    cloud = gio.load_ply(str(out))
    assert cloud.num_gaussians > 0
    assert torch.isfinite(cloud.to_flat()).all()
