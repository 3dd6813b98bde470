"""Port parity: CVS multi-view generation and its 3DGS fit
(inference/cvs_multiview.py) against the JAX package's, on the CPU.

* `camera_path`: orbit and hemisphere poses equal to JAX's, exactly.
* `optimize_3dgs`: 2 Adam steps of 2 000 Gaussians on 3 orbit views at
  64^2 (M 256), the port rendering the 3 views as one batched pack, JAX
  one at a time.  One jitted JAX loss (the JAX function's own: L1 + 0.5
  (1 - SSIM) of the stacked `render_tiled` images) scores the start and
  both packages' fitted clouds: the port's first loss against JAX's at
  the start, and the two fitted clouds' losses, within 1e-4 relative;
  positions within 2 * lr * steps of each other (Adam's first steps are
  about lr * sign(g); measured 5.2e-5) and every field's mean absolute
  difference within 1e-5 (measured 3.6e-6 at most, the rotations).
* `main` end to end on the CPU from a `.pt` checkpoint of the port's
  trainer (32^2, base 32), with and without concat_input_view (the JAX
  `main` calls `generate` without the input view, which such a model
  refuses): one PNG per view, the fitted PLY read back with every row
  finite.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.inference import cvs_multiview as J
from fresnel_tpu.losses.ssim import ssim as jssim
from fresnel_tpu.render.tile import TileRendererConfig, render_tiled

from fresnel_tpu_torch.core import io as tio
from fresnel_tpu_torch.inference import cvs_multiview as T
from fresnel_tpu_torch.train.train_cvs import CVSTrainConfig, CVSTrainer
from test_torch_threads import _few_threads  # noqa: F401

S, V, N, STEPS, LR = 64, 3, 2000, 2, 1e-2
LOSS_RTOL = 1e-4


@pytest.mark.parametrize("kind,n", [("orbit", 8), ("orbit", 5),
                                    ("hemisphere", 8), ("hemisphere", 12),
                                    ("hemisphere", 3)])
def test_camera_path(kind, n):
    assert T.camera_path(kind, n) == J.camera_path(kind, n)
    with pytest.raises(ValueError):
        T.camera_path("spiral", n)


def _views():
    y, x = np.mgrid[0:S, 0:S] / S
    out = []
    for v in range(V):
        img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (c + 1) * x + v)
                        * np.cos(2 * np.pi * y) for c in range(3)])
        out.append(img.astype(np.float32))
    return np.stack(out)


def _fields(cloud):
    return tuple(np.asarray(getattr(cloud, k), np.float32)
                 for k in ("positions", "scales", "rotations", "colors",
                           "opacities"))


@pytest.fixture(scope="module")
def fit():
    views = _views()
    poses = J.camera_path("orbit", V)
    jcloud = J.optimize_3dgs(views, poses, S, n_gaussians=N, steps=STEPS,
                             lr=LR)
    losses = []
    tcloud = T.optimize_3dgs(views, poses, S, n_gaussians=N, steps=STEPS,
                             lr=LR, device="cpu", losses=losses)
    cams = [JCamera.from_pose(el, az, S) for el, az in poses]
    cfg = TileRendererConfig(max_per_tile=256)

    @jax.jit
    def jloss(pos, scales, rots, colors, ops):
        imgs = jnp.stack([render_tiled(pos, scales, rots, colors, ops, c,
                                       config=cfg) for c in cams])
        return (jnp.mean(jnp.abs(imgs - views))
                + 0.5 * (1.0 - jssim(imgs, jnp.asarray(views))))

    init = T.fit_init(N, 0)
    start = (init["positions"].numpy(), np.exp(init["log_scales"].numpy()),
             init["rotations"].numpy(),
             np.full((N, 3), 0.5, np.float32), np.full((N,), 0.5, np.float32))
    return dict(jcloud=jcloud, tcloud=tcloud, losses=losses,
                jloss_start=float(jloss(*start)),
                jloss_jax=float(jloss(*_fields(jcloud))),
                jloss_port=float(jloss(*_fields(tcloud))))


def test_optimize_3dgs_matches_jax(fit):
    assert len(fit["losses"]) == STEPS
    l0 = float(fit["losses"][0])
    assert abs(l0 - fit["jloss_start"]) <= LOSS_RTOL * fit["jloss_start"]
    assert abs(fit["jloss_port"] - fit["jloss_jax"]) <= \
        LOSS_RTOL * fit["jloss_jax"]
    assert fit["jloss_jax"] < fit["jloss_start"]
    jf, tf = _fields(fit["jcloud"]), _fields(fit["tcloud"])
    assert np.abs(jf[0] - tf[0]).max() <= 2 * LR * STEPS
    for a, b in zip(jf[1:], tf[1:]):
        assert a.shape == b.shape
        assert np.abs(a - b).mean() <= 1e-5


@pytest.mark.parametrize("civ", [False, True], ids=["plain", "concat"])
def test_main_end_to_end(tmp_path, civ):
    from PIL import Image

    trainer = CVSTrainer(CVSTrainConfig(image_size=32, base_channels=32,
                                        concat_input_view=civ),
                         device="cpu")
    ckpt = tmp_path / "cvs_final.pt"
    trainer.save_checkpoint(ckpt, trainer.init_state(), 0)
    img = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(1).uniform(size=(48, 48, 3))
                     * 255).astype(np.uint8)).save(img)
    ply = tmp_path / "fit.ply"
    out = T.main([str(img), "--checkpoint", str(ckpt), "--views", "3",
                  "--output_dir", str(tmp_path / "views"), "--device",
                  "cpu", "--optimize_3dgs", str(ply), "--fit_steps", "2"])
    assert out["views"].shape == (3, 3, 32, 32)
    assert np.isfinite(out["views"]).all()
    assert sorted(p.name for p in (tmp_path / "views").iterdir()) == [
        "view_000.png", "view_001.png", "view_002.png"]
    back = tio.load_ply(ply)
    assert back.num_gaussians == 2000
    assert len(out["fit_losses"]) == 2 and out["fit_seconds"] > 0
    assert torch.isfinite(back.to_flat()).all()
