"""Port parity: the refine slice (`fit_scene` and `fresnel refine`) against
the JAX package, on the CPU at a small size (grid 8, K 4: 256 Gaussians,
64^2, max_per_tile 256), on a smooth image made with numpy.

Tolerances, and why:
* init_raw: bit-identical (same float32 ops; numpy rounds half to even
  on both sides).
* The refine loss at the init: relative 1e-6; its gradient in raw and
  depth_offset within GRAD_TOL = 2e-4 of each gradient's largest entry.
  Both are float32 and differ in summation order (the JAX side runs its
  XLA scan compositor on the CPU, the port the plain versions of K1 and
  K2).  Measured: 1.16e-4 in raw (colour channel 12), all of it from
  SSIM's gradient (the L1 part agrees to 3e-7); SSIM's float32 gradient
  is that noisy on both sides (the port's float64 SSIM gradient is
  1.1e-5 of its largest entry away from JAX's float32 one on a 64^2
  image), so 1e-4 would sit at the noise.
* The 5-step fit: Adam's first steps are ~lr * sign(g), so a component
  whose gradient sits near zero can step +-lr on one side and not the
  other.  Trajectories are therefore held by the loss at each step
  (relative 1e-5), the final SSIM (1e-5) and PSNR (1e-4 dB), the depth
  offset (1e-5) and the mean absolute difference of raw (1e-4); the
  largest raw difference is only bounded by 2 * lr * steps.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.losses.ssim import ssim as jssim
from fresnel_tpu.models.decoders import head_transform as jhead
from fresnel_tpu.models.encoders import gradient_depth_estimate as jdepth
from fresnel_tpu.render.tile import TileRendererConfig as JConfig
from fresnel_tpu.render.tile import render_tiled as jrender
from fresnel_tpu.train import fit_teacher as jfit

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.render.tile import TileRendererConfig
from fresnel_tpu_torch.train import fit_teacher as tfit
from test_torch_threads import _few_threads  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
RES, GRID, K, MPT, STEPS, DO0 = 64, 8, 4, 256, 5, -0.13
GRAD_TOL = 2e-4


def smooth_image(size, seed):
    """(3, size, size) in [0, 1]: low-frequency waves and a few discs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.empty((3, size, size))
    for c in range(3):
        fx, fy, ph = rng.uniform(1, 3), rng.uniform(1, 3), rng.uniform(0, 6)
        img[c] = 0.5 + 0.3 * np.sin(2 * np.pi * fx * x + ph) * np.cos(
            2 * np.pi * fy * y)
    for _ in range(3):
        cx, cy, r = rng.uniform(0.2, 0.8), rng.uniform(0.2, 0.8), \
            rng.uniform(0.08, 0.2)
        img[:, (x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 1, (3, 1))
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    image = smooth_image(RES, 0)
    depth = np.array(jdepth(jnp.asarray(image.transpose(1, 2, 0)), RES))
    return image, depth


def test_init_raw_matches_jax(scene):
    image, depth = scene
    j = jfit.init_raw(image, depth, JCamera.default_training(RES), grid=GRID,
                      K=K)
    t = tfit.init_raw(image, depth, Camera.default_training(RES), grid=GRID,
                      K=K)
    assert t.shape == (1, GRID, GRID, K, 16) and t.dtype == np.float32
    np.testing.assert_array_equal(t, j)


def test_loss_and_grad_at_init_match_jax(scene):
    image, depth = scene
    raw0 = tfit.init_raw(image, depth, Camera.default_training(RES),
                         grid=GRID, K=K)
    cam, cfg = JCamera.default_training(RES), JConfig(max_per_tile=MPT)

    def jloss(p):
        out = jhead(p["raw"], jnp.asarray(depth)[None], p["do"])
        img = jrender(out["positions"][0], out["scales"][0],
                      out["rotations"][0], out["colors"][0],
                      out["opacities"][0], cam, config=cfg)
        t = jnp.asarray(image)
        return jnp.mean(jnp.abs(img - t)) + 0.5 * (1.0 - jssim(img[None],
                                                               t[None]))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        {"raw": jnp.asarray(raw0), "do": jnp.asarray(DO0, jnp.float32)})

    raw = torch.from_numpy(raw0.copy()).requires_grad_()
    do = torch.tensor(DO0).requires_grad_()
    img = tfit.render_raw(raw, torch.from_numpy(depth)[None], do,
                          Camera.default_training(RES),
                          TileRendererConfig(max_per_tile=MPT))
    loss = tfit.photometric_loss(img, torch.from_numpy(image))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-6 * abs(float(jl))
    for name, got in (("raw", raw.grad), ("do", do.grad)):
        ref = np.asarray(jg[name])
        err = np.abs(got.numpy() - ref).max()
        assert err <= GRAD_TOL * np.abs(ref).max(), (name, err)
    assert np.abs(np.asarray(jg["raw"])).max() > 1e-3


def test_fit_scene_matches_jax(scene):
    image, depth = scene
    cache = {}
    jt, jm = jfit.fit_scene(image, depth, steps=STEPS, grid=GRID, K=K,
                            res=RES, max_per_tile=MPT, step_fn_cache=cache,
                            depth_offset_init=DO0)
    # Replay the compiled step from the same init for the JAX losses.
    (entry,) = cache.values()
    raw0 = jfit.init_raw(image, depth, JCamera.default_training(RES),
                         grid=GRID, K=K)
    params = {"raw": jnp.asarray(raw0), "do": jnp.asarray(DO0, jnp.float32)}
    opt_state = entry["opt"].init(params)
    jlosses = []
    for _ in range(STEPS):
        params, opt_state, l = entry["step"](
            params, opt_state, jnp.asarray(depth)[None], jnp.asarray(image))
        jlosses.append(float(l))

    tt, tm = tfit.fit_scene(image, depth, steps=STEPS, grid=GRID, K=K,
                            res=RES, max_per_tile=MPT, depth_offset_init=DO0,
                            device="cpu")
    np.testing.assert_allclose(tm["losses"], jlosses, rtol=1e-5)
    assert tm["losses"][-1] < tm["losses"][0]
    assert abs(tm["ssim"] - jm["ssim"]) <= 1e-5
    assert abs(tm["psnr"] - jm["psnr"]) <= 1e-4
    assert abs(float(tt["depth_offset"]) - float(jt["depth_offset"])) <= 1e-5
    assert tt["raw"].shape == (GRID, GRID, K, 16)
    diff = np.abs(tt["raw"] - jt["raw"])
    assert diff.mean() <= 1e-4 and diff.max() <= 2 * 1e-2 * STEPS
    assert set(tt) == set(jt)


def test_freeze_geometry_and_prox(scene):
    image, depth = scene
    raw0 = tfit.init_raw(image, depth, Camera.default_training(RES),
                         grid=GRID, K=K)[0]
    kw = dict(steps=3, grid=GRID, K=K, res=RES, max_per_tile=MPT,
              depth_offset_init=DO0, device="cpu")
    frozen, _ = tfit.fit_scene(image, depth, freeze_geometry=True, **kw)
    geo = np.r_[0:3, 6:12]
    np.testing.assert_array_equal(frozen["raw"][..., geo], raw0[..., geo])
    assert np.abs(frozen["raw"][..., 12:16] - raw0[..., 12:16]).max() > 0
    _, free = tfit.fit_scene(image, depth, **kw)
    _, prox = tfit.fit_scene(image, depth, geometry_prox=1.0, **kw)
    # The pull is 0 at the init, and positive once the geometry moves.
    assert prox["losses"][0] == free["losses"][0]
    assert prox["losses"][2] > free["losses"][2]


def test_fixed_depth_offset_and_unported_experiment(scene):
    image, depth = scene
    t, m = tfit.fit_scene(image, depth, steps=1, grid=4, K=1, res=RES,
                          max_per_tile=64, fixed_depth_offset=-0.2,
                          device="cpu")
    assert t["depth_offset"] == np.float32(-0.2) and len(m["losses"]) == 1
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfit.fit_scene(image, depth, experiment=4, device="cpu")
    assert tfit.teacher_path(Path("a/s.png")) == Path("a/s_teacher.npz")
    assert tfit.teacher_path(Path("s.png"), 4) == Path("s_teacher4.npz")


def test_cli_refine_on_cpu_writes_a_ply(tmp_path):
    from PIL import Image

    from fresnel_tpu_torch.core.io import load_ply

    png = tmp_path / "in.png"
    Image.fromarray((smooth_image(40, 1).transpose(1, 2, 0) * 255).astype(
        np.uint8)).save(png)
    out = tmp_path / "out.ply"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "fresnel_tpu_torch.cli", "refine", str(png),
         str(out), "--device", "cpu", "--steps", "2", "--size", "64",
         "--max_per_tile", "256", "--depth_estimator", "gradient"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert '"steps": 2' in res.stdout.strip().splitlines()[-1]
    cloud = load_ply(out)
    assert cloud.num_gaussians == 37 * 37 * 4
    assert torch.isfinite(cloud.to_flat()).all()
