"""Port parity: orbit and look-at cameras, and the test cloud.

View matrices, positions and intrinsics are held at 1e-6 against the JAX
package's (both sides compute them in float32 on the CPU; XLA may fuse a
multiply-add that PyTorch does not).  `test_cloud` draws with numpy on both
sides, so its arrays are equal bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core import camera as jc
from fresnel_tpu.core.gaussians import GaussianCloud as JCloud

from fresnel_tpu_torch.core import camera as tc
from fresnel_tpu_torch.core.gaussians import GaussianCloud as TCloud

TOL = 1e-6


def _assert_cameras_close(t, j):
    np.testing.assert_allclose(t.view.numpy(), np.asarray(j.view), atol=TOL)
    for name in ("fx", "fy", "cx", "cy"):
        assert getattr(t, name) == float(getattr(j, name))
    assert (t.width, t.height, t.near, t.far) == (j.width, j.height, j.near,
                                                  j.far)
    assert t.view.dtype == torch.float32 and t.view.shape == (4, 4)


class TestFromPose:
    @pytest.mark.parametrize("az", [0.0, 45.0, 180.0, 315.0])
    @pytest.mark.parametrize("el", [-90.0, -45.0, 0.0, 30.0, 90.0])
    def test_pose_grid(self, el, az):
        t = tc.Camera.from_pose(np.radians(el), np.radians(az), 256)
        j = jc.Camera.from_pose(np.radians(el), np.radians(az), 256)
        _assert_cameras_close(t, j)
        np.testing.assert_allclose(t.position.numpy(), np.asarray(j.position),
                                   atol=TOL)

    @pytest.mark.parametrize("el", [-90.0, 90.0])
    def test_straight_up_takes_world_x_as_right(self, el):
        t = tc.Camera.from_pose(np.radians(el), 0.0, 64)
        np.testing.assert_array_equal(t.view[0, :3].numpy(), [1.0, 0.0, 0.0])

    def test_frontal_pose_is_default_training(self):
        """render's defaults (elevation 0, azimuth 0, distance 2) give the
        default training camera."""
        t = tc.Camera.from_pose(0.0, 0.0, 512, distance=2.0)
        d = tc.Camera.default_training(512)
        np.testing.assert_allclose(t.view.numpy(), d.view.numpy(), atol=TOL)
        assert (t.fx, t.fy, t.cx, t.cy) == (d.fx, d.fy, d.cx, d.cy)

    @pytest.mark.parametrize("kw", [
        dict(distance=3.5), dict(focal_mult=1.2), dict(near=0.1, far=20.0)])
    def test_keywords(self, kw):
        t = tc.Camera.from_pose(0.3, 1.1, 128, **kw)
        j = jc.Camera.from_pose(0.3, 1.1, 128, **kw)
        _assert_cameras_close(t, j)


class TestLookAt:
    @pytest.mark.parametrize("eye,target,kw", [
        ((0.0, 0.0, 3.0), (0.0, 0.0, 0.0), {}),
        ((1.0, 2.0, -1.5), (0.2, -0.1, 0.3), dict(fov_y_deg=60.0)),
        ((-2.0, 0.5, 0.5), (0.0, 0.0, 0.0),
         dict(render_size=200, up=(0.0, 0.0, 1.0), near=0.05, far=10.0)),
    ])
    def test_look_at(self, eye, target, kw):
        _assert_cameras_close(tc.Camera.look_at(eye, target, **kw),
                              jc.Camera.look_at(eye, target, **kw))

    @pytest.mark.parametrize("eye,target,up", [
        ((0.5, -1.0, 2.0), (0.0, 0.0, 0.0), None),
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), None),        # zero forward
        ((0.0, 2.0, 0.0), (0.0, 0.0, 0.0), None),        # forward along up
        ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),
    ])
    def test_look_at_view(self, eye, target, up):
        f32 = np.float32
        t_up = None if up is None else torch.tensor(up)
        j_up = None if up is None else jnp.asarray(up, jnp.float32)
        t = tc.look_at_view(torch.tensor(eye), torch.tensor(target), t_up)
        j = jc.look_at_view(jnp.asarray(eye, f32), jnp.asarray(target, f32),
                            j_up)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)
        R = t[:3, :3].double()
        np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-6)

    def test_position_and_intrinsics(self):
        t = tc.Camera.look_at((1.0, 2.0, 3.0), (0.0, 0.5, 0.0))
        j = jc.Camera.look_at((1.0, 2.0, 3.0), (0.0, 0.5, 0.0))
        np.testing.assert_allclose(t.position.numpy(), [1.0, 2.0, 3.0],
                                   atol=1e-5)
        np.testing.assert_allclose(t.position.numpy(), np.asarray(j.position),
                                   atol=TOL)
        K = t.intrinsics()
        assert K.dtype == torch.float32
        np.testing.assert_allclose(K.numpy(), np.asarray(j.intrinsics()),
                                   atol=TOL)

    def test_projection_through_posed_camera(self):
        rng = np.random.default_rng(0)
        pts = rng.normal(size=(50, 3)).astype(np.float32) * 0.3
        t = tc.Camera.from_pose(0.4, 2.0, 128)
        j = jc.Camera.from_pose(0.4, 2.0, 128)
        tu, td = t.project(torch.from_numpy(pts))
        ju, jd = j.project(jnp.asarray(pts))
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


class TestTestCloud:
    @pytest.mark.parametrize("kw", [
        dict(), dict(n=1000, seed=7, spread=0.8, z_offset=-2.0, scale=0.02)])
    def test_bitwise_equal(self, kw):
        t, j = TCloud.test_cloud(**kw), JCloud.test_cloud(**kw)
        for name in ("positions", "scales", "rotations", "colors",
                     "opacities"):
            a = getattr(t, name)
            assert a.dtype == torch.float32 and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(j, name)))

    def test_to_moves_every_field(self):
        c = TCloud.test_cloud(10).to("cpu")
        assert c.num_gaussians == 10 and c.to_flat().shape == (10, 14)
