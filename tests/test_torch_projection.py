"""Port parity: camera, rotations, projection and the exact depth sort.

The same numpy inputs, made from a seed, go through the JAX package and
fresnel_tpu_torch on the CPU.  Tolerance rtol = atol = 1e-6 (float32 on
both sides, same formulas).

XLA on the CPU contracts multiply-adds into fused multiply-adds, so a
quaternion norm differs from PyTorch's in the last bit, and the 2x2
covariance's off-diagonal entry cancels.  A one-ulp difference in the
rotation reaches the covariance through three products: covariances are
held at 2e-6 relative to each matrix's largest entry.  The inverse
amplifies that by the matrix's condition number: the conic is held at
2e-6 relative to the cloud's largest conic entry.  (docs/perf.md records
9e-7 for the TPU against CPU float32; these two CPU float32 programs, which
round in different places, land at 1.4e-6.)
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fresnel_tpu.core import gaussians as jg
from fresnel_tpu.core.camera import Camera as JCamera
from fresnel_tpu.render import projection as jp

from fresnel_tpu_torch.core import gaussians as tg
from fresnel_tpu_torch.core.camera import Camera as TCamera
from fresnel_tpu_torch.render import projection as tp

TOL = dict(rtol=1e-6, atol=1e-6)


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    pos[:, 2] -= 1.0
    scales = rng.uniform(0.01, 0.3, size=(n, 3)).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    return pos, scales, rots


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close_per_row(actual, desired, rel):
    """|actual - desired| <= rel * max |desired| over each Gaussian's
    entries (leading axis)."""
    d = np.asarray(desired).reshape(len(desired), -1)
    a = np.asarray(actual).reshape(len(desired), -1)
    scale = np.abs(d).max(axis=1, keepdims=True)
    err = (np.abs(a - d) / scale).max()
    assert err <= rel, err


def _look_at_view(seed):
    """A rotated, translated world->camera view from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    R = np.asarray(jg.quaternion_to_rotation_matrix(jnp.asarray(q, jnp.float32)))
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = R
    view[:3, 3] = rng.normal(size=3).astype(np.float32) * 0.3 + [0, 0, -2.5]
    return view


def _cameras(size, view=None):
    if view is None:
        return JCamera.default_training(size), TCamera.default_training(size)
    f, c = size * 0.8, size / 2
    return (JCamera.create(f, f, c, c, size, size, view=view),
            TCamera.create(f, f, c, c, size, size, view=view))


class TestCamera:
    def test_default_training_conventions(self):
        cam = TCamera.default_training(512)
        assert cam.fx == cam.fy == pytest.approx(409.6)
        assert cam.cx == cam.cy == 256.0
        assert cam.view[2, 3].item() == -2.0
        # A point 1 unit in front of the camera, above the axis, projects
        # above the centre (Y flip) at depth 1.
        uv, depth = cam.project(torch.tensor([[0.0, 0.5, 1.0]]))
        assert uv[0, 1].item() < 256.0
        assert depth.item() == pytest.approx(1.0)

    @pytest.mark.parametrize("view_seed", [None, 3])
    def test_project_matches_jax(self, view_seed):
        view = None if view_seed is None else _look_at_view(view_seed)
        jc, tc = _cameras(96, view)
        pos, _, _ = _cloud(200, 0)
        uv_j, d_j = jc.project(jnp.asarray(pos))
        uv_t, d_t = tc.project(_t(pos))
        np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), **TOL)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **TOL)


class TestRotations:
    def test_quaternion_to_matrix(self):
        _, _, q = _cloud(100, 1)
        np.testing.assert_allclose(
            tg.quaternion_to_rotation_matrix(_t(q)).numpy(),
            np.asarray(jg.quaternion_to_rotation_matrix(jnp.asarray(q))), **TOL)

    def test_matrix_to_quaternion_all_branches(self):
        # Rotations by ~pi about x, y and z hit the three non-trace branches.
        _, _, q = _cloud(60, 2)
        q[:5] = [1, 0, 0, 0]
        q[5:10] = [0.01, 1, 0.02, 0.03]
        q[10:15] = [0.01, 0.02, 1, 0.03]
        q[15:20] = [0.01, 0.02, 0.03, 1]
        R = np.asarray(jg.quaternion_to_rotation_matrix(jnp.asarray(q)))
        np.testing.assert_allclose(
            tg.rotation_matrix_to_quaternion(_t(R)).numpy(),
            np.asarray(jg.rotation_matrix_to_quaternion(jnp.asarray(R))), **TOL)

    def test_rotation_6d_with_degenerate_axes(self):
        rng = np.random.default_rng(3)
        r6 = rng.normal(size=(50, 6)).astype(np.float32)
        r6[:4, 3:6] = r6[:4, 0:3] * 2.0   # parallel: the fallback axis
        r6[4, :] = 0.0                    # both zero
        np.testing.assert_allclose(
            tg.rotation_6d_to_quaternion(_t(r6)).numpy(),
            np.asarray(jg.rotation_6d_to_quaternion(jnp.asarray(r6))), **TOL)


class TestProjection:
    @pytest.mark.parametrize("view_seed", [None, 5])
    def test_project_gaussians(self, view_seed):
        view = None if view_seed is None else _look_at_view(view_seed)
        jc, tc = _cameras(128, view)
        pos, scales, rots = _cloud(400, 4)
        pj = jp.project_gaussians(jnp.asarray(pos), jnp.asarray(scales),
                                  jnp.asarray(rots), jc, max_radius=32.0)
        pt = tp.project_gaussians(_t(pos), _t(scales), _t(rots), tc,
                                  max_radius=32.0)
        np.testing.assert_allclose(pt.means2d.numpy(), np.asarray(pj.means2d),
                                   **TOL)
        _assert_close_per_row(pt.cov2d.numpy(), pj.cov2d, 2e-6)
        np.testing.assert_allclose(pt.depths.numpy(), np.asarray(pj.depths),
                                   **TOL)
        np.testing.assert_allclose(pt.radii.numpy(), np.asarray(pj.radii),
                                   **TOL)
        np.testing.assert_array_equal(pt.visible.numpy(),
                                      np.asarray(pj.visible))
        cj = np.asarray(pj.conic)
        err = np.abs(pt.conic.numpy() - cj).max() / np.abs(cj).max()
        assert err <= 2e-6, err

    def test_reference_jacobian_sign(self):
        """J[1, 2] = +fy * y / z^2 (the reference's sign): a Gaussian
        stretched along y-z shears the opposite way to the analytic one."""
        cam = TCamera.default_training(64)
        pos = torch.tensor([[0.0, 0.4, -1.0]])
        scales = torch.tensor([[0.01, 0.2, 0.2]])
        c = np.cos(np.pi / 8)
        s = np.sin(np.pi / 8)
        rot = torch.tensor([[c, s, 0.0, 0.0]], dtype=torch.float32)
        cov, _, _ = tp.compute_2d_covariance(pos, scales, rot, cam)
        jcov, _, _ = jp.compute_2d_covariance(
            jnp.asarray(pos.numpy()), jnp.asarray(scales.numpy()),
            jnp.asarray(rot.numpy()), JCamera.default_training(64))
        _assert_close_per_row(cov.numpy(), jcov, 2e-6)

    def test_exact_depth_sort_order(self):
        jc, tc = _cameras(64)
        pos, scales, rots = _cloud(300, 6)
        pos[10:20, 2] = pos[0, 2]          # ties keep submission order
        pos[20:30, 2] = 5.0                # behind the camera: invisible
        pj = jp.project_gaussians(jnp.asarray(pos), jnp.asarray(scales),
                                  jnp.asarray(rots), jc)
        pt = tp.project_gaussians(_t(pos), _t(scales), _t(rots), tc)
        assert not pt.visible.all()         # invisible ones sort last
        np.testing.assert_array_equal(
            tp.depth_sort_indices(pt).numpy(),
            np.asarray(jp.depth_sort_indices(pj, method="exact")))

    def test_other_sorts_not_ported(self):
        pos, scales, rots = _cloud(8, 7)
        _, tc = _cameras(32)
        pt = tp.project_gaussians(_t(pos), _t(scales), _t(rots), tc)
        with pytest.raises(NotImplementedError):
            tp.depth_sort_indices(pt, method="counting")
