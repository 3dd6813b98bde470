"""EWA projection of 3D Gaussians to screen space.

Counterpart of fresnel_tpu/render/projection.py.  The covariance chain is
the same elementwise 3x3 expansion (no batched 3x3 matmuls), and the
Jacobian keeps the reference's J[1, 2] = +fy * y / z^2 sign convention,
which trained checkpoints embed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.gaussians import quaternion_to_rotation_matrix


@dataclasses.dataclass(frozen=True)
class GaussianProjection:
    """Screen-space view of a Gaussian cloud (all shapes lead with N)."""

    means2d: torch.Tensor   # (N, 2) pixel centers
    cov2d: torch.Tensor     # (N, 2, 2)
    conic: torch.Tensor     # (N, 3) packed inverse covariance [a, b, c]
    depths: torch.Tensor    # (N,) positive view-space depth
    radii: torch.Tensor     # (N,) 3-sigma pixel radius (clamped)
    visible: torch.Tensor   # (N,) bool

    def replace(self, **kw) -> "GaussianProjection":
        return dataclasses.replace(self, **kw)


def compute_2d_covariance(positions: torch.Tensor, scales: torch.Tensor,
                          rotations: torch.Tensor, camera: Camera
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (cov2d (N, 2, 2), means2d (N, 2), depths (N,))."""
    p_cam = camera.world_to_camera(positions)
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    depths = -z

    R = quaternion_to_rotation_matrix(rotations)               # (N, 3, 3)
    view_rot = camera.view.to(positions.device)[:3, :3]
    # M = view_rot @ R, expanded over the contracted axis.
    M = torch.sum(view_rot[None, :, :, None] * R[:, None, :, :], dim=2)
    # cov3d = M diag(s^2) M^T.
    s2 = scales * scales
    Ms = M * s2[:, None, :]
    cov3d = torch.sum(Ms[:, :, None, :] * M[:, None, :, :], dim=-1)

    z_safe = torch.clamp(torch.abs(z), min=0.01) * torch.sign(z + 1e-8)
    z2 = z_safe * z_safe
    fx, fy = camera.fx, camera.fy

    ja = fx / (-z_safe)               # du/dx
    jb = fx * x / z2                  # du/dz
    jc = fy / z_safe                  # dv/dy
    jd = fy * y / z2                  # dv/dz (reference sign)
    s00 = cov3d[..., 0, 0]
    s01 = cov3d[..., 0, 1]
    s02 = cov3d[..., 0, 2]
    s11 = cov3d[..., 1, 1]
    s12 = cov3d[..., 1, 2]
    s22 = cov3d[..., 2, 2]
    c00 = ja * ja * s00 + 2.0 * ja * jb * s02 + jb * jb * s22
    c01 = ja * (jc * s01 + jd * s02) + jb * (jc * s12 + jd * s22)
    c11 = jc * jc * s11 + 2.0 * jc * jd * s12 + jd * jd * s22
    cov2d = torch.stack([torch.stack([c00, c01], dim=-1),
                         torch.stack([c01, c11], dim=-1)], dim=-2)

    u = fx * x / (-z_safe) + camera.cx
    v = fy * (-y) / (-z_safe) + camera.cy
    return cov2d, torch.stack([u, v], dim=-1), depths


def effective_radius(cov2d: torch.Tensor, max_radius: float = 64.0
                     ) -> torch.Tensor:
    """3-sigma pixel radius from the larger eigenvalue of each 2x2 cov."""
    a = cov2d[..., 0, 0]
    b = cov2d[..., 0, 1]
    c = cov2d[..., 1, 0]
    d = cov2d[..., 1, 1]
    trace = a + d
    det = torch.clamp(a * d - b * c, min=1e-6)
    disc = torch.clamp(trace * trace - 4.0 * det, min=0.0)
    lam_max = 0.5 * (trace + torch.sqrt(disc))
    radii = 3.0 * torch.sqrt(torch.clamp(lam_max, min=1e-6))
    return torch.clamp(radii, max=max_radius)


def conic_from_cov(cov2d: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Packed inverse [a, b, c] of the regularised 2x2 covariance:
    mahalanobis = a dx^2 + 2 b dx dy + c dy^2."""
    a = cov2d[..., 0, 0] + eps
    b = 0.5 * (cov2d[..., 0, 1] + cov2d[..., 1, 0])
    d = cov2d[..., 1, 1] + eps
    det = torch.clamp(a * d - b * b, min=1e-12)
    inv_det = 1.0 / det
    return torch.stack([d * inv_det, -b * inv_det, a * inv_det], dim=-1)


def project_gaussians(positions: torch.Tensor, scales: torch.Tensor,
                      rotations: torch.Tensor, camera: Camera,
                      max_radius: float = 64.0,
                      visibility_margin: Optional[float] = None
                      ) -> GaussianProjection:
    """Screen-space projection with visibility classification.

    visibility_margin=None uses each Gaussian's radius as its screen margin
    (tile-renderer semantics); a float uses a fixed pixel margin."""
    cov2d, means2d, depths = compute_2d_covariance(
        positions, scales, rotations, camera)
    radii = effective_radius(cov2d, max_radius=max_radius)
    conic = conic_from_cov(cov2d)

    W, H = camera.width, camera.height
    margin = radii if visibility_margin is None else visibility_margin
    u, v = means2d[..., 0], means2d[..., 1]
    visible = (depths > camera.near) & (depths < camera.far)
    visible &= (u + margin > 0) & (u - margin < W)
    visible &= (v + margin > 0) & (v - margin < H)
    return GaussianProjection(means2d=means2d, cov2d=cov2d, conic=conic,
                              depths=depths, radii=radii, visible=visible)


def batch_cameras(cameras, B: int):
    """The B cameras of a batch: one Camera for every cloud, or a sequence
    of B of one size."""
    cams = (list(cameras) if isinstance(cameras, (list, tuple))
            else [cameras] * B)
    if len(cams) != B:
        raise ValueError(f"{len(cams)} cameras for {B} clouds")
    if any((c.height, c.width) != (cams[0].height, cams[0].width)
           for c in cams):
        raise ValueError("every camera of a batch must have one size")
    return cams


def depth_sort_indices(proj: GaussianProjection, method: str = "exact"
                       ) -> torch.Tensor:
    """Front-to-back order with invisible Gaussians pushed to the end.

    Only method="exact" is ported: a stable argsort of the depth with
    invisible Gaussians keyed +inf, as jnp.argsort (stable) orders them."""
    if method != "exact":
        raise NotImplementedError(
            f"depth_sort method {method!r} is not ported; use 'exact'")
    key = torch.where(proj.visible, proj.depths,
                      torch.full_like(proj.depths, float("inf")))
    return torch.argsort(key, stable=True)
