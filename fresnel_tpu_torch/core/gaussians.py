"""Gaussian cloud container and rotation math (wxyz quaternions).

Counterpart of fresnel_tpu/core/gaussians.py: `GaussianCloud` with its
flat (N, 14) interchange [pos 3, scale 3, quat wxyz 4, rgb 3, opacity 1],
and the rotation helpers with the same formulas in the same order,
including the branch-free 4-case matrix->quaternion select and the
degenerate-axis fallback of the 6D parameterisation.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GaussianCloud:
    """A (possibly batched) cloud of 3D Gaussians; float32 tensors.

      positions (..., N, 3), scales (..., N, 3), rotations (..., N, 4)
      wxyz, colors (..., N, 3) in [0, 1], opacities (..., N) in [0, 1].
      The JAX class's optional `phases` is not ported: nothing on the
      port's paths renders phases.
    """

    positions: torch.Tensor
    scales: torch.Tensor
    rotations: torch.Tensor
    colors: torch.Tensor
    opacities: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return self.positions.shape[-2]

    def to_flat(self) -> torch.Tensor:
        """Pack into (..., N, 14): [pos3, scale3, quat4, rgb3, opacity1]."""
        return torch.cat([self.positions, self.scales, self.rotations,
                          self.colors, self.opacities[..., None]], dim=-1)

    @classmethod
    def from_flat(cls, flat: torch.Tensor) -> "GaussianCloud":
        return cls(positions=flat[..., 0:3], scales=flat[..., 3:6],
                   rotations=flat[..., 6:10], colors=flat[..., 10:13],
                   opacities=flat[..., 13])


def quaternion_normalize(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    q = quaternion_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion.

    Shepperd's method as a branch-free select over the four cases."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    trace = r00 + r11 + r22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-10))

    s1 = safe_sqrt(trace + 1.0) * 2
    c1 = torch.stack([0.25 * s1, (r21 - r12) / s1, (r02 - r20) / s1,
                      (r10 - r01) / s1], -1)
    s2 = safe_sqrt(1.0 + r00 - r11 - r22) * 2
    c2 = torch.stack([(r21 - r12) / s2, 0.25 * s2, (r01 + r10) / s2,
                      (r02 + r20) / s2], -1)
    s3 = safe_sqrt(1.0 + r11 - r00 - r22) * 2
    c3 = torch.stack([(r02 - r20) / s3, (r01 + r10) / s3, 0.25 * s3,
                      (r12 + r21) / s3], -1)
    s4 = safe_sqrt(1.0 + r22 - r00 - r11) * 2
    c4 = torch.stack([(r10 - r01) / s4, (r02 + r20) / s4, (r12 + r21) / s4,
                      0.25 * s4], -1)

    cond1 = (trace > 0)[..., None]
    cond2 = ((r00 > r11) & (r00 > r22))[..., None]
    cond3 = (r11 > r22)[..., None]
    q = torch.where(cond1, c1,
                    torch.where(cond2, c2, torch.where(cond3, c3, c4)))
    return quaternion_normalize(q)


def rotation_6d_to_quaternion(rot6d: torch.Tensor) -> torch.Tensor:
    """(..., 6) Zhou et al. 6D rotation -> (..., 4) wxyz quaternion.

    Gram-Schmidt on the two 3-vectors; parallel inputs fall back to a fixed
    third axis rather than NaN."""
    a1, a2 = rot6d[..., 0:3], rot6d[..., 3:6]

    def norm(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                               min=1e-6)

    b1 = norm(a1)
    b2 = norm(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    b3n = torch.linalg.norm(b3, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=b3.dtype,
                            device=b3.device).expand_as(b3)
    b3 = norm(torch.where(b3n < 1e-6, fallback, b3))
    R = torch.stack([b1, b2, b3], dim=-1)   # columns b1, b2, b3
    return rotation_matrix_to_quaternion(R)
