"""Pinhole camera with the reference's projection conventions.

Counterpart of fresnel_tpu/core/camera.py, with the same conventions:
  * the view matrix is world->camera and the camera looks down -Z;
  * pixel projection u = fx * x / (-z) + cx,  v = fy * (-y) / (-z) + cy
    (the Y flip puts the image origin at the top left);
  * positive depth = -z;
  * default training camera: fx = fy = 0.8 * size, cx = cy = size / 2,
    camera at world (0, 0, 2) looking down -Z (view[2, 3] = -2);
  * orbit camera (elevation, azimuth, distance) looking at the origin, view
    rows [right, up, -forward].

Intrinsics are Python floats rounded to float32, so arithmetic with them
matches the JAX package's float32 scalars.  `view` is a (4, 4) float32
tensor; it follows the points' device when used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    view: torch.Tensor  # (4, 4) world->camera
    width: int = 512
    height: int = 512
    near: float = 0.01
    far: float = 100.0

    @classmethod
    def create(cls, fx, fy, cx, cy, width, height, view=None,
               near: float = 0.01, far: float = 100.0) -> "Camera":
        if view is None:
            view = torch.eye(4, dtype=torch.float32)
        return cls(fx=_f32(fx), fy=_f32(fy), cx=_f32(cx), cy=_f32(cy),
                   view=torch.as_tensor(view, dtype=torch.float32),
                   width=int(width), height=int(height),
                   near=float(near), far=float(far))

    @classmethod
    def default_training(cls, render_size: int, focal_mult: float = 0.8,
                         origin_depth: float = 2.0) -> "Camera":
        """Frontal camera at world (0, 0, origin_depth) looking down -Z."""
        view = torch.eye(4, dtype=torch.float32)
        view[2, 3] = -origin_depth
        return cls.create(fx=render_size * focal_mult,
                          fy=render_size * focal_mult,
                          cx=render_size / 2, cy=render_size / 2,
                          width=render_size, height=render_size, view=view)

    @classmethod
    def from_pose(cls, elevation_rad, azimuth_rad, render_size: int,
                  focal_mult: float = 0.8, distance: float = 2.0,
                  near: float = 0.01, far: float = 100.0) -> "Camera":
        """Orbit camera at (elevation, azimuth) looking at the origin; the
        straight-up pose takes `look_at_view`'s world-X fallback.  Float32
        arithmetic on the CPU, like the JAX package's."""
        el = torch.as_tensor(elevation_rad, dtype=torch.float32)
        az = torch.as_tensor(azimuth_rad, dtype=torch.float32)
        d = torch.as_tensor(distance, dtype=torch.float32)
        cam = torch.stack([d * torch.cos(el) * torch.sin(az),
                           d * torch.sin(el),
                           d * torch.cos(el) * torch.cos(az)])
        view = look_at_view(cam, torch.zeros(3, dtype=torch.float32))
        return cls.create(fx=render_size * focal_mult,
                          fy=render_size * focal_mult,
                          cx=render_size / 2, cy=render_size / 2,
                          width=render_size, height=render_size, view=view,
                          near=near, far=far)

    @classmethod
    def look_at(cls, eye, target, render_size: int = 512,
                fov_y_deg: float = 45.0, up=(0.0, 1.0, 0.0),
                near: float = 0.1, far: float = 100.0) -> "Camera":
        """Camera with the focal length of a vertical field of view:
        fy = H / (2 tan(fov_y / 2)), square pixels."""
        fy = render_size / (2.0 * np.tan(np.radians(fov_y_deg) * 0.5))
        view = look_at_view(torch.as_tensor(eye, dtype=torch.float32),
                            torch.as_tensor(target, dtype=torch.float32),
                            torch.as_tensor(up, dtype=torch.float32))
        return cls.create(fx=fy, fy=fy, cx=render_size / 2,
                          cy=render_size / 2, width=render_size,
                          height=render_size, view=view, near=near, far=far)

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Camera":
        return self.replace(view=self.view.to(device))

    @property
    def position(self) -> torch.Tensor:
        """Camera center in world space: -R^T t."""
        R = self.view[:3, :3]
        t = self.view[:3, 3]
        return -R.T @ t

    def intrinsics(self) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32)

    def world_to_camera(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 3) world points -> (..., 3) camera-space points.

        Broadcast-and-reduce, as the JAX package does, so the 3x3 product
        stays exact float32 elementwise arithmetic."""
        view = self.view.to(points.device)
        R = view[:3, :3]
        t = view[:3, 3]
        return torch.sum(points[..., None, :] * R, dim=-1) + t

    def project(self, points: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., 3) world points -> ((..., 2) pixel uv, (...,) depth),
        with the near-plane z clamp and the Y flip."""
        p_cam = self.world_to_camera(points)
        x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
        z_safe = torch.clamp(torch.abs(z), min=self.near) * torch.sign(z + 1e-8)
        u = self.fx * x / (-z_safe) + self.cx
        v = self.fy * (-y) / (-z_safe) + self.cy
        return torch.stack([u, v], dim=-1), -z


def look_at_view(eye: torch.Tensor, target: torch.Tensor,
                 up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Right-handed Y-up lookAt view matrix (world->camera), rows
    [right, up', -forward] with translation -R @ eye.  A zero-length
    forward falls back to -Z, and a pose looking straight along `up` to
    world X as right."""
    f32 = torch.float32
    if up is None:
        up = torch.tensor([0.0, 1.0, 0.0], dtype=f32)
    fwd = target - eye
    fn = torch.linalg.norm(fwd)
    fwd = torch.where(fn < 1e-6, torch.tensor([0.0, 0.0, -1.0], dtype=f32),
                      fwd / torch.clamp(fn, min=1e-6))
    right = torch.linalg.cross(fwd, up)
    rn = torch.linalg.norm(right)
    right = torch.where(rn < 1e-6, torch.tensor([1.0, 0.0, 0.0], dtype=f32),
                        right / torch.clamp(rn, min=1e-6))
    up2 = torch.linalg.cross(right, fwd)
    R = torch.stack([right, up2, -fwd])                          # (3, 3)
    view = torch.eye(4, dtype=f32)
    view[:3, :3] = R
    view[:3, 3] = -R @ eye
    return view
