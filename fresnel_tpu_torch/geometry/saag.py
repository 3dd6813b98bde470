"""SAAG geometry: depth -> point cloud -> surface-aligned anisotropic
Gaussians with silhouette wrapping, a volumetric shell and adaptive
density.

Counterpart of fresnel_tpu/geometry/saag.py, as plain tensor functions on
the depth's device.  Every function takes optional leading batch
dimensions: a (..., H, W) depth gives a (..., N, ...) point cloud and
cloud, with the pixel grid `pixel_xy` (N, 2) shared by the batch, so the
training prior of a batch is one call.  The output keeps the JAX package's
static block layout, [N base | N shell back | N * segments walls |
N * layers wrap | N * extra density], an inactive entry masked to opacity
0.  Each field of `SurfaceGaussianParams` may also be an (..., N) tensor
(`modulated_surface_params`): every expression that reads one broadcasts
elementwise, and a Python float stays a Python float, so it is rounded
into float32 where the JAX package rounds it.

Rounding follows the JAX package run eagerly (the infer and viewer
paths): the 3x3 window mean is a sequential sum times float32(1 / 9), as
XLA rewrites the division of `jnp.mean`; `torch.linalg.norm` and
`torch.linalg.cross` give XLA:CPU's bits; sqrt goes through float64 and a
division by a number through a tensor divisor, so both round once on
every device.  arccos, cos and sin differ
from XLA's by an ulp or two; near a flat region that moves a rotation by
about ulp / sin(angle) (tests/test_torch_saag.py states the tolerances).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from fresnel_tpu_torch.core.gaussians import GaussianCloud


# ----------------------------------------------------------------------
# Parameter structs (the JAX package's defaults)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SurfaceGaussianParams:
    base_size: float = 0.008
    aspect_ratio: float = 5.0
    edge_threshold: float = 0.15
    edge_shrink: float = 0.3
    min_confidence: float = 0.1
    gradient_scale: float = 50.0
    normal_strength: float = 1.0


@dataclasses.dataclass(frozen=True)
class SilhouetteWrapParams:
    enabled: bool = True
    edge_threshold: float = 0.15
    wrap_layers: int = 3
    layer_spacing: float = 0.5
    opacity_falloff: float = 0.7
    max_wrap_angle: float = 75.0
    wrap_aspect: float = 2.0


@dataclasses.dataclass(frozen=True)
class VolumetricShellParams:
    enabled: bool = True
    thickness: float = 0.3
    back_opacity: float = 0.6
    back_darken: float = 0.8
    connect_walls: bool = True
    wall_segments: int = 3
    wall_opacity: float = 0.5
    edge_threshold: float = 0.1


@dataclasses.dataclass(frozen=True)
class AdaptiveDensityParams:
    enabled: bool = True
    gradient_threshold: float = 0.08
    extra_count: int = 4
    position_jitter: float = 0.6
    size_variance: float = 0.3
    opacity_scale: float = 0.7
    seed: int = 12345


def _max(x, floor: float):
    """jnp.maximum(x, floor) for a tensor or a Python float."""
    return torch.clamp(x, min=floor) if torch.is_tensor(x) else max(x, floor)


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """x / d rounded once on every device: on CUDA torch divides by a
    Python number as a product with its rounded reciprocal, so the
    divisor goes over as a tensor on x's device."""
    if not torch.is_tensor(d):
        d = torch.tensor(d, dtype=x.dtype, device=x.device)
    return x / d


def _col(x):
    """x[..., None] for a tensor; a Python float as it is."""
    return x[..., None] if torch.is_tensor(x) else x


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt correctly rounded (through float64) on every device:
    torch's vectorised CPU sqrt is 1 ulp off at ~0.7 % of inputs."""
    return torch.sqrt(x.double()).float()


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.norm(v, dim=-1, keepdim=keepdim)


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


# ----------------------------------------------------------------------
# Surface info (Sobel gradients -> normals)
# ----------------------------------------------------------------------

def surface_info(depth: torch.Tensor, gradient_scale: float = 50.0
                 ) -> Dict[str, torch.Tensor]:
    """(..., H, W) depth -> per-pixel surface info: normal (..., H, W, 3),
    gradient_mag (..., H, W), gradient_dir (..., H, W, 2), depth_delta
    and variance (..., H, W).  Edge padding; Sobel / 8."""
    lead, (H, W) = depth.shape[:-2], depth.shape[-2:]
    d = F.pad(depth.reshape(-1, 1, H, W), (1, 1, 1, 1),
              mode="replicate").reshape(*lead, H + 2, W + 2)

    def sh(dy, dx):  # 3x3 neighbourhood shifts
        return d[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    d00, d10, d20 = sh(-1, -1), sh(-1, 0), sh(-1, 1)
    d01, d11, d21 = sh(0, -1), sh(0, 0), sh(0, 1)
    d02, d12, d22 = sh(1, -1), sh(1, 0), sh(1, 1)

    gx = (-d00 + d20 - 2 * d01 + 2 * d21 - d02 + d22) / 8.0
    gy = (-d00 - 2 * d10 - d20 + d02 + 2 * d12 + d22) / 8.0
    mag = _sqrt(gx * gx + gy * gy)
    safe = torch.clamp(mag, min=1e-6)
    grad_dir = torch.where(mag[..., None] > 1e-6,
                           torch.stack([gx, gy], -1) / safe[..., None],
                           torch.zeros((), dtype=depth.dtype,
                                       device=depth.device))

    window = (d00, d10, d20, d01, d11, d21, d02, d12, d22)
    depth_delta = (torch.stack(window).amax(0)
                   - torch.stack(window).amin(0))
    ninth = torch.tensor(1.0 / 9.0, dtype=torch.float32)
    mean = _seq_sum(window) * ninth
    variance = _div(_seq_sum([(w - mean) ** 2 for w in window]) * ninth
                    * 9.0, 9.0)

    n = torch.stack([-gx * gradient_scale, -gy * gradient_scale,
                     torch.ones_like(gx)], -1)
    n_len = _norm(n, keepdim=True)
    normal = torch.where(n_len > 1e-6, n / torch.clamp(n_len, min=1e-6),
                         _const([0.0, 0.0, 1.0], n))
    return {"normal": normal, "gradient_mag": mag, "gradient_dir": grad_dir,
            "depth_delta": depth_delta, "variance": variance}


def _seq_sum(terms):
    """The terms summed left to right, XLA:CPU's order for a small
    reduction."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


# ----------------------------------------------------------------------
# Point cloud
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PointCloud:
    positions: torch.Tensor    # (..., N, 3)
    colors: torch.Tensor       # (..., N, 3)
    confidence: torch.Tensor   # (..., N)
    pixel_xy: torch.Tensor     # (N, 2) int32 source pixels, shared
    valid: torch.Tensor        # (..., N) bool

    @property
    def num_points(self) -> int:
        return self.positions.shape[-2]

    def bounds(self):
        """(lo, hi) over the valid points, (..., 3) each."""
        v = self.valid[..., None]
        lo = torch.where(v, self.positions, _const(1e9, self.positions))
        hi = torch.where(v, self.positions, _const(-1e9, self.positions))
        return lo.amin(dim=-2), hi.amax(dim=-2)

    def center(self) -> "PointCloud":
        lo, hi = self.bounds()
        mid = 0.5 * (lo + hi)
        return dataclasses.replace(self,
                                   positions=self.positions - mid[..., None, :])

    def normalize(self, target_extent: float = 3.0) -> "PointCloud":
        c = self.center()
        lo, hi = c.bounds()
        max_ext = (hi - lo).amax(dim=-1)
        # A tensor divisor: torch computes float / tensor as a reciprocal
        # times the float, which rounds twice.
        s = torch.where(max_ext > 1e-6,
                        torch.full_like(max_ext, target_extent)
                        / torch.clamp(max_ext, min=1e-6),
                        _const(1.0, max_ext))
        return dataclasses.replace(c, positions=c.positions * s[..., None, None])


def pointcloud_from_depth(
    depth: torch.Tensor,                     # (..., H, W) raw depth
    color: Optional[torch.Tensor] = None,    # (..., H, W, 3)
    intrinsics: Tuple[float, float, float, float] = (500.0, 500.0, 0.0, 0.0),
    depth_scale: float = 1.0,
    subsample: int = 1,
) -> PointCloud:
    """Unprojection with normalised inverted depth, z = (1 - normalised) *
    depth_scale, the Y axis flipped, the camera at the origin looking down
    -Z; confidence is the normalised depth; a point is valid where z >=
    0.01 * depth_scale."""
    lead, (H, W) = depth.shape[:-2], depth.shape[-2:]
    dev = depth.device
    fx, fy, cx, cy = intrinsics
    cx = cx if cx > 0 else W * 0.5
    cy = cy if cy > 0 else H * 0.5

    ys = torch.arange(0, H, subsample, device=dev)
    xs = torch.arange(0, W, subsample, device=dev)
    YY, XX = torch.meshgrid(ys, xs, indexing="ij")
    d = depth[..., YY, XX]

    min_d = depth.amin(dim=(-2, -1))[..., None, None]
    max_d = depth.amax(dim=(-2, -1))[..., None, None]
    rng = torch.where(max_d - min_d < 1e-6, _const(1.0, depth),
                      max_d - min_d)
    norm_d = (d - min_d) / rng
    z = (1.0 - norm_d) * depth_scale
    valid = z >= 0.01 * depth_scale

    X = _div(XX - cx, fx) * z
    Y = _div(cy - YY, fy) * z
    Z = -z
    positions = torch.stack([X, Y, Z], -1).reshape(*lead, -1, 3)
    n = positions.shape[-2]

    if color is not None:
        cols = color[..., torch.clamp(YY, max=color.shape[-3] - 1),
                     torch.clamp(XX, max=color.shape[-2] - 1), :]
        cols = cols.reshape(*lead, n, 3)
    else:
        cols = torch.full((*lead, n, 3), 0.7, device=dev)

    return PointCloud(
        positions=positions, colors=cols,
        confidence=norm_d.reshape(*lead, n),
        pixel_xy=torch.stack([XX, YY], -1).reshape(n, 2).to(torch.int32),
        valid=valid.reshape(*lead, n))


def pointcloud_to_gaussians(pc: PointCloud, point_size: float = 0.01,
                            opacity: float = 0.8) -> GaussianCloud:
    """Isotropic conversion: size point_size * (0.5 + 0.5 * confidence),
    identity rotations, opacity * confidence where valid."""
    size = point_size * (0.5 + 0.5 * pc.confidence)
    rot = torch.zeros((*size.shape, 4), device=size.device)
    rot[..., 0] = 1.0
    op = torch.where(pc.valid, opacity * pc.confidence,
                     _const(0.0, pc.confidence))
    return GaussianCloud(positions=pc.positions,
                         scales=size[..., None].expand(*size.shape, 3),
                         rotations=rot, colors=pc.colors, opacities=op)


# ----------------------------------------------------------------------
# Rotation helpers
# ----------------------------------------------------------------------

def quaternion_from_normal(normal: torch.Tensor) -> torch.Tensor:
    """The quaternion rotating +Z to `normal`, over leading dims; a normal
    (anti)parallel to +Z gives the identity or 180 degrees about X."""
    up = _const([0.0, 0.0, 1.0], normal).expand_as(normal)
    axis = torch.linalg.cross(up, normal, dim=-1)
    dot = normal[..., 2]
    axis_len = _norm(axis)

    angle = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    safe_axis = axis / torch.clamp(axis_len, min=1e-9)[..., None]
    half = 0.5 * angle
    q_general = torch.cat([torch.cos(half)[..., None],
                           safe_axis * torch.sin(half)[..., None]], -1)

    q_identity = _const([1.0, 0.0, 0.0, 0.0], normal)
    q_flip = _const([0.0, 1.0, 0.0, 0.0], normal)   # 180 degrees about X
    degenerate = axis_len < 1e-6
    q_degen = torch.where((dot > 0)[..., None], q_identity, q_flip)
    return torch.where(degenerate[..., None], q_degen, q_general)


def slerp_from_identity(q: torch.Tensor, t) -> torch.Tensor:
    """slerp(identity, q, t): the rotation angle scaled by t (a float or a
    tensor over q's leading dims)."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    sin_half = _sqrt(torch.clamp(1.0 - w * w, min=0.0))
    axis = q[..., 1:4] / torch.clamp(sin_half, min=1e-9)[..., None]
    half_t = 0.5 * t * angle
    q_t = torch.cat([torch.cos(half_t)[..., None],
                     axis * torch.sin(half_t)[..., None]], -1)
    identity = _const([1.0, 0.0, 0.0, 0.0], q)
    return torch.where((sin_half < 1e-6)[..., None], identity, q_t)


_MASK32 = 0xFFFFFFFF


def _pseudo_random(px: torch.Tensor, py: torch.Tensor, i: int,
                   seed: int) -> torch.Tensor:
    """The reference's deterministic pixel hash in [0, 1], float32: uint32
    arithmetic that wraps, computed in int64 (torch has no uint32 shift on
    the CPU) and masked to 32 bits after every product and sum; the
    largest product, 0x7FEB352D * 0xFFFFFFFF, fits in int64."""
    x = px.to(torch.int64) & _MASK32
    y = py.to(torch.int64) & _MASK32
    ii = i & _MASK32
    h = ((x * 374761393) & _MASK32) + ((y * 668265263) & _MASK32)
    h = (h + ((ii * 2147483647) & _MASK32)) & _MASK32
    h = ((h + (seed & _MASK32)) & _MASK32) ^ 0x85EBCA6B
    h = (((h >> 16) ^ h) * 0x7FEB352D) & _MASK32
    return _div((h & 0xFFFF).to(torch.float32), 65535.0)


# ----------------------------------------------------------------------
# The flagship: to_surface_gaussians
# ----------------------------------------------------------------------

def to_surface_gaussians(
    pc: PointCloud,
    depth: torch.Tensor,                     # (..., H, W) the SAME depth
    params: SurfaceGaussianParams = SurfaceGaussianParams(),
    wrap_params: SilhouetteWrapParams = SilhouetteWrapParams(),
    shell_params: VolumetricShellParams = VolumetricShellParams(),
    density_params: AdaptiveDensityParams = AdaptiveDensityParams(),
    opacity: float = 0.8,
) -> GaussianCloud:
    """Static-shape SAAG cloud, blocks (masked entries at opacity 0):
    [N base | N shell back | N * segments walls | N * layers wrap |
    N * extra density].  `pc.pixel_xy` indexes the full-resolution maps
    of `depth`, so a subsampled cloud reads them at its own pixels."""
    px = pc.pixel_xy[:, 0].to(torch.int64)
    py = pc.pixel_xy[:, 1].to(torch.int64)
    zero = _const(0.0, pc.positions)

    info = surface_info(depth, params.gradient_scale)
    normal = info["normal"][..., py, px, :]           # (..., N, 3)
    grad_mag = info["gradient_mag"][..., py, px]
    grad_dir = info["gradient_dir"][..., py, px, :]   # (..., N, 2)

    max_grad = torch.clamp(torch.where(pc.valid, grad_mag, zero).amax(
        dim=-1, keepdim=True), min=1e-6)
    norm_grad = grad_mag / max_grad

    active = pc.valid & (pc.confidence >= params.min_confidence)

    # --- base SAAG discs -------------------------------------------------
    surf_rot = quaternion_from_normal(normal)
    rotation = slerp_from_identity(surf_rot, params.normal_strength)

    base = params.base_size * (0.5 + 0.5 * pc.confidence)
    t_edge = torch.clamp((norm_grad - params.edge_threshold)
                         / _max(1.0 - params.edge_threshold, 1e-6), 0.0, 1.0)
    edge_factor = torch.where(norm_grad > params.edge_threshold,
                              1.0 - t_edge * (1.0 - params.edge_shrink),
                              _const(1.0, norm_grad))
    tangent = base * edge_factor
    normal_sc = _div(base, params.aspect_ratio) * edge_factor
    scale = torch.stack([tangent, tangent, normal_sc], -1)
    final_opacity = opacity * pc.confidence * (0.7 + 0.3 * edge_factor)
    final_opacity = torch.where(active, final_opacity, zero)

    blocks = [(pc.positions, scale, rotation, pc.colors, final_opacity)]

    # Shared view frame (camera at the origin).
    view_dir = pc.positions / torch.clamp(_norm(pc.positions, keepdim=True),
                                          min=1e-9)
    world_up = _const([0.0, 1.0, 0.0], view_dir).expand_as(view_dir)
    right = torch.linalg.cross(world_up, view_dir, dim=-1)
    right_len = _norm(right, keepdim=True)
    right = torch.where(right_len > 1e-6,
                        right / torch.clamp(right_len, min=1e-6),
                        _const([1.0, 0.0, 0.0], right))
    up = torch.linalg.cross(view_dir, right, dim=-1)

    # --- volumetric shell ------------------------------------------------
    if shell_params.enabled:
        shell_active = active & (norm_grad > shell_params.edge_threshold)
        back_pos = pc.positions + view_dir * shell_params.thickness
        back_rot = quaternion_from_normal(view_dir)
        back_col = pc.colors * shell_params.back_darken
        back_op = torch.where(shell_active,
                              final_opacity * shell_params.back_opacity, zero)
        blocks.append((back_pos, scale, back_rot, back_col, back_op))

        if shell_params.connect_walls:
            wall_tangent = (right * grad_dir[..., 0:1]
                            + up * grad_dir[..., 1:2])
            wt_len = _norm(wall_tangent)
            wall_ok = shell_active & (wt_len > 0.1)
            wall_tangent = wall_tangent / torch.clamp(wt_len,
                                                      min=1e-9)[..., None]
            wall_normal = torch.linalg.cross(view_dir, wall_tangent, dim=-1)
            wn_len = _norm(wall_normal, keepdim=True)
            wall_normal = wall_normal / torch.clamp(wn_len, min=1e-9)
            wall_rot = quaternion_from_normal(wall_normal)
            wall_scale = scale * 0.9
            wall_op = torch.where(
                wall_ok, final_opacity * shell_params.wall_opacity, zero)
            for seg in range(1, shell_params.wall_segments + 1):
                t = seg / float(shell_params.wall_segments + 1)
                wall_pos = pc.positions * (1 - t) + back_pos * t
                blocks.append((wall_pos, wall_scale, wall_rot, pc.colors,
                               wall_op))

    # --- silhouette wrapping --------------------------------------------
    if wrap_params.enabled:
        gd_len = _norm(grad_dir)
        wrap_ok = (active & (norm_grad > wrap_params.edge_threshold)
                   & (gd_len > 0.1))
        grad_3d = right * grad_dir[..., 0:1] + up * grad_dir[..., 1:2]
        wrap = torch.linalg.cross(normal, grad_3d, dim=-1)
        # Flip to point away from the camera (into the unseen side).
        flip = (wrap * view_dir).sum(-1, keepdim=True) < 0
        wrap = torch.where(flip, -wrap, wrap)
        w_len = _norm(wrap, keepdim=True)
        g3_len = _norm(grad_3d, keepdim=True)
        wrap_dir = torch.where(w_len > 1e-6,
                               wrap / torch.clamp(w_len, min=1e-9),
                               grad_3d / torch.clamp(g3_len, min=1e-9))
        wrap_rot = quaternion_from_normal(-wrap_dir)
        wrap_base = base * 0.8
        wrap_scale = torch.stack(
            [wrap_base, wrap_base, _div(wrap_base, wrap_params.wrap_aspect)],
            -1)
        for layer in range(wrap_params.wrap_layers):
            offset = ((layer + 1) * wrap_params.layer_spacing
                      * params.base_size)
            wrap_pos = pc.positions + wrap_dir * _col(offset)
            wrap_op = torch.where(
                wrap_ok,
                final_opacity * wrap_params.opacity_falloff ** (layer + 1),
                zero)
            blocks.append((wrap_pos, wrap_scale, wrap_rot, pc.colors,
                           wrap_op))

    # --- adaptive density ------------------------------------------------
    if density_params.enabled:
        dens_ok = active & (norm_grad > density_params.gradient_threshold)
        seed = density_params.seed

        def draw(i):
            return (_pseudo_random(px, py, i, seed) - 0.5) * 2

        for i in range(density_params.extra_count):
            jitter = density_params.position_jitter * base
            offs = torch.stack([draw(i * 3 + 0), draw(i * 3 + 1),
                                draw(i * 3 + 2)], -1)
            extra_pos = pc.positions + offs * jitter[..., None]
            size_var = 1.0 + (_pseudo_random(px, py, i * 3 + 100, seed)
                              - 0.5) * density_params.size_variance * 2.0
            extra_scale = scale * size_var[:, None] * 0.8
            extra_op = torch.where(
                dens_ok, final_opacity * density_params.opacity_scale, zero)
            blocks.append((extra_pos, extra_scale, rotation, pc.colors,
                           extra_op))

    def cat(k):
        return torch.cat([b[k] for b in blocks], dim=-2 if k < 4 else -1)

    return GaussianCloud(positions=cat(0), scales=cat(1), rotations=cat(2),
                         colors=cat(3), opacities=cat(4))


# ----------------------------------------------------------------------
# Feature-guided SAAG (the experiment-3 inference path)
# ----------------------------------------------------------------------

def _patch_index(pixel_xy: torch.Tensor, grid_hw, map_hw):
    """Each point's cell (py, px) in a (gh, gw) map over an (H, W) grid."""
    gh, gw = map_hw
    H, W = grid_hw
    px = torch.clamp((_div(pixel_xy[:, 0].to(torch.float32), float(W))
                      * gw).to(torch.int32), 0, gw - 1).to(torch.int64)
    py = torch.clamp((_div(pixel_xy[:, 1].to(torch.float32), float(H))
                      * gh).to(torch.int32), 0, gh - 1).to(torch.int64)
    return py, px


def modulated_surface_params(base: SurfaceGaussianParams, mods: Dict,
                             pixel_xy: torch.Tensor, grid_hw
                             ) -> SurfaceGaussianParams:
    """Per-point SurfaceGaussianParams from FeatureGuidedSAAG's (gh, gw)
    modulation maps (one sample, no batch dim): the fields it modulates
    become (N,) tensors, each point reading the map cell over its pixel."""
    py, px = _patch_index(pixel_xy, grid_hw,
                          mods["base_size_mult"].shape[-2:])

    def at(name):
        return mods[name][py, px]

    return SurfaceGaussianParams(
        base_size=base.base_size * at("base_size_mult"),
        aspect_ratio=base.aspect_ratio * at("aspect_ratio_mult"),
        edge_threshold=torch.clamp(
            base.edge_threshold + at("edge_threshold_add"), 0.01, 0.99),
        edge_shrink=torch.clamp(base.edge_shrink * at("edge_shrink_mult"),
                                0.0, 1.0),
        min_confidence=base.min_confidence,
        gradient_scale=base.gradient_scale,
        normal_strength=torch.clamp(
            base.normal_strength * at("normal_strength_mult"), 0.0, 1.0),
    )


def feature_guided_surface_gaussians(
    pc: PointCloud,
    depth: torch.Tensor,
    mods: Dict,
    base_params: SurfaceGaussianParams = SurfaceGaussianParams(),
    wrap_params: SilhouetteWrapParams = SilhouetteWrapParams(),
    shell_params: VolumetricShellParams = VolumetricShellParams(),
    density_params: AdaptiveDensityParams = AdaptiveDensityParams(),
    opacity: float = 0.8,
) -> GaussianCloud:
    """SAAG with the per-patch modulation maps applied per point, the
    opacity multiplier included (tiled over the static blocks)."""
    params = modulated_surface_params(
        base_params, mods, pc.pixel_xy, depth.shape[-2:])
    cloud = to_surface_gaussians(pc, depth, params=params,
                                 wrap_params=wrap_params,
                                 shell_params=shell_params,
                                 density_params=density_params,
                                 opacity=opacity)
    py, px = _patch_index(pc.pixel_xy, depth.shape[-2:],
                          mods["opacity_mult"].shape[-2:])
    op_mult = mods["opacity_mult"][py, px]
    reps = cloud.num_gaussians // pc.num_points
    return cloud.replace(opacities=torch.clamp(
        cloud.opacities * op_mult.repeat(reps), 0.0, 1.0))
