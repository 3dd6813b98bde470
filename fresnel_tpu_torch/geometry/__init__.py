from fresnel_tpu_torch.geometry.saag import (
    AdaptiveDensityParams,
    PointCloud,
    SilhouetteWrapParams,
    SurfaceGaussianParams,
    VolumetricShellParams,
    feature_guided_surface_gaussians,
    modulated_surface_params,
    pointcloud_from_depth,
    pointcloud_to_gaussians,
    quaternion_from_normal,
    surface_info,
    to_surface_gaussians,
)

__all__ = [
    "SurfaceGaussianParams", "SilhouetteWrapParams", "VolumetricShellParams",
    "AdaptiveDensityParams", "PointCloud", "surface_info",
    "pointcloud_from_depth", "pointcloud_to_gaussians",
    "to_surface_gaussians", "quaternion_from_normal",
    "modulated_surface_params", "feature_guided_surface_gaussians",
]
