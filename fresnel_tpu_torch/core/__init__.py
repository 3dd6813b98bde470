from fresnel_tpu_torch.core.camera import Camera
from fresnel_tpu_torch.core.gaussians import (
    GaussianCloud,
    quaternion_normalize,
    quaternion_to_rotation_matrix,
    rotation_6d_to_quaternion,
    rotation_matrix_to_quaternion,
)

__all__ = [
    "Camera",
    "GaussianCloud",
    "quaternion_normalize",
    "quaternion_to_rotation_matrix",
    "rotation_6d_to_quaternion",
    "rotation_matrix_to_quaternion",
]
