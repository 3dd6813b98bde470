from fresnel_tpu_torch.models.blocks import MLP
from fresnel_tpu_torch.models.decoders import DirectPatchDecoder, head_transform
from fresnel_tpu_torch.models.encoders import (
    FallbackDepthEstimator,
    create_depth_estimator,
    gradient_depth_estimate,
)
from fresnel_tpu_torch.models.vit import (
    DINOv2,
    DepthAnything,
    interpolate_pos_embed,
    resize_bilinear_ac,
)

__all__ = [
    "DINOv2",
    "DepthAnything",
    "DirectPatchDecoder",
    "FallbackDepthEstimator",
    "MLP",
    "create_depth_estimator",
    "gradient_depth_estimate",
    "head_transform",
    "interpolate_pos_embed",
    "resize_bilinear_ac",
]
