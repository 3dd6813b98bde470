from fresnel_tpu_torch.models.blocks import (
    MLP, FeatureInterpolator, bilinear_sample)
from fresnel_tpu_torch.models.decoders import (
    DirectPatchDecoder, PhysicsDirectPatchDecoder, head_transform)
from fresnel_tpu_torch.models.encoders import (
    FallbackDepthEstimator,
    create_depth_estimator,
    gradient_depth_estimate,
)
from fresnel_tpu_torch.models.nca import NCAGaussianDecoder
from fresnel_tpu_torch.models.saag_refine import (
    FeatureGuidedSAAG, SAAGRefinementNet)
from fresnel_tpu_torch.models.slat import (
    DirectSLatDecoder, DirectStructurePredictor, MLPSLatDecoder)
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
    "DirectSLatDecoder",
    "DirectStructurePredictor",
    "FallbackDepthEstimator",
    "FeatureGuidedSAAG",
    "FeatureInterpolator",
    "MLP",
    "MLPSLatDecoder",
    "NCAGaussianDecoder",
    "PhysicsDirectPatchDecoder",
    "SAAGRefinementNet",
    "bilinear_sample",
    "create_depth_estimator",
    "gradient_depth_estimate",
    "head_transform",
    "interpolate_pos_embed",
    "resize_bilinear_ac",
]
