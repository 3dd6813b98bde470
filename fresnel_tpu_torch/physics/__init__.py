from fresnel_tpu_torch.physics.edge_detector import FresnelEdgeDetector
from fresnel_tpu_torch.physics.fresnel_zones import sobel_gradients

__all__ = ["FresnelEdgeDetector", "sobel_gradients"]
