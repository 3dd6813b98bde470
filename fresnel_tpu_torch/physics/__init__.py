from fresnel_tpu_torch.physics.diffraction import (
    DiffractiveLayer,
    FresnelDiffraction,
    MultiscaleDiffractiveLayer,
)
from fresnel_tpu_torch.physics.edge_detector import FresnelEdgeDetector
from fresnel_tpu_torch.physics.fresnel_zones import sobel_gradients

__all__ = ["DiffractiveLayer", "FresnelDiffraction", "FresnelEdgeDetector",
           "MultiscaleDiffractiveLayer", "sobel_gradients"]
