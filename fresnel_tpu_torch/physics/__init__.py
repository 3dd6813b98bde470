from fresnel_tpu_torch.physics.fresnel_zones import sobel_gradients

__all__ = ["sobel_gradients"]
