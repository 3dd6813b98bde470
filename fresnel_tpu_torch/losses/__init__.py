from fresnel_tpu_torch.losses.aggregate import compute_losses
from fresnel_tpu_torch.losses.lpips import LPIPS, load_lpips, random_lpips
from fresnel_tpu_torch.losses.matching import (
    MatchingWeights, gaussian_matching_loss, occupancy_bce_loss,
    proximity_occupancy_targets)
from fresnel_tpu_torch.losses.ssim import ms_ssim, ssim, ssim_loss

__all__ = ["compute_losses", "ssim", "ssim_loss", "ms_ssim",
           "LPIPS", "load_lpips", "random_lpips", "MatchingWeights",
           "gaussian_matching_loss", "occupancy_bce_loss",
           "proximity_occupancy_targets"]
