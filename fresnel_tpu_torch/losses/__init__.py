from fresnel_tpu_torch.losses.aggregate import compute_losses
from fresnel_tpu_torch.losses.ssim import ssim, ssim_loss

__all__ = ["compute_losses", "ssim", "ssim_loss"]
