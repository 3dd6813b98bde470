from fresnel_tpu_torch.losses.ssim import ssim, ssim_loss

__all__ = ["ssim", "ssim_loss"]
