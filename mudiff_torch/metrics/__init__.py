"""Image quality metrics of the port (PSNR, SSIM, MAE)."""

from mudiff_torch.metrics.image_metrics import evaluate_pair_dirs, mae, psnr, ssim

__all__ = ["mae", "psnr", "ssim", "evaluate_pair_dirs"]
