"""Image-quality metrics (counterpart of ``codenerf_tpu/core/metrics.py``).

``mse2psnr`` mirrors the reference (util.py:216-227); ``ssim`` is the JAX
package's, which the reference lacks (the CodeNeRF paper reports SSIM).
"""

from __future__ import annotations

import torch


def mse2psnr(mse) -> torch.Tensor:
    """PSNR from MSE with the reference's zero guard (util.py:224-227)."""
    mse = torch.as_tensor(mse)
    safe = torch.where(mse == 0, torch.full_like(mse, 1e-5), mse)
    return -10.0 * torch.log10(safe)


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity of two [H, W, C] images.

    Wang et al.'s SSIM with a separable Gaussian window, valid-mode
    convolution (interior pixels only), averaged over space and channels.
    """
    img0 = torch.as_tensor(img0, dtype=torch.float32)
    img1 = torch.as_tensor(img1, dtype=torch.float32, device=img0.device)
    # clamp the window to the image: a valid-mode window larger than the
    # image leaves nothing to average
    filter_size = min(filter_size, img0.shape[0], img0.shape[1])
    if filter_size % 2 == 0:
        filter_size -= 1
    hw = filter_size // 2
    offsets = torch.arange(-hw, hw + 1, dtype=torch.float32,
                           device=img0.device)
    kernel = torch.exp(-0.5 * (offsets / filter_sigma) ** 2)
    kernel = kernel / torch.sum(kernel)

    def blur(x):  # separable Gaussian, valid mode, per channel
        # weighted sums of shifted slices, in f32 on every device, so the
        # result does not hang on the convolution algorithm cuDNN picks
        # (TF32 is allowed for them by default): blur(x^2) - mu^2 cancels
        # on flat regions, where rounding the inputs moves the mean SSIM
        # by tenths
        n = kernel.shape[0]
        h, w = x.shape[0] - n + 1, x.shape[1] - n + 1
        y = sum(kernel[k] * x[k:k + h] for k in range(n))
        return sum(kernel[k] * y[:, k:k + w] for k in range(n))

    mu0 = blur(img0)
    mu1 = blur(img1)
    # blur(x^2) - mu^2 can go slightly negative by cancellation on flat
    # regions, and the covariance must obey Cauchy-Schwarz, else a pixel's
    # SSIM can exceed 1
    sigma00 = torch.clamp(blur(img0 ** 2) - mu0 ** 2, min=0.0)
    sigma11 = torch.clamp(blur(img1 ** 2) - mu1 ** 2, min=0.0)
    sigma01 = blur(img0 * img1) - mu0 * mu1
    bound = torch.sqrt(sigma00 * sigma11)
    sigma01 = torch.clamp(sigma01, -bound, bound)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu0 * mu1 + c1) * (2 * sigma01 + c2)
    denom = (mu0 ** 2 + mu1 ** 2 + c1) * (sigma00 + sigma11 + c2)
    return torch.mean(numer / denom)
