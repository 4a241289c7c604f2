"""Image post-processing (port of the blur of fireflies_tpu/postprocessing).

`gaussian_blur2d` is the separable Gaussian blur with reflect padding that
the projector texture pipeline uses.  The PostProcessing classes are not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def gaussian_kernel_1d(size: int, sigma: float, device=None) -> Tensor:
    """Normalized 1D Gaussian of `size` taps, centred."""
    half = (size - 1) / 2.0
    x = torch.arange(size, dtype=torch.float32, device=device) - half
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur2d(image: Tensor, kernel_size=(3, 3), sigma=(1.0, 1.0)) -> Tensor:
    """Separable Gaussian blur of an (H, W) or (H, W, C) image: reflect
    padding, then one depthwise pass along H and one along W."""
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    kh = gaussian_kernel_1d(int(kernel_size[0]), float(sigma[0]), image.device)
    kw = gaussian_kernel_1d(int(kernel_size[1]), float(sigma[1]), image.device)
    pad_h, pad_w = (len(kh) - 1) // 2, (len(kw) - 1) // 2
    x = image.permute(2, 0, 1)[None]  # (1, C, H, W)
    x = F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    c = x.shape[1]
    x = F.conv2d(x, kh.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.conv2d(x, kw.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    out = x[0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out
