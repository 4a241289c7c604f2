"""Image post-processing for dataset generation (port of
fireflies_tpu/postprocessing).

Every processor is `apply(gen, image) -> image`, fired with probability
`p`: the gate and the processor's own draws come from the torch.Generator
`gen` (on the image's device), where the reference folds a key, and the
output is selected with a mask, so the draws a pipeline consumes do not
depend on which processors fired.  Images are (H, W) or (H, W, C) float
tensors in [0, 1]; `gaussian_blur2d` also takes a batch (B, H, W, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class PostProcessor:
    """Sequential pipeline: each function applied in turn, all drawing from
    one generator."""

    def __init__(self, functions: list):
        self._functions = list(functions)

    def post_process(self, gen: torch.Generator, image: Tensor) -> Tensor:
        for fn in self._functions:
            image = fn.apply(gen, image)
        return image

    apply = post_process


class BasePostProcessingFunction:
    """Stochastic gate: `post_process` with probability p."""

    def __init__(self, probability: float = 1.0):
        self._probability = float(probability)

    def apply(self, gen: torch.Generator, image: Tensor) -> Tensor:
        fire = torch.rand((), generator=gen, device=image.device) < self._probability
        return torch.where(fire, self.post_process(gen, image), image)

    def post_process(self, gen: torch.Generator, image: Tensor) -> Tensor:
        raise NotImplementedError


class WhiteNoise(BasePostProcessingFunction):
    """Additive Gaussian sensor noise N(mean, std), clipped to [0, 1]."""

    def __init__(self, mean: float = 0.0, std: float = 0.05, probability: float = 1.0):
        super().__init__(probability)
        self._mean = float(mean)
        self._std = float(std)

    def post_process(self, gen: torch.Generator, image: Tensor) -> Tensor:
        noise = torch.randn(image.shape, generator=gen, device=image.device)
        return (image + (self._mean + self._std * noise)).clamp(0.0, 1.0)


def gaussian_kernel_1d(size: int, sigma: float, device=None) -> Tensor:
    """Normalized 1D Gaussian of `size` taps, centred."""
    half = (size - 1) / 2.0
    x = torch.arange(size, dtype=torch.float32, device=device) - half
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur2d(image: Tensor, kernel_size=(3, 3), sigma=(1.0, 1.0)) -> Tensor:
    """Separable Gaussian blur of an (H, W) or (H, W, C) image or a
    (B, H, W, C) batch: reflect padding, then one depthwise pass along H
    and one along W, every image of a batch in the same two convolutions."""
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    batched = image.dim() == 4
    kh = gaussian_kernel_1d(int(kernel_size[0]), float(sigma[0]), image.device)
    kw = gaussian_kernel_1d(int(kernel_size[1]), float(sigma[1]), image.device)
    pad_h, pad_w = (len(kh) - 1) // 2, (len(kw) - 1) // 2
    x = image.permute(0, 3, 1, 2) if batched else image.permute(2, 0, 1)[None]  # (N, C, H, W)
    x = F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    c = x.shape[1]
    x = F.conv2d(x, kh.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.conv2d(x, kw.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    out = x.permute(0, 2, 3, 1) if batched else x[0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


class GaussianBlur(BasePostProcessingFunction):
    """Optical blur (the reference main loop uses kernel (3, 3), sigma
    (5, 5), p 0.5)."""

    def __init__(self, kernel_size=(3, 3), sigma=(5.0, 5.0), probability: float = 1.0):
        super().__init__(probability)
        self._kernel_size = tuple(int(k) for k in kernel_size)
        self._sigma = tuple(float(s) for s in sigma)

    def post_process(self, gen: torch.Generator, image: Tensor) -> Tensor:
        return gaussian_blur2d(image, self._kernel_size, self._sigma)


class ApplySilhouette(BasePostProcessingFunction):
    """Endoscope vignette: a randomly placed bright circle, blurred, times
    the image.  Centre and radius are drawn as fractions of the image size
    (the reference's pixel ranges for 512^2 images, scaled)."""

    def __init__(self, center_x_range=(0.195, 0.39), center_y_range=(0.39, 0.586),
                 radius_range=(0.33, 0.45), blur_sigma: float = 5.0, probability: float = 1.0):
        super().__init__(probability)
        self._cx = center_x_range
        self._cy = center_y_range
        self._r = radius_range
        self._blur_sigma = float(blur_sigma)

    def post_process(self, gen: torch.Generator, image: Tensor) -> Tensor:
        h, w = image.shape[0], image.shape[1]
        dev = image.device

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand((), generator=gen, device=dev)

        cx = uniform(*self._cx) * w
        cy = uniform(*self._cy) * h
        r = uniform(*self._r) * max(h, w)
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
        mask = (((gx - cx) ** 2 + (gy - cy) ** 2) <= r * r).to(torch.float32)
        ks = max(int(self._blur_sigma) * 2 + 1, 3)
        mask = gaussian_blur2d(mask, (ks, ks), (self._blur_sigma, self._blur_sigma))
        if image.dim() == 3:
            mask = mask[..., None]
        return image * mask


__all__ = [
    "PostProcessor",
    "BasePostProcessingFunction",
    "WhiteNoise",
    "GaussianBlur",
    "ApplySilhouette",
    "gaussian_blur2d",
    "gaussian_kernel_1d",
]
