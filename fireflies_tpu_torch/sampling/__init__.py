"""Sampling layer (port of fireflies_tpu/sampling: the samplers the ported
scenes use; the others are not ported yet)."""

from fireflies_tpu_torch.sampling.base import Sampler
from fireflies_tpu_torch.sampling.samplers import AnimationSampler, UniformSampler

__all__ = ["Sampler", "UniformSampler", "AnimationSampler"]
