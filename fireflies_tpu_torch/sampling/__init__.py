"""Sampling layer (port of fireflies_tpu/sampling: the samplers; the
Perlin noise texture and the Poisson-disk generators are not ported yet)."""

from fireflies_tpu_torch.sampling.base import ConstantSampler, Sampler
from fireflies_tpu_torch.sampling.samplers import (
    AnimationSampler,
    GaussianSampler,
    UniformIntegerSampler,
    UniformSampler,
    UniformScalarToVec3Sampler,
)

__all__ = [
    "Sampler",
    "ConstantSampler",
    "UniformSampler",
    "GaussianSampler",
    "UniformIntegerSampler",
    "UniformScalarToVec3Sampler",
    "AnimationSampler",
]
