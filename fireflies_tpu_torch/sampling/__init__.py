"""Sampling layer (port of fireflies_tpu/sampling: the samplers and the
blue-noise generators; the Perlin noise texture is not ported yet)."""

from fireflies_tpu_torch.sampling.base import ConstantSampler, Sampler
from fireflies_tpu_torch.sampling.poisson import bridson, dart_throwing
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
    "bridson",
    "dart_throwing",
]
