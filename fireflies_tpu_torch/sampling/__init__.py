"""Sampling layer (port of fireflies_tpu/sampling: the samplers, the Perlin
noise texture and the blue-noise generators)."""

from fireflies_tpu_torch.sampling.base import ConstantSampler, Sampler
from fireflies_tpu_torch.sampling.noise_texture_lerp import (
    NoiseTextureLerpSampler,
    rand_perlin_2d,
    rand_perlin_2d_octaves,
)
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
    "NoiseTextureLerpSampler",
    "rand_perlin_2d",
    "rand_perlin_2d_octaves",
    "bridson",
    "dart_throwing",
]
