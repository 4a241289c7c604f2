"""Concrete samplers (port of fireflies_tpu/sampling/samplers.py): uniform,
Gaussian, uniform integer, one uniform scalar broadcast to a vec3, and the
animation frame index."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fireflies_tpu_torch.sampling.base import Sampler, _as_f32

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class UniformSampler(Sampler):
    """U(min, max) elementwise."""

    def sample_train(self, gen, device) -> Tensor:
        lo = torch.as_tensor(self.min_range, device=device)
        hi = torch.as_tensor(self.max_range, device=device)
        u = torch.rand(lo.shape, generator=gen, device=device)
        return u * (hi - lo) + lo


@dataclasses.dataclass(frozen=True)
class GaussianSampler(Sampler):
    """N(mean, std) elementwise, unclamped: min_range is the mean, max_range
    the std, as in the reference.  Eval mode is the base sweep from the mean
    over [0, std]."""

    def sample_train(self, gen, device) -> Tensor:
        mean = torch.as_tensor(self.min_range, device=device)
        std = torch.as_tensor(self.max_range, device=device)
        return torch.randn(mean.shape, generator=gen, device=device) * std + mean


@dataclasses.dataclass(frozen=True)
class UniformIntegerSampler(Sampler):
    """Uniform integers in [min, max) in train mode, the sweep
    min + step % (max - min) in eval mode; int32."""

    def sample_train(self, gen, device) -> Tensor:
        lo = self.min_range.astype(np.int32)
        span = torch.as_tensor(np.maximum(self.max_range.astype(np.int32) - lo, 1), device=device)
        u = torch.rand(lo.shape, generator=gen, device=device, dtype=torch.float64)
        offset = torch.floor(u * span).to(torch.int32).clamp(max=span - 1)
        return (torch.as_tensor(lo, device=device) + offset).to(torch.int32)

    def sample_eval(self, step: int, device) -> Tensor:
        lo = self.min_range.astype(np.int32)
        n = np.maximum(self.max_range.astype(np.int32) - lo, 1)
        return torch.as_tensor(lo + step % n, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class UniformScalarToVec3Sampler(Sampler):
    """One scalar U(min, max) broadcast to a vec3 (correlated channels, as a
    grey light intensity)."""

    @classmethod
    def create(cls, minimum: float, maximum: float,  # type: ignore[override]
               eval_step_size: float = 0.01, **kw):
        return cls(min_range=np.full((3,), float(minimum), np.float32),
                   max_range=np.full((3,), float(maximum), np.float32),
                   eval_step_size=float(eval_step_size), **kw)

    def sample_train(self, gen, device) -> Tensor:
        lo = torch.as_tensor(self.min_range, device=device)
        hi = torch.as_tensor(self.max_range, device=device)
        return lo + torch.rand((), generator=gen, device=device) * (hi - lo)


@dataclasses.dataclass(frozen=True)
class AnimationSampler(Sampler):
    """Frame-index sampler with separate train/eval frame intervals: train
    draws uniformly from [train_min, train_max), eval sweeps
    [eval_min, eval_max).  Returns an int64 scalar tensor."""

    train_min: int = 0
    train_max: int = 1
    eval_min: int = 0
    eval_max: int = 1

    @classmethod
    def create(cls, train_min: int, train_max: int, eval_min: int,  # type: ignore[override]
               eval_max: int, **kw):
        return cls(min_range=_as_f32(train_min), max_range=_as_f32(train_max),
                   train_min=int(train_min), train_max=int(train_max),
                   eval_min=int(eval_min), eval_max=int(eval_max), **kw)

    def set_train_interval(self, lo: int, hi: int) -> "AnimationSampler":
        return self.replace(train_min=int(lo), train_max=int(hi))

    def set_eval_interval(self, lo: int, hi: int) -> "AnimationSampler":
        return self.replace(eval_min=int(lo), eval_max=int(hi))

    def sample_train(self, gen, device) -> Tensor:
        hi = max(self.train_max, self.train_min + 1)
        return torch.randint(self.train_min, hi, (), generator=gen, device=device)

    def sample_eval(self, step, device) -> Tensor:
        n = max(self.eval_max - self.eval_min, 1)
        return torch.tensor(self.eval_min + step % n, device=device)
