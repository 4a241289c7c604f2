"""Concrete samplers used by the ported scenes (port of
fireflies_tpu/sampling/samplers.py; the Gaussian, integer and
scalar-to-vec3 samplers are not ported yet)."""

from __future__ import annotations

import dataclasses

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

    def sample_train(self, gen, device) -> Tensor:
        hi = max(self.train_max, self.train_min + 1)
        return torch.randint(self.train_min, hi, (), generator=gen, device=device)

    def sample_eval(self, step, device) -> Tensor:
        n = max(self.eval_max - self.eval_min, 1)
        return torch.tensor(self.eval_min + step % n, device=device)
