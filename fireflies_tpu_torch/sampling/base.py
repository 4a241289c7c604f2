"""Sampler protocol (port of fireflies_tpu/sampling/base.py).

A sampler holds its interval as host numpy and draws with
``sample(gen, step, train, device)``:

* ``train=True``  -> stochastic draw from the explicit ``torch.Generator``;
* ``train=False`` -> deterministic sweep ``min + (step % n_steps) * eval_step``
  (wraps past ``max``; returns the constant when min == max).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


def _as_f32(x) -> np.ndarray:
    arr = np.asarray(x, np.float32)
    if arr.ndim == 0:
        arr = arr[None]
    return arr


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Base sampler: uniform-interval state + eval-sweep semantics."""

    min_range: np.ndarray
    max_range: np.ndarray
    eval_step_size: float = 0.01

    @classmethod
    def create(cls, minimum, maximum, eval_step_size: float = 0.01, **kw):
        return cls(min_range=_as_f32(minimum), max_range=_as_f32(maximum),
                   eval_step_size=float(eval_step_size), **kw)

    def replace(self, **kw) -> "Sampler":
        return dataclasses.replace(self, **kw)

    def set_sample_interval(self, minimum, maximum) -> "Sampler":
        return self.replace(min_range=_as_f32(minimum), max_range=_as_f32(maximum))

    def set_index_interval(self, index: int, minimum: float, maximum: float) -> "Sampler":
        mn = np.array(self.min_range, np.float32)
        mx = np.array(self.max_range, np.float32)
        mn[index] = minimum
        mx[index] = maximum
        return self.replace(min_range=mn, max_range=mx)

    def sample(self, gen: torch.Generator, step: int = 0, train: bool = True,
               device=None) -> Tensor:
        device = gen.device if device is None else device
        if train:
            return self.sample_train(gen, device)
        return self.sample_eval(int(step), device)

    def sample_train(self, gen: torch.Generator, device) -> Tensor:
        raise NotImplementedError

    def sample_eval(self, step: int, device) -> Tensor:
        """Deterministic sweep min -> max with wraparound (float32 math as
        in the reference: n_steps = floor(min_span / step) + 1)."""
        lo = torch.as_tensor(self.min_range, device=device)
        span = torch.as_tensor(self.max_range, device=device) - lo
        step_size = torch.tensor(self.eval_step_size, dtype=torch.float32, device=device)
        n_steps = max(int(torch.floor(span.min() / step_size)) + 1, 1)
        frac = torch.tensor(float(step % n_steps), dtype=torch.float32,
                            device=device) * step_size
        return torch.where(span == 0.0, lo, lo + frac)

    @property
    def shape(self) -> tuple:
        return self.min_range.shape

    def get_min(self) -> np.ndarray:
        return self.min_range

    def get_max(self) -> np.ndarray:
        return self.max_range


@dataclasses.dataclass(frozen=True)
class ConstantSampler(Sampler):
    """Always returns ``min_range`` (non-randomized attributes, and static
    arrays such as a texture registered under an attribute key)."""

    # The value on each device it was asked for, moved there once: a
    # texture held as a constant is not copied again on every draw.
    _on_device: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                         compare=False)

    @classmethod
    def of(cls, value) -> "ConstantSampler":
        v = _as_f32(value)
        return cls(min_range=v, max_range=v)

    def _value(self, device) -> Tensor:
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = torch.as_tensor(self.min_range, device=device)
        return self._on_device[device]

    def sample_train(self, gen, device) -> Tensor:
        return self._value(device)

    def sample_eval(self, step: int, device) -> Tensor:
        return self._value(device)
