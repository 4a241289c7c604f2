"""Procedural Perlin texture randomization (port of
fireflies_tpu/sampling/noise_texture_lerp.py).

`NoiseTextureLerpSampler` draws a base lattice resolution among 2, 4, ...,
64 (clamped to half the texture), 1-4 octaves and a persistence U(0.1, 2),
sums the octaves' Perlin layers, min-max normalizes the sum and lerps
color_a -> color_b into a (3, H, W) texture.  Every candidate resolution's
layer is computed and the octaves pick theirs with weights, so a draw
needs no host readback.  The draws can be injected (`angles=`,
`NoiseTextureLerpSampler.texture`) to reproduce another stream's texture.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fireflies_tpu_torch.sampling.base import Sampler

Tensor = torch.Tensor

RES_EXPONENTS = (1, 2, 3, 4, 5, 6)  # resolutions 2, 4, ..., 64
MAX_OCTAVES = 4


def _fade(t: Tensor) -> Tensor:
    t2 = t * t
    t4 = t2 * t2
    return 6 * (t * t4) - 15 * t4 + 10 * (t * t2)


def rand_perlin_2d(gen, shape: tuple[int, int], res: tuple[int, int], angles=None,
                   device=None) -> Tensor:
    """Single-octave Perlin noise on an (H, W) grid; `res` must divide
    `shape`.  The lattice's gradient angles (ry + 1, rx + 1) are 2 pi U(0, 1)
    from `gen`, or `angles` when given."""
    h, w = shape
    ry, rx = res
    dy, dx = h // ry, w // rx
    assert dy > 0 and dx > 0, f"res {res} exceeds shape {shape}"
    if angles is None:
        device = gen.device if device is None else device
        angles = 2 * math.pi * torch.rand((ry + 1, rx + 1), generator=gen, device=device)
    angles = torch.as_tensor(angles, dtype=torch.float32, device=device)
    gradients = torch.stack([torch.cos(angles), torch.sin(angles)], dim=-1)

    # Fractional coordinates within each lattice cell.
    fy = ((torch.arange(h, dtype=torch.float32, device=angles.device) % dy) / dy)[:, None]
    fx = ((torch.arange(w, dtype=torch.float32, device=angles.device) % dx) / dx)[None, :]

    def corner(g: Tensor, off_y: float, off_x: float) -> Tensor:
        g = g.repeat_interleave(dy, 0).repeat_interleave(dx, 1)[:h, :w]
        return g[..., 0] * (fy + off_y) + g[..., 1] * (fx + off_x)

    n00 = corner(gradients[:-1, :-1], 0.0, 0.0)
    n10 = corner(gradients[1:, :-1], -1.0, 0.0)
    n01 = corner(gradients[:-1, 1:], 0.0, -1.0)
    n11 = corner(gradients[1:, 1:], -1.0, -1.0)
    ty, tx = _fade(fy), _fade(fx)

    def lerp(a, b, t):
        return a + t * (b - a)

    return math.sqrt(2.0) * lerp(lerp(n00, n10, ty), lerp(n01, n11, ty), tx)


def rand_perlin_2d_octaves(gen, shape: tuple[int, int], res: tuple[int, int], octaves: int = 1,
                           persistence: float = 0.5, angles=None, device=None) -> Tensor:
    """Octave k at resolution res * 2^k (clamped to half the shape) and
    amplitude persistence^k, summed; `angles` (one array per octave)
    injects the draws."""
    noise = None
    amplitude = 1.0
    ry, rx = res
    for k in range(octaves):
        cry = min(ry * 2**k, max(shape[0] // 2, 1))
        crx = min(rx * 2**k, max(shape[1] // 2, 1))
        layer = amplitude * rand_perlin_2d(gen, shape, (cry, crx),
                                           None if angles is None else angles[k], device)
        noise = layer if noise is None else noise + layer
        amplitude *= persistence
    return noise


@dataclasses.dataclass(frozen=True)
class NoiseTextureLerpSampler(Sampler):
    """A random Perlin-blended texture between two colours; (3, H, W).  Eval
    mode draws from a generator seeded with the step."""

    color_a: np.ndarray = None
    color_b: np.ndarray = None
    texture_shape: tuple = (256, 256)

    @classmethod
    def create(cls, color_a, color_b, texture_shape,  # type: ignore[override]
               eval_step_size: float = 0.01, **kw):
        return cls(min_range=np.zeros((1,), np.float32), max_range=np.ones((1,), np.float32),
                   eval_step_size=float(eval_step_size),
                   color_a=np.asarray(color_a, np.float32), color_b=np.asarray(color_b, np.float32),
                   texture_shape=tuple(int(s) for s in texture_shape), **kw)

    def resolutions(self) -> list[int]:
        """The candidate lattice resolutions, clamped to half the texture
        (at a texel's spacing every fractional coordinate is 0 and the noise
        vanishes)."""
        max_res = max(min(self.texture_shape) // 2, 1)
        return [min(2**e, max_res) for e in RES_EXPONENTS]

    def texture(self, base_idx, octaves, persistence, angles, device) -> Tensor:
        """The texture of given draws: the base resolution's index (of
        `resolutions()`), the octave count, the persistence and each
        resolution's gradient angles ((r + 1, r + 1) each)."""
        stack = torch.stack([rand_perlin_2d(None, self.texture_shape, (r, r), a, device)
                             for r, a in zip(self.resolutions(), angles)])
        rel = torch.arange(len(RES_EXPONENTS), device=device) - torch.as_tensor(base_idx,
                                                                                 device=device)
        active = (rel >= 0) & (rel < torch.as_tensor(octaves, device=device))
        persistence = torch.as_tensor(persistence, dtype=torch.float32, device=device)
        weights = torch.where(active, persistence ** rel.to(torch.float32), 0.0)
        tex = torch.einsum("i,ihw->hw", weights, stack)
        lo, hi = tex.min(), tex.max()
        tex = (tex - lo) / torch.where(hi - lo == 0, 1.0, hi - lo)
        ca = torch.as_tensor(self.color_a, device=device)[:, None, None]
        cb = torch.as_tensor(self.color_b, device=device)[:, None, None]
        return ca + tex[None] * (cb - ca)

    def sample_train(self, gen, device) -> Tensor:
        base_idx = torch.randint(0, len(RES_EXPONENTS), (), generator=gen, device=device)
        octaves = torch.randint(1, MAX_OCTAVES + 1, (), generator=gen, device=device)
        persistence = 0.1 + 1.9 * torch.rand((), generator=gen, device=device)
        angles = [2 * math.pi * torch.rand((r + 1, r + 1), generator=gen, device=device)
                  for r in self.resolutions()]
        return self.texture(base_idx, octaves, persistence, angles, device)

    def sample_eval(self, step: int, device) -> Tensor:
        return self.sample_train(torch.Generator(device=device).manual_seed(int(step)), device)
