"""Seeds for runs that draw anew at every step (optimizer steps, dataset
frames).

Where the reference splits a JAX key per step, step i of a run seeded
`seed` draws from generators seeded by numpy's SeedSequence of (seed, i),
so any step's draws can be made again without running the steps before
it.
"""

from __future__ import annotations

import numpy as np
import torch


def step_seeds(seed: int, step: int, n: int) -> list[int]:
    """n independent 64-bit seeds of step `step` of a run seeded `seed`."""
    return [int(s) for s in np.random.SeedSequence([seed, step]).generate_state(n, np.uint64)]


def step_generators(seed: int, step: int, n: int, device) -> list[torch.Generator]:
    """One torch.Generator on `device` per seed of step_seeds(seed, step, n)."""
    return [torch.Generator(device=device).manual_seed(s) for s in step_seeds(seed, step, n)]
