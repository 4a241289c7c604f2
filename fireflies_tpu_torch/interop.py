"""Carry randomized parameters across from the JAX package.

The two packages draw different random streams, so to render the same
scene variant in both, take the flat param dict the JAX `randomize`
produced (converted to numpy by the caller) and hand it to this package's
`SceneBridge.assemble`.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_params(params: dict, device="cuda") -> dict:
    """{key: numpy array} (e.g. 'mesh-Vocalfold.vertex_positions' (625, 3),
    'mat-Mucosa.roughness' (), 'tex.beams' (144, 2)) -> {key: float32
    tensor on `device`} (the card unless the caller asks for the CPU).
    Tuples such as 'tex.beam_hw' pass through."""
    out = {}
    for key, value in params.items():
        if isinstance(value, tuple):
            out[key] = value
        else:
            out[key] = torch.tensor(np.asarray(value, np.float32), device=device)
    return out
