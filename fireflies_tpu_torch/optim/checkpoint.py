"""Checkpoint / resume for long-running optimization and dataset jobs
(port of fireflies_tpu/optim/checkpoint.py).

A state is a tree of dicts, lists, tuples and named tuples over tensors,
arrays and numbers (parameters, optimizer moments, step).  It round-trips
through one compressed .npz whose keys are the leaves' paths in the JAX
package's spelling (`['params']`, `[0]`, `.field`, joined by the unit
separator; dict keys sorted), so a checkpoint written by either package
loads in the other.  None is an empty subtree, as in JAX.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

SEP = "\x1f"  # unit separator: safe key-path delimiter


def _map(tree, fn, path=()):
    """`tree` rebuilt with each leaf replaced by fn(key path, leaf), visited
    in the JAX package's order (dict keys sorted); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(tree[k], fn, path + (f"[{k!r}]",)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(getattr(tree, n), fn, path + (f".{n}",)) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(x, fn, path + (f"[{i}]",)) for i, x in enumerate(tree))
    return fn(SEP.join(path), tree)


def save_checkpoint(path: str | Path, state) -> None:
    """Save a tree of arrays (params / optimizer state / step ...)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}

    def put(key, leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        flat[key] = np.asarray(leaf)

    _map(state, put)
    np.savez_compressed(path, **flat)


def load_checkpoint(path: str | Path, like):
    """Restore into the structure of `like` (the tree that was saved, or one
    of the same shape): each leaf a tensor of the `like` leaf's dtype, on
    its device for a tensor, else on the CPU."""
    with np.load(Path(path), allow_pickle=False) as data:

        def get(key, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(data[key], dtype=leaf.dtype, device=leaf.device)
            return torch.as_tensor(data[key].astype(np.asarray(leaf).dtype, copy=False))

        return _map(like, get)


def latest_checkpoint(directory: str | Path, pattern: str = "*.npz") -> Path | None:
    paths = sorted(Path(directory).glob(pattern))
    return paths[-1] if paths else None
