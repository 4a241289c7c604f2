"""Colormaps for debug images (numpy; the same anchors as
fireflies_tpu/utils/colormap.py)."""

from __future__ import annotations

import numpy as np

# Piecewise-linear approximation of matplotlib's inferno (8 anchors).
_INFERNO = np.asarray(
    [
        [0.001, 0.000, 0.014],
        [0.159, 0.044, 0.329],
        [0.397, 0.083, 0.433],
        [0.623, 0.165, 0.388],
        [0.832, 0.283, 0.257],
        [0.961, 0.490, 0.084],
        [0.981, 0.755, 0.153],
        [0.988, 0.998, 0.645],
    ],
    np.float32,
)


def apply_colormap(values, colormap: np.ndarray = _INFERNO) -> np.ndarray:
    """(H, W) values in [0, 1] -> (H, W, 3) float RGB."""
    v = np.clip(np.asarray(values, np.float32), 0.0, 1.0)
    n = len(colormap) - 1
    x = v * n
    i = np.clip(x.astype(np.int32), 0, n - 1)
    f = (x - i)[..., None]
    return colormap[i] * (1 - f) + colormap[i + 1] * f


def inferno(values) -> np.ndarray:
    return apply_colormap(values, _INFERNO)
