"""NURBS curve evaluation over tensors (port of fireflies_tpu/utils/nurbs.py).

Blender-exported NURBS curves drive camera paths (`entity.Curve`,
`utils.io.import_blender_nurbs_obj`).  Points come from the Cox-de Boor
recursion, vectorized over the control points, in float32 on the device of
the curve parameter; differentiable in it through autograd.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NURBSCurve:
    """A (possibly rational) B-spline curve, held as host numpy:
    control_points (N, 3), weights (N,) (ones for a plain B-spline), knots
    (N + degree + 1,) non-decreasing, and the degree."""

    control_points: np.ndarray
    weights: np.ndarray
    knots: np.ndarray
    degree: int = 3

    @classmethod
    def create(cls, control_points, knots, degree: int, weights=None) -> "NURBSCurve":
        cp = np.asarray(control_points, np.float32)
        if weights is None:
            weights = np.ones((cp.shape[0],), np.float32)
        return cls(control_points=cp, weights=np.asarray(weights, np.float32),
                   knots=np.asarray(knots, np.float32), degree=int(degree))

    def _tensor(self, x: np.ndarray, like: Tensor) -> Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=like.device)

    def _basis(self, u: Tensor) -> Tensor:
        """Every nonrational basis function N_{i,p}(u), shape (N,)."""
        n_ctrl = self.control_points.shape[0]
        p = self.degree
        knots = self._tensor(self.knots, u)
        # u clamped strictly inside the domain, so that the half-open basis
        # intervals hold at its right end.
        lo, hi = knots[p], knots[n_ctrl]
        u = torch.minimum(torch.maximum(u, lo), hi - 1e-6 * (hi - lo))
        basis = ((u >= knots[:-1]) & (u < knots[1:])).to(torch.float32)
        for d in range(1, p + 1):
            left_den = knots[d:-1] - knots[: -d - 1]
            right_den = knots[d + 1:] - knots[1:-d]
            left_den = torch.where(left_den == 0, 1.0, left_den)
            right_den = torch.where(right_den == 0, 1.0, right_den)
            left = (u - knots[: -d - 1]) / left_den * basis[:-1]
            right = (knots[d + 1:] - u) / right_den * basis[1:]
            basis = left + right
        return basis[:n_ctrl]

    def evaluate(self, t) -> Tensor:
        """The point (3,) at the normalized parameter t in [0, 1]."""
        u = self._param(t)
        basis = self._basis(u) * self._tensor(self.weights, u)
        denom = basis[0]
        for b in basis[1:]:  # summed in order, as the reference's reduction
            denom = denom + b
        denom = torch.where(denom == 0, 1.0, denom)
        return (basis @ self._tensor(self.control_points, u)) / denom

    def tangent(self, t, eps: float = 1e-4) -> Tensor:
        """The unit tangent (3,) at t, by central differences."""
        t = torch.clamp(torch.as_tensor(t, dtype=torch.float32), eps, 1.0 - eps)
        d = self.evaluate(t + eps) - self.evaluate(t - eps)
        return d / (torch.linalg.vector_norm(d) + 1e-20)

    def evaluate_many(self, ts) -> Tensor:
        """(K,) parameters -> (K, 3) points."""
        return torch.stack([self.evaluate(t) for t in torch.as_tensor(ts, dtype=torch.float32)])

    def _param(self, t) -> Tensor:
        t = torch.as_tensor(t, dtype=torch.float32)
        knots = self._tensor(self.knots, t)
        lo, hi = knots[self.degree], knots[self.control_points.shape[0]]
        return lo + t * (hi - lo)
