"""Blue-noise point generation (port of fireflies_tpu/sampling/poisson.py).

* ``bridson(radius_map, k, seed, radius_type)``: Bridson (2007)
  Poisson-disk sampling with a per-pixel radius map, on the host.  It is
  inherently sequential and runs once, at pattern initialization.  As in
  the JAX package, the "default" radius type takes the native library
  (`native.bridson`, std::mt19937_64 seeded ``seed or 0``), so its points
  are the JAX package's default points, bit for bit; "normDist", and
  every radius type under FIREFLIES_NO_NATIVE=1, takes the numpy version
  (`_bridson_numpy`, numpy's generator seeded ``seed``), the JAX package's
  numpy path's points, bit for bit.

* ``dart_throwing(gen, n_points, radius, ...)``: fixed-size approximate
  blue noise: uniform candidates accepted greedily, in order, when at least
  ``radius`` from every point accepted before.
"""

from __future__ import annotations

import numpy as np
import torch

from fireflies_tpu_torch import native

Tensor = torch.Tensor


def bridson(radius_map: np.ndarray, k: int = 30, seed: int | None = None,
            radius_type: str = "default") -> tuple[int, np.ndarray]:
    """Poisson-disk sampling over [0, H) x [0, W) with per-pixel radii.

    Args:
      radius_map: (H, W) minimum distance at each location; a constant map
        gives classic Poisson-disk sampling.
      k: candidate attempts around an active point.
      seed: the seed (None: 0 on the native path, fresh entropy on numpy's).
      radius_type: "default" draws a candidate's distance from U(r, 2r)
        (the native library unless FIREFLIES_NO_NATIVE is set);
        "normDist" from N(1.5 r, 0.2 r), a more regular spacing (numpy).

    Returns:
      (n, coords): the number of points and an (n, 2) float64 array of
      (y, x).
    """
    if radius_type not in ("default", "normDist"):
        raise ValueError(f"radius_type must be 'default' or 'normDist', got {radius_type!r}")
    if radius_type == "default" and native.enabled():
        return native.bridson(np.asarray(radius_map, np.float32), k, seed or 0)
    return _bridson_numpy(radius_map, k, seed, radius_type)


def _bridson_numpy(radius_map: np.ndarray, k: int = 30, seed: int | None = None,
                   radius_type: str = "default") -> tuple[int, np.ndarray]:
    """bridson's plain version, from np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    radius_map = np.asarray(radius_map, np.float64)
    height, width = radius_map.shape
    r_min = max(float(radius_map.min()), 1e-3)

    # Background grid sized by the smallest radius: a cell holds <= 1 point.
    cell = r_min / np.sqrt(2.0)
    gh = int(np.ceil(height / cell)) + 1
    gw = int(np.ceil(width / cell)) + 1
    grid = -np.ones((gh, gw), np.int64)

    points: list[np.ndarray] = []
    active: list[int] = []

    def grid_idx(p):
        return int(p[0] // cell), int(p[1] // cell)

    def fits(p, radius):
        gy, gx = grid_idx(p)
        # Scan as far as this point's own radius reaches.
        reach = int(np.ceil(radius / cell)) + 1
        y0, y1 = max(gy - reach, 0), min(gy + reach + 1, gh)
        x0, x1 = max(gx - reach, 0), min(gx + reach + 1, gw)
        neighbors = grid[y0:y1, x0:x1]
        idx = neighbors[neighbors >= 0]
        if idx.size == 0:
            return True
        pts = np.stack([points[i] for i in idx])
        d2 = np.sum((pts - p) ** 2, axis=1)
        return bool(np.all(d2 >= radius * radius))

    def insert(p):
        points.append(p)
        gy, gx = grid_idx(p)
        grid[gy, gx] = len(points) - 1
        active.append(len(points) - 1)

    insert(np.array([rng.uniform(0, height), rng.uniform(0, width)]))

    while active:
        pick = rng.integers(len(active))
        base = points[active[pick]]
        by = min(int(base[0]), height - 1)
        bx = min(int(base[1]), width - 1)
        radius = max(float(radius_map[by, bx]), r_min)

        placed = False
        for _ in range(k):
            if radius_type == "normDist":
                rho = radius * rng.normal(1.5, 0.2)
            else:
                rho = rng.uniform(radius, 2 * radius)
            theta = rng.uniform(0, 2 * np.pi)
            cand = base + rho * np.array([np.sin(theta), np.cos(theta)])
            if not (0 <= cand[0] < height and 0 <= cand[1] < width):
                continue
            cand_r = max(float(radius_map[int(cand[0]), int(cand[1])]), r_min)
            if fits(cand, cand_r):
                insert(cand)
                placed = True
                break
        if not placed:
            active.pop(pick)

    coords = np.stack(points) if points else np.zeros((0, 2))
    return len(points), coords


def dart_throwing(gen: torch.Generator | None, n_points: int, radius: float,
                  extent: tuple[float, float] = (1.0, 1.0), oversample: int = 8,
                  candidates: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Approximate blue noise of fixed size.

    Draws ``n_points * oversample`` uniform candidates in [0, extent) from
    `gen` (or takes `candidates`, (n_points * oversample, 2), already
    scaled), then accepts them in order while fewer than n_points are
    accepted, each when its squared distance (float32) to every accepted
    point is at least radius^2.  The greedy pass is sequential and runs on
    the host (a few thousand candidates).

    Returns:
      (points, valid): (n_points, 2) float32 on the candidates' device and
      an (n_points,) bool mask; invalid slots repeat the first point.
    """
    if candidates is None:
        ext = torch.tensor(extent, dtype=torch.float32, device=gen.device)
        candidates = torch.rand((n_points * oversample, 2), generator=gen,
                                device=gen.device) * ext
    cands = candidates.detach().cpu().numpy().astype(np.float32)
    r2 = np.float32(radius * radius)
    accepted = np.zeros((n_points, 2), np.float32)
    count = 0
    for cand in cands:
        if count == n_points:
            break
        diff = accepted[:count] - cand
        # With nothing accepted yet the nearest distance is 1e9, as in JAX.
        min_d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]).min() if count else 1e9
        if min_d2 >= r2:
            accepted[count] = cand
            count += 1
    valid = np.arange(n_points) < count
    accepted = np.where(valid[:, None], accepted, accepted[0][None, :])
    device = candidates.device
    return torch.from_numpy(accepted).to(device), torch.from_numpy(valid).to(device)
