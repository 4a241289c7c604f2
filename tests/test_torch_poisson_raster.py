"""Port parity for the blue-noise samplers (`sampling/poisson.py`) and the
rest of the rasterizers (`graphics/rasterization.py`):

  * `bridson`'s numpy version (`_bridson_numpy`) with both radius types
    equals the JAX package's bit for bit on a varying radius map, and so
    does `bridson` itself, each package's default (the native library for
    "default", numpy for "normDist");
  * `dart_throwing` fed the JAX package's candidates accepts the same
    points (equal) and the same valid mask;
  * `rasterize_lines`, `rasterize_depth`, `rasterize_points_in_non_ndc`,
    `sum_` and `subsampled_point_raster` within 1e-6 of each image's max.
"""

import jax
import numpy as np
import pytest
import torch

from fireflies_tpu.graphics import rasterization as jx_raster
from fireflies_tpu.sampling import poisson as jx_poisson
from fireflies_tpu_torch import graphics as tc_graphics
from fireflies_tpu_torch import sampling as tc_sampling
from fireflies_tpu_torch.sampling import poisson as tc_poisson

torch.set_num_threads(1)


@pytest.mark.parametrize("radius_type", ["default", "normDist"])
def test_bridson_matches_numpy_path(radius_type):
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:48, 0:64]
    radius_map = (2.0 + 4.0 * (0.5 + 0.5 * np.sin(xx / 9.0) * np.cos(yy / 7.0))
                  + rng.uniform(0, 0.3, (48, 64))).astype(np.float32)
    n, pts = tc_poisson._bridson_numpy(radius_map, k=30, seed=3, radius_type=radius_type)
    n_ref, pts_ref = jx_poisson._bridson_numpy(radius_map, k=30, seed=3,
                                               radius_type=radius_type)
    assert n == n_ref > 40 and pts.shape == (n, 2)
    np.testing.assert_array_equal(pts, pts_ref)
    n, pts = tc_sampling.bridson(radius_map, k=30, seed=3, radius_type=radius_type)
    n_ref, pts_ref = jx_poisson.bridson(radius_map, k=30, seed=3, radius_type=radius_type)
    assert n == n_ref > 40 and pts.shape == (n, 2)
    np.testing.assert_array_equal(pts, pts_ref)
    with pytest.raises(ValueError):
        tc_sampling.bridson(radius_map, radius_type="gaussian")


def test_dart_throwing_with_injected_candidates():
    n_points, oversample, radius, extent = 40, 8, 0.14, (1.0, 0.75)
    key = jax.random.key(11)
    # The JAX sampler's own candidates (poisson.py: uniform * extent).
    cands = np.array(jax.random.uniform(key, (n_points * oversample, 2))
                       * np.asarray(extent, np.float32))
    ref_pts, ref_valid = jx_poisson.dart_throwing(key, n_points, radius, extent, oversample)
    pts, valid = tc_sampling.dart_throwing(None, n_points, radius, extent, oversample,
                                           candidates=torch.from_numpy(cands))
    assert 10 < int(valid.sum()) < n_points  # some slots stay invalid
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_pts))
    drawn, drawn_valid = tc_sampling.dart_throwing(torch.Generator().manual_seed(0), n_points,
                                                   radius, extent, oversample)
    assert drawn.shape == (n_points, 2) and bool(drawn_valid.any())
    assert float(drawn[:, 0].max()) < 1.0 and float(drawn[:, 1].max()) < 0.75


def _close(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape and np.abs(ref).max() > 0
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_rasterizers_match():
    rng = np.random.default_rng(2)
    size = (40, 56)
    lines = rng.uniform(0.05, 0.95, (5, 2, 2)).astype(np.float32)
    lines[4, 1] = lines[4, 0]  # a degenerate segment: a point
    pts01 = rng.uniform(0.0, 1.0, (7, 2)).astype(np.float32)
    pts_px = (pts01 * np.asarray([size[1], size[0]], np.float32)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, 7).astype(np.float32)
    t = torch.from_numpy
    _close(tc_graphics.rasterize_lines(t(lines), 30.0, size),
           jx_raster.rasterize_lines(lines, 30.0, size))
    _close(tc_graphics.rasterize_depth(t(pts01), t(depth), 15.0, size),
           jx_raster.rasterize_depth(pts01, depth, 15.0, size))
    stack = tc_graphics.rasterize_points_in_non_ndc(t(pts_px), 20.0, size)
    _close(stack, jx_raster.rasterize_points_in_non_ndc(pts_px, 20.0, size))
    _close(tc_graphics.sum_(stack, axis=0), jx_raster.sum_(np.asarray(stack), axis=0))
    assert tc_graphics.rasterization.sum is tc_graphics.sum_
    pyramid = tc_graphics.subsampled_point_raster(t(pts01), 3, 40.0, size)
    ref_pyramid = jx_raster.subsampled_point_raster(pts01, 3, 40.0, size)
    assert [p.shape for p in pyramid] == [(40, 56), (20, 28), (10, 14)]
    for got, ref in zip(pyramid, ref_pyramid):
        _close(got, ref)
