"""Port parity for the native host library (`fireflies_tpu_torch/native`)
against the JAX package's (`fireflies_tpu.native`), bit for bit:

  * `bridson` (the library's and `sampling.bridson`'s default path) on a
    constant, a varying and a SMARTY-like radius map at seeds 0, 3 and
    None: the same count and the same coordinates;
  * `parse_obj` on an OBJ with quads, an n-gon, uvs, normals and negative
    indices, and on one whose faces lack uvs; `connected_components` on a
    few masks; `morton_order` on 5000 centroids (and on ties): equal, and
    equal to the plain versions beside their callers;
  * FIREFLIES_NO_NATIVE=1: `sampling.bridson` gives `_bridson_numpy`'s
    points in both packages, and the other callers their plain versions;
  * a missing compiler, or one that fails, raises (no quiet fallback).
"""

import sys

import numpy as np
import pytest
import torch

from fireflies_tpu import native as jx_native
from fireflies_tpu import sampling as jx_sampling
from fireflies_tpu.sampling import poisson as jx_poisson
from fireflies_tpu.utils import io as jx_io
from fireflies_tpu_torch import datagen, native, sampling
from fireflies_tpu_torch.render.cuda import intersect_kernel
from fireflies_tpu_torch.sampling import poisson
from fireflies_tpu_torch.utils import io

torch.set_num_threads(1)

OBJ = """# quads, an n-gon, uvs, normals and negative indices
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 1.0 1.0 0.0
v 0.0 1.0 0.0
v 0.5 1.5 0.25
v -0.125 0.75 -1e-3
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
vt 0.5 0.5
vn 0.0 0.0 1.0
vn 0.0 1.0 0.0
f 1/1/1 2/2/1 3/3/1 4/4/1
f 4/4/2 3/3/2 5/5/2
f 1/1/1 3/3/1 5/5/2 6/1/2 4/4/2
f -1/1/1 -2/2/1 -3/3/1
"""

OBJ_NO_UVS = """v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0.25 0.75
f 1 2 3 4
f 1/1 3/1 4/1
"""


def _radius_maps() -> dict:
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[0:48, 0:64]
    varying = (2.0 + 4.0 * (0.5 + 0.5 * np.sin(xx / 9.0) * np.cos(yy / 7.0))
               + rng.uniform(0, 0.3, (48, 64))).astype(np.float32)
    # SMARTY's: min + (max - min) * (1 - normalized variance) on a 128x32
    # film, radii 2 to 8 px.
    var = np.abs(np.sin(np.mgrid[0:32, 0:128][1] / 11.0)) * rng.uniform(0.5, 1.0, (32, 128))
    inv = 1.0 - (var - var.min()) / (var.max() - var.min())
    smarty = (2.0 + 6.0 * inv).astype(np.float32)
    return {"constant": np.full((64, 64), 4.0, np.float32), "varying": varying,
            "smarty": smarty}


def test_bridson_matches_jax_native():
    for name, radius_map in _radius_maps().items():
        for seed in (0, 3, None):
            n_ref, pts_ref = jx_native.bridson(radius_map, 30, seed or 0)
            n, pts = native.bridson(radius_map, 30, seed or 0)
            assert n == n_ref > 20, (name, seed)
            np.testing.assert_array_equal(pts, pts_ref)
            n, pts = sampling.bridson(radius_map, k=50, seed=seed)
            n_ref, pts_ref = jx_sampling.bridson(radius_map, k=50, seed=seed)
            assert n == n_ref > 20 and pts.dtype == pts_ref.dtype == np.float64, (name, seed)
            np.testing.assert_array_equal(pts, pts_ref)
    # Why the port needs the library: numpy's stream places other points.
    radius_map = _radius_maps()["constant"]
    assert native.bridson(radius_map, 30, 0)[0] == 180
    assert poisson._bridson_numpy(radius_map, 30, 0)[0] == 166


def _same_mesh(got: dict, ref: dict) -> None:
    assert got.keys() == ref.keys()
    for key in ref:
        if ref[key] is None:
            assert got[key] is None, key
        else:
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key])


def test_parse_obj_components_and_morton_match(tmp_path):
    for i, text in enumerate((OBJ, OBJ_NO_UVS)):
        path = tmp_path / f"mesh{i}.obj"
        path.write_text(text)
        got = native.parse_obj(str(path))
        _same_mesh(got, jx_native.parse_obj(str(path)))
        _same_mesh(io.load_obj(path), got)
        _same_mesh(io._load_obj_python(path), jx_io._load_obj_python(path))
    assert native.parse_obj(str(tmp_path / "mesh0.obj"))["faces"].shape == (7, 3)
    with pytest.raises(FileNotFoundError):
        native.parse_obj(str(tmp_path / "missing.obj"))

    rng = np.random.default_rng(3)
    checker = (np.add.outer(np.arange(9), np.arange(11)) % 2).astype(bool)
    masks = [rng.random((40, 56)) > 0.6, np.zeros((8, 8), bool), np.ones((5, 7), bool), checker]
    for mask in masks:
        n = native.connected_components(mask)
        assert n == jx_native.connected_components(mask) == datagen.connected_components(mask)
        assert n == datagen.connected_components_plain(mask)
    assert native.connected_components(checker) == int(checker.sum())  # isolated cells

    centroids = rng.normal(size=(5000, 3)).astype(np.float32)
    ties = np.repeat(centroids[:40], 3, axis=0)
    for c in (centroids, ties, centroids.astype(np.float64)):
        order = native.morton_order(c)
        assert order.dtype == np.int32
        np.testing.assert_array_equal(order, jx_native.morton_order(c))
        np.testing.assert_array_equal(order, intersect_kernel.morton_order(c))


def test_no_native_takes_the_plain_versions(monkeypatch, tmp_path):
    radius_map = _radius_maps()["varying"]
    monkeypatch.setenv("FIREFLIES_NO_NATIVE", "1")
    # The JAX package reads the variable when its native module is
    # imported: import it afresh (it then fails, and its callers fall back).
    monkeypatch.delitem(sys.modules, "fireflies_tpu.native", raising=False)
    before = dict(native.calls)
    for seed in (0, 3):
        n, pts = sampling.bridson(radius_map, k=30, seed=seed)
        n_np, pts_np = poisson._bridson_numpy(radius_map, k=30, seed=seed)
        n_ref, pts_ref = jx_sampling.bridson(radius_map, k=30, seed=seed)
        n_ref_np, pts_ref_np = jx_poisson._bridson_numpy(radius_map, k=30, seed=seed)
        assert n == n_np == n_ref == n_ref_np > 40
        np.testing.assert_array_equal(pts, pts_np)
        np.testing.assert_array_equal(pts, pts_ref)
        np.testing.assert_array_equal(pts, pts_ref_np)
    path = tmp_path / "mesh.obj"
    path.write_text(OBJ_NO_UVS)
    _same_mesh(io.load_obj(path), jx_io.load_obj(path))
    mask = np.random.default_rng(4).random((30, 30)) > 0.5
    assert datagen.connected_components(mask) == datagen.connected_components_plain(mask)
    assert native.calls == before  # the library was not called


def test_missing_or_failing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("FIREFLIES_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    radius_map = np.full((16, 16), 3.0, np.float32)
    try:
        for cxx, message in (("no-such-compiler-for-fireflies", "not found"),
                             ("false", "failed")):
            monkeypatch.setattr(native, "CXX", cxx)
            native.load_library.cache_clear()
            with pytest.raises(RuntimeError, match=message):
                sampling.bridson(radius_map, seed=1)
            with pytest.raises(RuntimeError, match=message):
                native.morton_order(np.zeros((4, 3), np.float32))
        assert not list((tmp_path / "build").glob("*.so"))
        # The plain versions need no compiler.
        monkeypatch.setenv("FIREFLIES_NO_NATIVE", "1")
        assert sampling.bridson(radius_map, seed=1)[0] == poisson._bridson_numpy(
            radius_map, seed=1)[0]
    finally:
        native.load_library.cache_clear()
