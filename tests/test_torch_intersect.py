"""Port parity: the plain PyTorch versions of B3 and B1, the two CUDA
intersection kernels of the main path, against the JAX Pallas kernels
(interpret mode on the CPU) and against the brute-force scans.  The scans
and the wrappers' contracts are in tests/test_torch_intersect_scans.py, the
packing helpers and tile lists in tests/test_torch_intersect_packing.py.

Tolerances: t within 1e-5 relative; prim exact except where two faces
give the same t within 1e-5 (the kernels and the scans break such ties in
different orders); any-hit compares the blocked mask exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fireflies_tpu.render.intersect as jx_intersect
from fireflies_tpu.render.pallas import intersect_culled as jx_culled
from fireflies_tpu.render.pallas import intersect_kernel as jx_kernel
from fireflies_tpu.render.types import Geometry as JxGeometry
from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel
from fireflies_tpu_torch.render.types import Geometry

torch.set_num_threads(1)

N_RAYS = 4096  # two 2048-ray tiles
ORIGIN = np.array([0.0, 0.5, 4.0], np.float32)


def _scene(seed, n_verts=400, n_faces=300, n_variants=2):
    """Random triangle soup with per-variant vertices, rays and per-ray
    tmax: tile 0 mixes dead rays (tmax = -1) into live ones."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_verts, 3)).astype(np.float32)
    verts = np.stack([base * (1.0 + 0.1 * i) + 0.05 * i for i in range(n_variants)])
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    o = (rng.normal(size=(n_variants, N_RAYS, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(n_variants, N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(1.0, 8.0, size=(n_variants, N_RAYS)).astype(np.float32)
    tmax[:, : N_RAYS // 2][:, ::5] = -1.0
    return verts, faces, o, d, tmax


def _geo_t(verts, faces):
    n_faces = faces.shape[0]
    return Geometry(
        vertices=torch.as_tensor(verts), faces=torch.as_tensor(faces, dtype=torch.long),
        face_mat=torch.zeros(n_faces, dtype=torch.long),
        face_mesh=torch.zeros(n_faces, dtype=torch.long))


def _geo_j(verts_i, faces):
    n_faces = faces.shape[0]
    return JxGeometry(vertices=jnp.asarray(verts_i), faces=jnp.asarray(faces),
                      face_mat=jnp.zeros(n_faces, jnp.int32),
                      face_mesh=jnp.zeros(n_faces, jnp.int32))


def assert_hits_match(t_a, p_a, t_b, p_b):
    t_a, p_a, t_b, p_b = (np.asarray(x) for x in (t_a, p_a, t_b, p_b))
    np.testing.assert_array_equal(p_a >= 0, p_b >= 0)
    hit = p_a >= 0
    np.testing.assert_allclose(t_a[hit], t_b[hit], rtol=1e-5, atol=1e-6)
    differ = p_a != p_b
    assert np.all(np.abs(t_a[differ] - t_b[differ]) <= 1e-5 * np.maximum(1.0, np.abs(t_a[differ])))


@pytest.mark.parametrize("any_hit", [False, True])
def test_general_plain_matches_pallas(any_hit):
    verts, faces, o, d, tmax = _scene(0)
    t, prim = tc_kernel.intersect_cuda(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(verts),
        torch.as_tensor(faces, dtype=torch.long), t_max=torch.as_tensor(tmax), any_hit=any_hit)
    assert t.shape == prim.shape == (2, N_RAYS)
    for i in range(2):
        t_j, p_j = jx_kernel.intersect_pallas(
            jnp.asarray(o[i]), jnp.asarray(d[i]), jnp.asarray(verts[i]), jnp.asarray(faces),
            t_max=jnp.asarray(tmax[i]), any_hit=any_hit, interpret=True)
        if any_hit:
            np.testing.assert_array_equal(prim[i].numpy() >= 0, np.asarray(p_j) >= 0)
            blocked = jx_intersect.occluded(jnp.asarray(o[i]), jnp.asarray(d[i]),
                                            _geo_j(verts[i], faces), t_max=jnp.asarray(tmax[i]))
            np.testing.assert_array_equal(prim[i].numpy() >= 0, np.asarray(blocked))
        else:
            assert_hits_match(t[i], prim[i], t_j, p_j)
            ref = jx_intersect.intersect_brute(jnp.asarray(o[i]), jnp.asarray(d[i]),
                                               _geo_j(verts[i], faces),
                                               t_max=jnp.asarray(tmax[i]))
            assert_hits_match(t[i], prim[i], ref.t, ref.prim)
    assert not (prim[:, : N_RAYS // 2][:, ::5] >= 0).any()  # dead rays never hit


@pytest.mark.parametrize("any_hit", [False, True])
def test_shared_culled_plain_matches_pallas(any_hit):
    verts, faces, _, d, tmax = _scene(1)
    origin = np.stack([ORIGIN, ORIGIN + 0.1])
    t, prim = tc_culled.intersect_cuda_shared_culled(
        torch.as_tensor(origin), torch.as_tensor(d), torch.as_tensor(verts),
        torch.as_tensor(faces, dtype=torch.long), t_max=torch.as_tensor(tmax), any_hit=any_hit)
    for i in range(2):
        t_j, p_j = jx_culled.intersect_pallas_shared_culled(
            jnp.asarray(origin[i]), jnp.asarray(d[i]), jnp.asarray(verts[i]),
            jnp.asarray(faces), t_max=jnp.asarray(tmax[i]), any_hit=any_hit,
            interpret=True, chunk=16)
        o_b = jnp.broadcast_to(jnp.asarray(origin[i]), d[i].shape)
        if any_hit:
            np.testing.assert_array_equal(prim[i].numpy() >= 0, np.asarray(p_j) >= 0)
            blocked = jx_intersect.occluded(o_b, jnp.asarray(d[i]), _geo_j(verts[i], faces),
                                            t_max=jnp.asarray(tmax[i]))
            np.testing.assert_array_equal(prim[i].numpy() >= 0, np.asarray(blocked))
        else:
            assert_hits_match(t[i], prim[i], t_j, p_j)
            ref = jx_intersect.intersect_brute(o_b, jnp.asarray(d[i]), _geo_j(verts[i], faces),
                                               t_max=jnp.asarray(tmax[i]))
            assert_hits_match(t[i], prim[i], ref.t, ref.prim)
