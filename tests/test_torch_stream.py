"""Port parity for the culled streamed kernels of large scenes: the plain
PyTorch versions of B2 (streamed shared-origin) and B4 (streamed
general-origin) against the JAX Pallas kernels in interpret mode on the
CPU.  The soups, `_check` and its yardstick here serve the other port
files too: B5, the general tile lists and the streamed packing
(tests/test_torch_stream_lists.py), the dispatcher's face-count routes
(tests/test_torch_stream_routes.py), the unculled kernels and X1.

Inputs: 300-face random soups made with numpy, two 2048-ray tiles, two
variants, dead rays (tmax = -1) mixed into tile 0.  Tolerances: prims
equal; plane normal within 1e-6 relative and material id exact on hits;
any-hit masks exact; lists and counts exact.  t within 1e-6 relative of
the reference for shared-origin rays.  For per-ray origins t comes out of
a difference of nearly equal terms (o' = W o - W v0, or Möller-Trumbore's
T x e1 over a small det), and XLA on the CPU contracts a*b+c into fused
multiply-adds while the port rounds each operation (as the CUDA kernels
do, built with --fmad=false), so the two differ by up to ~2e-4 relative on
ill-conditioned rays.  There both are held to the float64 ray-plane
distance within 1e-6 + 4 u kappa relative, with u = 2^-24 and kappa the
ray's first-order condition number (`_kappa`); measured, the error stays
below 1.1 u kappa in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.render.pallas import intersect_stream as jx_stream
from fireflies_tpu_torch.render.cuda import intersect_stream as tc_stream

torch.set_num_threads(2)

N_RAYS = 4096  # two 2048-ray tiles
N_MATS = 4
ORIGIN = np.array([0.0, 0.5, 4.0], np.float32)


def _scene(seed, n_verts=400, n_faces=300, n_variants=2):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_verts, 3)).astype(np.float32)
    verts = np.stack([base * (1.0 + 0.1 * i) + 0.05 * i for i in range(n_variants)])
    faces = rng.integers(0, n_verts, size=(n_faces, 3)).astype(np.int32)
    face_mat = rng.integers(0, N_MATS, size=n_faces).astype(np.int32)
    o = (rng.normal(size=(n_variants, N_RAYS, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(n_variants, N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(1.0, 8.0, size=(n_variants, N_RAYS)).astype(np.float32)
    tmax[:, : N_RAYS // 2][:, ::5] = -1.0
    return verts, faces, face_mat, o, d, tmax


def _t(a, dtype=None):
    return torch.as_tensor(a, dtype=dtype)


def _plane64(o, d, verts, faces, prim):
    """float64 ray-plane distance to face `prim` for each ray, and the
    first-order condition number of computing it in float32:
    |e1| |e2| ((|o| + |v0|) / |n . (o - v0)| + |d| / |n . d|)."""
    v = verts.astype(np.float64)[faces[prim]]
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    n = np.cross(e1, e2)
    o, d = o.astype(np.float64), d.astype(np.float64)
    num, den = np.sum(n * (v[:, 0] - o), -1), np.sum(n * d, -1)
    norm = np.linalg.norm
    kappa = norm(e1, axis=-1) * norm(e2, axis=-1) * (
        (norm(o, axis=-1) + norm(v[:, 0], axis=-1)) / np.abs(num) + norm(d, axis=-1) / np.abs(den))
    return num / den, kappa


def _check(ours, theirs, any_hit, attrs, rays=None):
    """ours: one variant's outputs; theirs: the JAX outputs.  `rays`
    (o, d, verts, faces) of per-ray-origin calls selects the float64
    yardstick for t (see the module docstring)."""
    p_t, p_j = ours[1].numpy(), np.asarray(theirs[1])
    if any_hit:
        np.testing.assert_array_equal(p_t >= 0, p_j >= 0)
        return
    np.testing.assert_array_equal(p_t, p_j)
    hit = p_j >= 0
    assert hit.any()
    t_t, t_j = ours[0].numpy()[hit], np.asarray(theirs[0])[hit]
    if rays is None:
        np.testing.assert_allclose(t_t, t_j, rtol=1e-6)
    else:
        o, d, verts, faces = rays
        t64, kappa = _plane64(o[hit], d[hit], verts, faces, p_j[hit])
        bound = (1e-6 + 4 * 2.0**-24 * kappa) * np.abs(t64)
        for t in (t_t, t_j):
            assert np.all(np.abs(t - t64) <= bound), float(np.max(np.abs(t - t64) / bound))
    if attrs:
        for k in (2, 3, 4):
            np.testing.assert_allclose(ours[k].numpy()[hit], np.asarray(theirs[k])[hit],
                                       rtol=1e-6, atol=1e-12)
        np.testing.assert_array_equal(ours[5].numpy()[hit], np.asarray(theirs[5])[hit])


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_culled_plain_matches_pallas(any_hit):
    verts, faces, face_mat, _, d, tmax = _scene(11)
    origin = np.stack([ORIGIN, ORIGIN + 0.1])
    fm = None if any_hit else face_mat
    outs = tc_stream.intersect_cuda_streamed_culled(
        _t(origin), _t(d), _t(verts), _t(faces, torch.long), t_max=_t(tmax), any_hit=any_hit,
        face_mat=None if fm is None else _t(fm, torch.long))
    assert len(outs) == (2 if any_hit else 6) and outs[0].shape == (2, N_RAYS)
    for i in range(2):
        theirs = jx_stream.intersect_pallas_streamed_culled(
            jnp.asarray(origin[i]), jnp.asarray(d[i]), jnp.asarray(verts[i]), jnp.asarray(faces),
            t_max=jnp.asarray(tmax[i]), any_hit=any_hit, interpret=True,
            face_mat=None if fm is None else jnp.asarray(fm))
        _check([x[i] for x in outs], theirs, any_hit, attrs=fm is not None)
    assert not (outs[1][:, : N_RAYS // 2][:, ::5] >= 0).any()  # dead rays never hit


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_general_culled_plain_matches_pallas(any_hit):
    verts, faces, face_mat, o, d, tmax = _scene(12)
    fm = None if any_hit else face_mat
    outs = tc_stream.intersect_cuda_streamed_general_culled(
        _t(o), _t(d), _t(verts), _t(faces, torch.long), t_max=_t(tmax), any_hit=any_hit,
        face_mat=None if fm is None else _t(fm, torch.long))
    for i in range(2):
        theirs = jx_stream.intersect_pallas_streamed_general_culled(
            jnp.asarray(o[i]), jnp.asarray(d[i]), jnp.asarray(verts[i]), jnp.asarray(faces),
            t_max=jnp.asarray(tmax[i]), any_hit=any_hit, interpret=True,
            face_mat=None if fm is None else jnp.asarray(fm))
        _check([x[i] for x in outs], theirs, any_hit, attrs=fm is not None,
               rays=(o[i], d[i], verts[i], faces))
    assert not (outs[1][:, : N_RAYS // 2][:, ::5] >= 0).any()


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls
