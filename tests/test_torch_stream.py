"""Port parity for the culled kernels of large and mid-sized scenes: the
plain PyTorch versions of B2 (streamed shared-origin), B4 (streamed
general-origin) and B5 (culled general-origin) against the JAX Pallas
kernels in interpret mode on the CPU, the general tile lists and the
streamed packing against JAX, and the dispatcher's face-count routes.

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

from fireflies_tpu.render.pallas import intersect_culled as jx_culled
from fireflies_tpu.render.pallas import intersect_stream as jx_stream
from fireflies_tpu.render.pallas.intersect_kernel import pack_rays as jx_pack_rays
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_general_culled as tc_gculled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel
from fireflies_tpu_torch.render.cuda import intersect_stream as tc_stream
from fireflies_tpu_torch.render.types import Geometry

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


@pytest.mark.parametrize("any_hit", [False, True])
def test_general_culled_plain_matches_pallas(any_hit):
    verts, faces, _, o, d, tmax = _scene(13)
    outs = tc_gculled.intersect_cuda_general_culled(
        _t(o), _t(d), _t(verts), _t(faces, torch.long), t_max=_t(tmax), any_hit=any_hit)
    for i in range(2):
        theirs = jx_culled.intersect_pallas_general_culled(
            jnp.asarray(o[i]), jnp.asarray(d[i]), jnp.asarray(verts[i]), jnp.asarray(faces),
            t_max=jnp.asarray(tmax[i]), any_hit=any_hit, interpret=True, chunk=64)
        _check([x[i] for x in outs], theirs, any_hit, attrs=False,
               rays=(o[i], d[i], verts[i], faces))
    assert not (outs[1][:, : N_RAYS // 2][:, ::5] >= 0).any()


def _grid(n=24):
    """Plane grid mesh in z = 0: compact clusters that cull."""
    xs = np.linspace(-4, 4, n + 1)
    verts = np.array([[xs[j], xs[i], 0.0] for i in range(n + 1) for j in range(n + 1)],
                     np.float32)
    faces = []
    for i in range(n):
        for j in range(n):
            a, b, c, e = i * (n + 1) + j, i * (n + 1) + j + 1, (i + 1) * (n + 1) + j, \
                (i + 1) * (n + 1) + j + 1
            faces += [[a, b, c], [c, b, e]]
    return verts, np.asarray(faces, np.int32)


def test_tile_cluster_lists_general_match_jax():
    """Bounce-like rays: each of three tiles starts on a small patch above
    the plane and scatters downward; tile 0 is partly dead, tile 2 all
    dead.  Lists and counts must equal the reference's exactly."""
    grid_v, faces = _grid()
    verts = np.stack([grid_v, grid_v * 1.1])
    rng = np.random.default_rng(3)
    n = 3 * 2048
    tile = np.arange(n) // 2048
    centre = np.stack([tile * 2.0 - 2.0, 0.5 * tile, np.full(n, 0.3)], -1)
    o = (centre + rng.uniform(-0.2, 0.2, size=(n, 3)) * [1, 1, 0.1]).astype(np.float32)
    d = rng.normal(size=(n, 3)) * [0.1, 0.1, 1.0]
    d[:, 2] = -1.0 - np.abs(d[:, 2])  # downward, never grazing
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.full((n,), 1e30, np.float32)
    tmax[:2048:3] = -1.0
    tmax[4096:] = -1.0
    o2, d2, tmax2 = (np.stack([x, x]) for x in (o, d, tmax))
    for chunk in (64, 128):
        tri, boxes = tc_kernel.pack_triangles(_t(verts), _t(faces, torch.long), chunk=chunk)
        rays, tm, _ = tc_kernel.pack_rays(_t(o2), _t(d2), _t(tmax2))
        lists, counts = tc_culled.tile_cluster_lists_general(rays, boxes, t_min=1e-4,
                                                             tmax_tiles=tm)
        assert lists.dtype == counts.dtype == torch.int32
        rays_j, tm_j, _ = jx_pack_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
        for i in range(2):
            l_j, c_j = jx_culled.tile_cluster_lists_general(
                rays_j, jnp.asarray(boxes[i].numpy()), t_min=1e-4, tmax_tiles=tm_j)
            np.testing.assert_array_equal(counts[i].numpy(), np.asarray(c_j))
            np.testing.assert_array_equal(lists[i].numpy(), np.asarray(l_j))
        assert counts[:, 2].max() == 0 and 0 < counts[:, :2].min()
        assert counts.max() < boxes.shape[2]  # the lists cull


def test_pack_woop_streamed_matches_jax():
    verts, faces, face_mat, *_ = _scene(14)
    origin = np.stack([ORIGIN, ORIGIN - 0.2])
    shared = tc_stream.pack_woop_streamed(_t(verts), _t(faces, torch.long), _t(origin),
                                          _t(face_mat, torch.long))
    general = tc_stream.pack_woop_streamed(_t(verts), _t(faces, torch.long), None)
    assert shared[0].shape == (2, 16, 384) and shared[1].shape == (2, 6, 3)
    for i in range(2):
        theirs_s = jx_stream.pack_woop_streamed(jnp.asarray(verts[i]), jnp.asarray(faces),
                                                jnp.asarray(origin[i]), jnp.asarray(face_mat))
        theirs_g = jx_stream.pack_woop_streamed(jnp.asarray(verts[i]), jnp.asarray(faces), None)
        for ours, theirs in ((shared, theirs_s), (general, theirs_g)):
            for a, b in zip(ours, theirs):
                np.testing.assert_allclose(a[i].numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("route", ["streamed", "general_culled"])
def test_dispatcher_routes_by_face_count(monkeypatch, route):
    """With the thresholds lowered below the soup's 300 faces, shared and
    general rays take the streamed plain versions (or B5's), agree with
    the brute-force scans, and the streamed route's emitted normal and
    material agree with the gathered ones."""
    verts, faces, face_mat, o, d, tmax = _scene(15, n_variants=1)
    geo = Geometry(vertices=_t(verts), faces=_t(faces, torch.long),
                   face_mat=_t(face_mat, torch.long), face_mesh=torch.zeros(300, dtype=torch.long))
    ot, dt, tm = _t(o), _t(d), _t(tmax)
    origin = _t(ORIGIN)[None]
    o_s = origin[:, None, :].expand_as(dt)
    if route == "streamed":
        monkeypatch.setattr(tc_intersect, "RESIDENT_MAX_FACES", 0)
        calls = _counting(monkeypatch, tc_stream, "stream_culled_packed_plain")
    else:
        monkeypatch.setattr(tc_intersect, "GEN_CULL_MIN_FACES", 0)
        calls = _counting(monkeypatch, tc_gculled, "intersect_general_culled_packed_plain")
    ref = tc_intersect.intersect_brute(ot, dt, geo, t_max=tm)
    via = tc_intersect.closest_hit(ot, dt, geo, t_max=tm, emit_attrs=True)
    np.testing.assert_array_equal(via.prim.numpy(), ref.prim.numpy())
    np.testing.assert_allclose(via.t.numpy(), ref.t.numpy(), rtol=1e-5, atol=1e-6)
    gathered = tc_intersect._attrs_fallback(via, geo)
    hit = via.valid
    n_k = torch.stack([via.nx, via.ny, via.nz], -1)[hit]
    n_g = torch.stack([gathered.nx, gathered.ny, gathered.nz], -1)[hit]
    torch.testing.assert_close(n_k / n_k.norm(dim=-1, keepdim=True),
                               n_g / n_g.norm(dim=-1, keepdim=True), rtol=1e-5, atol=1e-6)
    assert torch.equal(via.mat[hit].long(), gathered.mat[hit].long())
    np.testing.assert_array_equal(
        tc_intersect.occluded_any(ot, dt, geo, t_max=tm).numpy(),
        tc_intersect.occluded(ot, dt, geo, t_max=tm).numpy())
    expected_general = 2
    if route == "streamed":
        via_s = tc_intersect.closest_hit(o_s, dt, geo, t_max=tm, shared_origin=origin,
                                         emit_attrs=True)
        ref_s = tc_intersect.intersect_brute(o_s, dt, geo, t_max=tm)
        np.testing.assert_array_equal(via_s.prim.numpy(), ref_s.prim.numpy())
        np.testing.assert_array_equal(
            tc_intersect.occluded_any(o_s, dt, geo, t_max=tm, shared_origin=origin).numpy(),
            tc_intersect.occluded(o_s, dt, geo, t_max=tm).numpy())
        expected_general += 2
    assert len(calls) == expected_general
