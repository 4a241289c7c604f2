"""Port parity: the plain PyTorch versions of the two CUDA intersection
kernels against the JAX Pallas kernels (interpret mode on the CPU) and
against the brute-force scans, plus the packing helpers and tile lists.

Tolerances: t within 1e-5 relative; prim exact except where two faces
give the same t within 1e-5 (the kernels and the scans break such ties in
different orders); any-hit compares the blocked mask exactly; packing to
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fireflies_tpu.render.intersect as jx_intersect
from fireflies_tpu.render.pallas import intersect_culled as jx_culled
from fireflies_tpu.render.pallas import intersect_kernel as jx_kernel
from fireflies_tpu.render.types import Geometry as JxGeometry
from fireflies_tpu_torch._build import Kernel
from fireflies_tpu_torch.render import RenderConfig
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel
from fireflies_tpu_torch.render.types import Geometry

torch.set_num_threads(2)

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


def test_port_scans_match_reference_scans():
    """The port's intersect_brute / occluded against the JAX scans, and the
    two dispatchers against the port's scans."""
    verts, faces, o, d, tmax = _scene(2, n_variants=1)
    geo = _geo_t(verts, faces)
    ot, dt, tm = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    hit = tc_intersect.intersect_brute(ot, dt, geo, t_max=tm)
    blocked = tc_intersect.occluded(ot, dt, geo, t_max=tm)
    ref = jx_intersect.intersect_brute(jnp.asarray(o[0]), jnp.asarray(d[0]),
                                       _geo_j(verts[0], faces), t_max=jnp.asarray(tmax[0]))
    ref_b = jx_intersect.occluded(jnp.asarray(o[0]), jnp.asarray(d[0]),
                                  _geo_j(verts[0], faces), t_max=jnp.asarray(tmax[0]))
    assert_hits_match(hit.t[0], hit.prim[0], ref.t, ref.prim)
    np.testing.assert_array_equal(blocked[0].numpy(), np.asarray(ref_b))

    via = tc_intersect.closest_hit(ot, dt, geo, t_max=tm, emit_attrs=True)
    assert_hits_match(via.t, via.prim, hit.t, hit.prim)
    assert via.mat is not None and via.nx.shape == via.t.shape
    np.testing.assert_array_equal(
        tc_intersect.occluded_any(ot, dt, geo, t_max=tm).numpy(), blocked.numpy())

    origin = torch.as_tensor(ORIGIN)[None]
    o_s = origin[:, None, :].expand_as(dt)
    via_s = tc_intersect.closest_hit(o_s, dt, geo, t_max=tm, shared_origin=origin)
    ref_s = tc_intersect.intersect_brute(o_s, dt, geo, t_max=tm)
    assert_hits_match(via_s.t, via_s.prim, ref_s.t, ref_s.prim)
    np.testing.assert_array_equal(
        tc_intersect.occluded_any(o_s, dt, geo, t_max=tm, shared_origin=origin).numpy(),
        tc_intersect.occluded(o_s, dt, geo, t_max=tm).numpy())


def test_dispatchers_refuse_unknown_backend():
    verts, faces, o, d, _ = _scene(5, n_variants=1)
    geo = _geo_t(verts, faces)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    with pytest.raises(ValueError):
        tc_intersect.closest_hit(ot, dt, geo, backend="jax")
    with pytest.raises(ValueError):
        tc_intersect.occluded_any(ot, dt, geo, backend="pallas")
    with pytest.raises(ValueError):
        RenderConfig(backend="jax")


def test_shared_culled_takes_prebuilt_lists():
    verts, faces, _, d, tmax = _scene(6)
    woop, boxes = tc_kernel.pack_triangles_woop(
        torch.as_tensor(verts), torch.as_tensor(faces, dtype=torch.long),
        torch.as_tensor(np.stack([ORIGIN, ORIGIN + 0.1])), chunk=16)
    dirs, tm, _ = tc_kernel.pack_dirs(torch.as_tensor(d), torch.as_tensor(tmax))
    lists, counts = tc_culled.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
    built = tc_culled.intersect_culled_packed(dirs, tm, woop, boxes, 1e-4)
    given = tc_culled.intersect_culled_packed(dirs, tm, woop, boxes, 1e-4, lists=lists,
                                              counts=counts)
    assert torch.equal(built[0], given[0]) and torch.equal(built[1], given[1])
    assert bool((built[1] >= 0).any())


def test_kernel_records_inputs_only_on_request():
    kernel = Kernel("ff_unused", [])
    kernel.record(a=1)
    assert kernel.recorded is None
    kernel.recorded = []
    kernel.record(a=1, b=2)
    assert kernel.recorded == [{"a": 1, "b": 2}] and kernel.launches == 0


def _grid(n=24):
    """Plane grid mesh in z = 0: compact Morton-like clusters that cull."""
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


def test_tile_cluster_lists_match_jax():
    grid_v, faces = _grid()
    verts = np.stack([grid_v, grid_v * 1.1])
    origin = np.stack([np.array([0.0, 0.0, 6.0], np.float32)] * 2)
    # A coherent fan whose direction sweeps with the ray index, so each
    # tile sees a narrow window of the plane; tile 0 partly dead.
    u = np.linspace(-0.6, 0.6, N_RAYS, dtype=np.float32)
    d = np.stack([u, 0.05 * np.sin(7 * u), -np.ones_like(u)], -1)
    d = np.broadcast_to(d / np.linalg.norm(d, axis=-1, keepdims=True), (2, N_RAYS, 3)).copy()
    tmax = np.full((2, N_RAYS), 1e30, np.float32)
    tmax[:, :2048:3] = -1.0
    woop, boxes = tc_kernel.pack_triangles_woop(
        torch.as_tensor(verts), torch.as_tensor(faces, dtype=torch.long),
        torch.as_tensor(origin), chunk=16)
    dirs, tm, _ = tc_kernel.pack_dirs(torch.as_tensor(d), torch.as_tensor(tmax))
    lists, counts = tc_culled.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
    assert lists.dtype == counts.dtype == torch.int32
    for i in range(2):
        l_j, c_j = jx_culled.tile_cluster_lists(
            jnp.asarray(dirs[i].numpy()), jnp.asarray(boxes[i].numpy()), t_min=1e-4,
            tmax_tiles=jnp.asarray(tm[i].numpy()))
        l_j, c_j = np.asarray(l_j), np.asarray(c_j)
        np.testing.assert_array_equal(counts[i].numpy(), c_j)
        for tile in range(c_j.shape[0]):
            k = c_j[tile, 0]
            assert set(lists[i, tile, :k].tolist()) == set(l_j[tile, :k].tolist())
    assert 0 < counts.max() < boxes.shape[2]


def test_packing_matches_jax():
    verts, faces, o, d, tmax = _scene(4)
    vt, ft = torch.as_tensor(verts), torch.as_tensor(faces, dtype=torch.long)
    origin = np.stack([ORIGIN, ORIGIN - 0.2])
    tri, boxes = tc_kernel.pack_triangles(vt, ft)
    woop, wboxes = tc_kernel.pack_triangles_woop(vt, ft, torch.as_tensor(origin), chunk=16)
    rays, rtm, n = tc_kernel.pack_rays(torch.as_tensor(o[:, :3000]), torch.as_tensor(d[:, :3000]),
                                       torch.as_tensor(tmax[:, :3000]))
    dirs, dtm, _ = tc_kernel.pack_dirs(torch.as_tensor(d[:, :3000]), 1e30)
    assert n == 3000
    for i in range(2):
        theirs = [
            *jx_kernel.pack_triangles(jnp.asarray(verts[i]), jnp.asarray(faces)),
            *jx_kernel.pack_triangles_woop(
                jnp.asarray(verts[i]), jnp.asarray(faces), jnp.asarray(origin[i]), chunk=16),
            *jx_kernel.pack_rays(jnp.asarray(o[i, :3000]), jnp.asarray(d[i, :3000]),
                                 jnp.asarray(tmax[i, :3000]))[:2],
            *jx_kernel.pack_dirs(jnp.asarray(d[i, :3000]), 1e30)[:2],
        ]
        ours = [tri, boxes, woop, wboxes, rays, rtm, dirs, dtm]
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
