"""Port parity for B5 (culled general-origin, mid-sized scenes) and the
streamed kernels' inputs: B5's plain version against the JAX Pallas kernel
in interpret mode on the CPU, the general tile lists and the streamed
packing against JAX.

Inputs and tolerances as tests/test_torch_stream.py: prims equal, any-hit
masks exact, t of per-ray origins held to the float64 ray-plane distance
within 1e-6 + 4 u kappa relative; lists and counts exact; packing to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import N_RAYS, ORIGIN, _check, _scene, _t

from fireflies_tpu.render.pallas import intersect_culled as jx_culled
from fireflies_tpu.render.pallas import intersect_stream as jx_stream
from fireflies_tpu.render.pallas.intersect_kernel import pack_rays as jx_pack_rays
from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_general_culled as tc_gculled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel
from fireflies_tpu_torch.render.cuda import intersect_stream as tc_stream

torch.set_num_threads(2)


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
