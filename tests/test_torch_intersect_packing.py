"""Port parity for the packing helpers and the shared-origin tile lists of
the resident kernels against the JAX package (packing to 1e-6; lists and
counts exact, a tile's list as a set), and the fused rounding of B3's
plain version against a numpy reference.
"""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_intersect import N_RAYS, ORIGIN, _scene

from fireflies_tpu.render.pallas import intersect_culled as jx_culled
from fireflies_tpu.render.pallas import intersect_kernel as jx_kernel
from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel

torch.set_num_threads(2)


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
