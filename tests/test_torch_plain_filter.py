"""The plain versions' two-pass test against the one-pass test it replaced.

`intersect_kernel.mt_hits_plain` (B3, B5) and `woop_hits_plain` (B1, B2,
B4, B6, B7s, B7g) run the kernels' arithmetic only on the pairs that a
float32 pass with wide margins keeps (`_mt_candidates`,
`_woop_candidates`).  The reference here runs the same arithmetic
(`_mt_exact`, `_woop_exact`) on every pair of every block and folds the
closest hit as before.  Outputs must be equal bit for bit, on random soups
at three scales (1, 1e-3, 1e3), with zero-area faces, dead rays, per-ray
t_max and rays that graze their face's plane; with and without tile lists.
"""

import numpy as np
import pytest
import torch

from fireflies_tpu_torch.render.cuda import intersect_culled as ic
from fireflies_tpu_torch.render.cuda import intersect_kernel as ik
from fireflies_tpu_torch.render.cuda import intersect_stream as ist

torch.set_num_threads(1)

B, N_RAYS, N_FACES = 2, 2048, 300


def _every_pair(rays_soa, tmax_tiles, table, exact, listed=None, chunk=ik.CHUNK):
    """The one-pass reference: `exact(ray, face, tm)` on every pair."""
    b, n_comp = rays_soa.shape[:2]
    r = tmax_tiles[0].numel()
    rays = rays_soa.reshape(b, n_comp, r)
    tmax = tmax_tiles.reshape(b, r)
    out_t = torch.zeros(b, r)
    out_p = torch.full((b, r), -1, dtype=torch.int32)
    cluster = torch.arange(table.shape[2]) // chunk
    for bi, idx in ik.live_ray_blocks(tmax):
        ray = [rays[bi, k, idx, None] for k in range(n_comp)]
        tm = tmax[bi, idx, None]
        best_t = torch.full_like(tm[:, 0], ik._BIG)
        best_p = torch.full(best_t.shape, -1, dtype=torch.int32)
        for f0 in range(0, table.shape[2], ik.FACE_BLOCK):
            face = [table[bi, k, None, f0:f0 + ik.FACE_BLOCK] for k in range(table.shape[1])]
            t = exact(ray, face, tm)
            if listed is not None:
                on = listed[bi][(idx // ik.RAY_TILE)[:, None],
                                cluster[None, f0:f0 + ik.FACE_BLOCK]]
                t = torch.where(on, t, ik._BIG)
            best_t, best_p = ik._carry_min(t, f0, best_t, best_p)
        out_t[bi, idx] = torch.where(best_p >= 0, best_t, 0.0)
        out_p[bi, idx] = best_p
    return out_t, out_p


def _soup(seed, scale, grazing):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(200, 3)).astype(np.float32)
    verts = np.stack([base * (1.0 + 0.1 * i) for i in range(B)]) * scale
    faces = rng.integers(0, 200, size=(N_FACES, 3))
    faces[:4, 1] = faces[:4, 0]  # zero-area faces
    o = (rng.normal(size=(B, N_RAYS, 3)) * 3.0 * scale).astype(np.float32)
    d = rng.normal(size=(B, N_RAYS, 3)).astype(np.float32)
    if grazing:  # from near a face, along its first edge, 1e-6 off its plane
        v = verts[:, faces[rng.integers(0, N_FACES, N_RAYS)]]
        e1, e2 = v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0]
        n = np.cross(e1, e2)
        d = e1 + 1e-6 * n * rng.normal(size=(B, N_RAYS, 1)) / (
            np.linalg.norm(n, axis=-1, keepdims=True) + 1e-30)
        o = (v[:, :, 0] + 0.3 * e2 - 0.5 * e1).astype(np.float32)
    d = (d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-30)).astype(np.float32)
    tmax = (rng.uniform(-1.0, 8.0, size=(B, N_RAYS)) * scale).astype(np.float32)
    return (torch.as_tensor(verts.astype(np.float32)), torch.as_tensor(faces),
            torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax))


def _equal(ours, ref):
    assert torch.equal(ours[1], ref[1]) and torch.equal(ours[0], ref[0])
    assert bool((ref[1] >= 0).any())


@pytest.mark.parametrize("scale,grazing", [(1.0, False), (1e-3, True), (1e3, True)])
def test_filtered_plain_versions_equal_every_pair(scale, grazing):
    verts, faces, o, d, tmax = _soup(int(scale * 7) % 11 + grazing, scale, grazing)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    dirs, tm_d, _ = ik.pack_dirs(d, tmax)
    t_min = 1e-4 * scale

    tri, boxes = ik.pack_triangles(verts, faces)
    lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=t_min, tmax_tiles=tm)
    listed = ic.listed_mask(lists, counts)
    for mask in (None, listed):
        _equal(ik.mt_hits_plain(rays, tm, tri, t_min, mask),
               _every_pair(rays, tm, tri, lambda r, f, x: ik._mt_exact(r, f, x, t_min), mask))

    origin = o[:, 0] * 0.5
    woop, wboxes = ik.pack_triangles_woop(verts, faces, origin, chunk=ic.CHUNK)
    lists, counts = ic.tile_cluster_lists(dirs, wboxes, t_min=t_min, tmax_tiles=tm_d)
    listed = ic.listed_mask(lists, counts)
    for fused, mask in ((False, None), (True, listed)):
        _equal(ik.woop_hits_plain(dirs, tm_d, woop, mask, t_min, ic.CHUNK, fused),
               _every_pair(dirs, tm_d, woop,
                           lambda r, f, x, fused=fused: ik._woop_exact(r, f, x, t_min, False,
                                                                       fused),
                           mask, ic.CHUNK))

    woop16, _ = ist.pack_woop_streamed(verts, faces, None)
    _equal(ik.woop_hits_plain(rays, tm, woop16, None, t_min, ist.STREAM_CHUNK),
           _every_pair(rays, tm, woop16,
                       lambda r, f, x: ik._woop_exact(r, f[:12], x, t_min, True, True)))
