"""Port parity for the kernel probe (`fireflies_tpu_torch.perf_probe`): the
plain version of the FP32 throughput kernel X2 against the reference's product
tree, and the probe's accounting on the CPU.

`_vpu_kernel` is a closure inside tools/perf_probe.py::probe_roofline, so
its 64 rounds are restated here in jax.numpy (tools/perf_probe.py:388-398)
and run eagerly: each operation is then its own XLA computation and rounds
alone, as the port's plain version and the CUDA kernel (built with
--fmad=false) do, so the two agree bit for bit, well within 1e-6
relative.  Jitted, XLA on the CPU contracts multiply-adds into FMAs
and differs by up to 6e-6 relative (measured).
"""

import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu_torch import perf_probe
from fireflies_tpu_torch.render.cuda import intersect_kernel as ik

torch.set_num_threads(1)


def _vpu_rounds_jax(x):
    for _ in range(64):
        t1 = x * 0.501 + 0.499
        t2 = x * 0.502 + 0.498
        t3 = x * 0.497 + 0.503
        t4 = x * 0.5 + 0.5
        x = (t1 * t2 + t3 * t4) * 0.5
    return x


def test_vpu_plain_matches_reference_rounds():
    x = np.random.default_rng(0).uniform(0.0, 1.0, (256, 1024)).astype(np.float32)
    ours = perf_probe.vpu_rounds(torch.as_tensor(x))  # CPU: the plain version
    theirs = np.asarray(_vpu_rounds_jax(jnp.asarray(x)))
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert np.unique(theirs).size > 1000  # distinct values, so equality means something
    assert perf_probe.vpu_ops(ours) == 256 * 1024 * 64 * 12


def test_roof_workload_lists_every_pair():
    """The kernel roof's workload: the general tile lists enqueue every
    (ray, face) pair, and almost no ray hits, so B3 tests them all."""
    o, d, verts, faces = perf_probe.roof_workload(256, 4096, "cpu")
    assert verts.shape == (1, 768, 3) and faces.shape == (256, 3) and d.shape == (1, 4096, 3)
    tri, boxes = ik.pack_triangles(verts, faces)
    rays, tm, _ = ik.pack_rays(o, d, 1e30)
    assert perf_probe.listed_tests(rays, tm, boxes, ik.CHUNK) == 4096 * 256
    _, prim = ik.intersect_packed(rays, tm, tri, boxes, 1e-4)
    assert float((prim >= 0).float().mean()) < 0.01


def test_listed_tests_on_vocalfold():
    """The per-pass accounting on the probe's rays (128x32 here): camera
    rays' tile lists at 16 faces a cluster and the bounce rays' general
    lists enqueue some tests, and fewer than every face for every ray."""
    rs = perf_probe.scene(24, "cpu")
    verts, faces = rs.geometry.vertices, rs.geometry.faces
    o, d, cam, p, dr = perf_probe.probe_rays(rs, 128, 32)
    n_rays = d.shape[1]
    assert o.shape == d.shape == p.shape == dr.shape == (1, n_rays, 3)
    torch.testing.assert_close(dr.norm(dim=-1), torch.ones(1, n_rays))
    dirs, tm, _ = ik.pack_dirs(d, 1e30)
    boxes = ik.pack_triangles_woop(verts, faces, cam, chunk=16)[1]
    primary = perf_probe.listed_tests(dirs, tm, boxes, 16) / n_rays
    rays, tm_g, _ = ik.pack_rays(p, dr, 1e30)
    boxes = ik.pack_triangles(verts, faces)[1]
    bounce = perf_probe.listed_tests(rays, tm_g, boxes, ik.CHUNK) / n_rays
    padded = -(-faces.shape[0] // ik.CHUNK) * ik.CHUNK
    assert 0 < primary < faces.shape[0] and 0 < bounce <= padded


def test_vote_widths_nest():
    """The `votes` probe's counts on a soup's B4 launch (plain version):
    a wider vote never opens fewer clusters, a block's vote is bounded by
    the tile lists, and a single ray's count is its own slab tests against
    the listed clusters."""
    from fireflies_tpu_torch.render.cuda import intersect_culled as ic
    from fireflies_tpu_torch.render.cuda import intersect_stream as ist

    rng = np.random.default_rng(4)
    verts = torch.as_tensor(rng.normal(size=(1, 400, 3)), dtype=torch.float32)
    faces = torch.as_tensor(rng.integers(0, 400, size=(300, 3)))
    o = torch.as_tensor(rng.normal(size=(1, 4096, 3)) * 3, dtype=torch.float32)
    d = torch.as_tensor(rng.normal(size=(1, 4096, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    tmax = torch.as_tensor(rng.uniform(1.0, 8.0, size=(1, 4096)), dtype=torch.float32)
    tmax[:, ::5] = -1.0
    woop16, boxes = ist.pack_woop_streamed(verts, faces, None)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
    rec = dict(rays_soa=rays, tmax_tiles=tm, woop16=woop16, boxes=boxes, lists=lists,
               counts=counts, t_min=1e-4, any_hit=False)
    t, prim = ist.stream_culled_packed_plain(**rec)[:2]
    votes = perf_probe.vote_widths(rec, t, prim, ray_chunk=2048)
    live = tm.reshape(-1) >= 0
    listed = counts.expand(-1, -1, 2048).reshape(-1)
    assert 0 < votes[1] < votes[32] <= votes[256] <= float(listed[live].sum())
    assert votes[1] <= votes["lanes"] and votes["lanes"] % 32 == 0
    batched = perf_probe.vote_widths(rec, t, prim, widths=(1,), ray_chunk=2048, batch=2)
    assert votes[1] <= batched["lanes"] <= votes["lanes"] and batched[1] == votes[1]
    tfar = torch.where(prim.reshape(-1) >= 0, torch.minimum(tmax[0], t.reshape(-1)), tmax[0])
    opened = perf_probe.slab_open(o[0], d[0], boxes[0], 1e-4, tfar)
    on_list = ic.listed_mask(lists, counts)[0][torch.arange(4096) // 2048]
    assert votes[1] == float((opened & on_list)[live].sum())
