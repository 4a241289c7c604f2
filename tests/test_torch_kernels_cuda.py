"""The CUDA kernels against their plain PyTorch versions, on the card: B1
(shared culled), B3 (general), B2 and B4 (streamed culled, with emitted
attributes), B5 (general culled), B6 (shared, every cluster front to back),
B7s and B7g (streamed, every cluster), X1 (the reference's parked
matrix-unit intersection, whose split-TF32 tensor-core d' filters the pairs
it then tests as the plain version does: bit for bit) and the probe's FP32
throughput kernel X2 (bit for bit).  Marked `cuda`; skipped
where torch.cuda.is_available() is false.  Run on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerance: any-hit masks exact; closest-hit prim equal except at t-ties
(1e-5 relative), t within 1e-5 relative where the prims agree (B1, B3, B4,
B6 and B7g in the tests that say so: equal, since the plain versions round
their steps, fused or not, alike), emitted
normal and material equal where the prims agree.  The per-ray counts of
tested clusters (`tested`) are exact integers: 0 on dead rays, never more
than the ray's tile lists.  What they count follows each kernel's body:
the clusters a ray's warp tested for B1, B2, B6 and B7s
(`csrc/intersect_shared.cuh`, a slab vote per warp) and X1
(`csrc/intersect_mxu.cu`, a vote per warp of live rays), the clusters its own
slab test opened for B3, B5 (`csrc/intersect_general.cuh`), B4 and B7g.

Two tests hold the main path on the card: the batched pattern step (one
render of every variant, one backward) against the per-variant loop it
replaced, loss and gradient within 1e-5 relative (summation order; the
CPU test of tests/test_torch_render_texture.py holds the same bar), and the
texture route's deterministic render (pixel-centre rays, one bounce)
through the kernels against the same render through the plain versions on
the CPU, within 1e-4 of the image max on >= 99.9% of pixels, with the beam
gradient within 1e-3 relative L2: the texture gradient's scatter-add uses
atomic adds on the card, whose order varies from run to run.  The same bars
hold the `geometry` shape (smooth normals, the differentiable face-table
attribute route) and the gradient with respect to a translation of its
vertices (the face table's row gather adds back atomically).  B2 and B4
are held without emitted attributes too, as that route calls them above
RESIDENT_MAX_FACES.
"""

import numpy as np
import pytest
import torch

from fireflies_tpu_torch import main_path, perf_probe
from fireflies_tpu_torch.experiments import intersect_mxu as mx
from fireflies_tpu_torch.render.cuda import intersect_culled as ic
from fireflies_tpu_torch.render.cuda import intersect_general_culled as igc
from fireflies_tpu_torch.render.cuda import intersect_kernel as ik
from fireflies_tpu_torch.render.cuda import intersect_stream as ist

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, seed=0, n_rays=6000, n_faces=500, n_variants=3):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(300, 3)).astype(np.float32)
    verts = np.stack([base * (1.0 + 0.1 * i) for i in range(n_variants)])
    faces = rng.integers(0, 300, size=(n_faces, 3))
    o = (rng.normal(size=(n_variants, n_rays, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(n_variants, n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = rng.uniform(0.5, 8.0, size=(n_variants, n_rays)).astype(np.float32)
    tmax[:, ::7] = -1.0
    tmax[:, :2048] = -1.0  # one all-dead tile
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (as_t(verts), torch.as_tensor(faces, dtype=torch.long, device=dev), as_t(o),
            as_t(d), as_t(tmax))


def _check(kernel, plain, any_hit):
    (t_k, p_k, *attrs_k), (t_p, p_p, *attrs_p) = kernel, plain
    torch.cuda.synchronize()
    assert torch.equal(p_k >= 0, p_p >= 0)
    if not any_hit:
        same = p_k == p_p
        tie = (t_k - t_p).abs() <= 1e-5 * t_p.abs().clamp(min=1.0)
        assert bool((same | tie).all())
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5, atol=1e-6)
        assert len(attrs_k) == len(attrs_p)
        for a_k, a_p in zip(attrs_k, attrs_p):
            assert torch.equal(a_k[same], a_p[same])
    assert bool((p_p >= 0).any())


@pytest.mark.parametrize("any_hit", [False, True])
def test_general_kernel_matches_plain(dev, any_hit):
    verts, faces, o, d, tmax = _inputs(dev)
    tri, boxes = ik.pack_triangles(verts, faces)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    before = ik.KERNEL.launches
    out = ik.intersect_packed(rays, tm, tri, boxes, 1e-4, any_hit)
    assert ik.KERNEL.launches == before + 1
    _check(out, ik.intersect_packed_plain(rays, tm, tri, boxes, 1e-4, any_hit), any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_shared_culled_kernel_matches_plain(dev, any_hit):
    verts, faces, _, d, tmax = _inputs(dev, seed=1)
    origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
    woop, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=ic.CHUNK)
    dirs, tm, _ = ik.pack_dirs(d, tmax)
    before = ic.KERNEL.launches
    out = ic.intersect_culled_packed(dirs, tm, woop, boxes, 1e-4, any_hit)
    assert ic.KERNEL.launches == before + 1
    lists, counts = ic.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
    _check(out, ic.intersect_culled_packed_plain(dirs, tm, woop, boxes, lists, counts, 1e-4,
                                                 any_hit), any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_culled_kernel_matches_plain(dev, any_hit):
    verts, faces, _, d, tmax = _inputs(dev, seed=2)
    origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
    face_mat = torch.arange(faces.shape[0], device=dev) % 5
    woop16, boxes = ist.pack_woop_streamed(verts, faces, origin, face_mat)
    dirs, tm, _ = ik.pack_dirs(d, tmax)
    lists, counts = ic.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
    emit = not any_hit
    before = ist.KERNEL.launches
    out = ist.intersect_stream_culled_packed(dirs, tm, woop16, boxes, 1e-4, any_hit, emit,
                                             lists=lists, counts=counts)
    assert ist.KERNEL.launches == before + 1 and len(out) == (6 if emit else 2)
    _check(out, ist.stream_culled_packed_plain(dirs, tm, woop16, boxes, lists, counts, 1e-4,
                                               any_hit, emit), any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_general_culled_kernel_matches_plain(dev, any_hit):
    verts, faces, o, d, tmax = _inputs(dev, seed=3)
    face_mat = torch.arange(faces.shape[0], device=dev) % 5
    woop16, boxes = ist.pack_woop_streamed(verts, faces, None, face_mat)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
    emit = not any_hit
    before = ist.KERNEL_GENERAL.launches
    out = ist.intersect_stream_general_culled_packed(rays, tm, woop16, boxes, 1e-4, any_hit,
                                                     emit, lists=lists, counts=counts)
    assert ist.KERNEL_GENERAL.launches == before + 1
    _check(out, ist.stream_culled_packed_plain(rays, tm, woop16, boxes, lists, counts, 1e-4,
                                               any_hit, emit), any_hit)


@pytest.mark.parametrize("kernel", ["B2", "B4"])
def test_stream_culled_closest_without_attributes_matches_plain(dev, kernel):
    # The face-table route's closest-hit call above RESIDENT_MAX_FACES: no
    # face_mat, so the kernel emits (t, prim) only.
    verts, faces, o, d, tmax = _inputs(dev, seed=12)
    if kernel == "B2":
        origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
        woop16, boxes = ist.pack_woop_streamed(verts, faces, origin, None)
        rays, tm, _ = ik.pack_dirs(d, tmax)
        lists, counts = ic.tile_cluster_lists(rays, boxes, t_min=1e-4, tmax_tiles=tm)
        fn, counter = ist.intersect_stream_culled_packed, ist.KERNEL
    else:
        woop16, boxes = ist.pack_woop_streamed(verts, faces, None, None)
        rays, tm, _ = ik.pack_rays(o, d, tmax)
        lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
        fn, counter = ist.intersect_stream_general_culled_packed, ist.KERNEL_GENERAL
    before = counter.launches
    out = fn(rays, tm, woop16, boxes, 1e-4, False, False, lists=lists, counts=counts)
    assert counter.launches == before + 1 and len(out) == 2
    _check(out, ist.stream_culled_packed_plain(rays, tm, woop16, boxes, lists, counts, 1e-4,
                                               False, False), False)


@pytest.mark.parametrize("any_hit", [False, True])
def test_general_culled_kernel_matches_plain(dev, any_hit):
    verts, faces, o, d, tmax = _inputs(dev, seed=4)
    tri, boxes = ik.pack_triangles(verts, faces, chunk=igc.CHUNK)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
    before = igc.KERNEL.launches
    out = igc.intersect_general_culled_packed(rays, tm, tri, boxes, 1e-4, any_hit,
                                              lists=lists, counts=counts)
    assert igc.KERNEL.launches == before + 1
    _check(out, igc.intersect_general_culled_packed_plain(rays, tm, tri, boxes, lists, counts,
                                                          1e-4, any_hit), any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
def test_shared_kernel_matches_plain(dev, any_hit):
    verts, faces, _, d, tmax = _inputs(dev, seed=8)
    origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
    woop, boxes = ik.pack_triangles_woop(verts, faces, origin)
    dirs, tm, _ = ik.pack_dirs(d, tmax)
    order = ik.cluster_order(boxes)
    before = ik.KERNEL_SHARED.launches
    out = ik.intersect_shared_packed(dirs, tm, woop, boxes, 1e-4, any_hit, order=order)
    assert ik.KERNEL_SHARED.launches == before + 1
    _check(out, ik.intersect_shared_packed_plain(dirs, tm, woop, boxes, order, 1e-4, any_hit),
           any_hit)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("general", [False, True])
def test_stream_kernel_matches_plain(dev, general, any_hit):
    verts, faces, o, d, tmax = _inputs(dev, seed=9)
    if general:
        woop16, boxes = ist.pack_woop_streamed(verts, faces, None)
        rays, tm, _ = ik.pack_rays(o, d, tmax)
        fn, kernel = ist.intersect_stream_general_packed, ist.KERNEL_UNCULLED_GENERAL
    else:
        origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
        woop16, boxes = ist.pack_woop_streamed(verts, faces, origin)
        rays, tm, _ = ik.pack_dirs(d, tmax)
        fn, kernel = ist.intersect_stream_packed, ist.KERNEL_UNCULLED
    before = kernel.launches
    out = fn(rays, tm, woop16, boxes, 1e-4, any_hit)
    assert kernel.launches == before + 1 and len(out) == 2
    _check(out, ist.stream_packed_plain(rays, tm, woop16, boxes, 1e-4, any_hit), any_hit)


def _mxu_check(out, plain):
    """X1 against its plain version: t and prim bit for bit (the tensor
    cores only filter the pairs; the kernel tests those that pass in the
    plain version's float32 operations)."""
    torch.cuda.synchronize()
    assert torch.equal(out[1], plain[1]) and torch.equal(out[0], plain[0])
    assert bool((plain[1] >= 0).any()) and bool(torch.isfinite(out[0]).all())


@pytest.mark.parametrize("any_hit", [False, True])
def test_mxu_kernel_matches_plain(dev, any_hit):
    """X1 against its plain version on 6000 rays, so the last 128-ray group
    is partly padding; the entry point gives the packed call's rows bit for
    bit."""
    verts, faces, _, d, tmax = _inputs(dev, seed=10)
    origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
    woop, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=mx.CHUNK)
    dirs, tm, n = ik.pack_dirs(d, tmax)
    before = mx.KERNEL.launches
    out = mx.intersect_mxu_packed(dirs, tm, woop, boxes, 1e-4, any_hit)
    assert mx.KERNEL.launches == before + 1
    plain = mx.intersect_mxu_packed_plain(dirs, tm, woop, boxes, 1e-4, any_hit)
    _mxu_check(out, plain)
    t, prim = mx.intersect_mxu_shared(origin, d, verts, faces, t_max=tmax, any_hit=any_hit)
    assert torch.equal(prim, out[1].reshape(3, -1)[:, :n])
    assert torch.equal(t, out[0].reshape(3, -1)[:, :n])


def test_mxu_one_ray_opens_a_cluster_for_its_group(dev):
    """Two clusters of 128 small faces seen from the origin, one down -z and
    one along +x.  Every ray of the first 256 looks down -z (within 0.1 rad)
    but ray 5, which looks along +x: its vote makes its warp (rays 0-31)
    test both clusters, while every other warp tests only the first; the
    padding rays are dead and count 0."""
    rng = np.random.default_rng(11)
    centres = np.concatenate([rng.uniform(-0.5, 0.5, (128, 3)) * [1, 1, 0.1] + [0, 0, -5],
                              rng.uniform(-0.5, 0.5, (128, 3)) * [0.1, 1, 1] + [5, 0, 0]])
    tris = rng.uniform(-0.05, 0.05, (256, 3, 3)) + centres[:, None]
    verts = torch.as_tensor(tris.reshape(1, -1, 3), dtype=torch.float32, device=dev)
    faces = torch.arange(768, device=dev).reshape(256, 3)
    d = np.concatenate([rng.uniform(-0.1, 0.1, (256, 2)), -np.ones((256, 1))], -1)
    d[5] = [1.0, 0.02, 0.01]
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32,
                        device=dev)
    origin = torch.zeros(1, 3, device=dev)
    woop, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=mx.CHUNK)
    dirs, tm, _ = ik.pack_dirs(d[None], 1e30)
    tested = torch.full_like(tm, -1, dtype=torch.int32)
    out = mx.intersect_mxu_packed(dirs, tm, woop, boxes, 1e-4, tested=tested)
    plain = mx.intersect_mxu_packed_plain(dirs, tm, woop, boxes, 1e-4)
    _mxu_check(out, plain)
    tested = tested.reshape(-1)
    assert bool((tested[:mx.WARP] == 2).all()) and bool((tested[mx.WARP:256] == 1).all())
    assert bool((tested[256:] == 0).all())  # padding: dead


def test_mxu_grazing_rays_within_conditioned_bound(dev):
    """Rays from the origin nearly parallel to a large triangle in the plane
    x + z = 0.01: n . d = delta / |d| with delta in [3e-4, 3e-3], so kappa =
    sum_i |W_zi d_i| / |d'_z| is about 2 / delta, 700 to 7000, and t about
    14 / (delta / 1e-3).  The tensor cores' d'_z is then off by up to kappa
    times its relative error, which the filter's width grows with, so the
    kernel still returns the plain version's t and prim bit for bit."""
    rng = np.random.default_rng(12)
    n_rays = 4096
    delta = rng.uniform(3e-4, 3e-3, n_rays)
    d = np.stack([np.ones(n_rays), rng.uniform(-0.2, 0.2, n_rays), -1.0 + delta], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    big = np.array([[0.01 - 100.0, -60.0, 100.0], [0.01 + 100.0, -60.0, -100.0],
                    [0.01, 120.0, 0.0]])  # x + z = 0.01 at every vertex
    small = rng.uniform(-1, 1, (255, 1, 3)) + rng.uniform(-0.1, 0.1, (255, 3, 3)) + [0, 0, 30]
    tris = np.concatenate([big[None], small])
    verts = torch.as_tensor(tris.reshape(1, -1, 3), dtype=torch.float32, device=dev)
    faces = torch.arange(768, device=dev).reshape(256, 3)
    origin = torch.zeros(1, 3, device=dev)
    woop, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=mx.CHUNK)
    dirs, tm, _ = ik.pack_dirs(torch.as_tensor(d[None], dtype=torch.float32, device=dev), 1e30)
    out = mx.intersect_mxu_packed(dirs, tm, woop, boxes, 1e-4)
    plain = mx.intersect_mxu_packed_plain(dirs, tm, woop, boxes, 1e-4)
    _mxu_check(out, plain)
    hits = plain[1].reshape(-1)[:n_rays]
    assert int((hits == 0).sum()) > 0.9 * n_rays


def test_mxu_t_tie_in_one_tile_goes_to_the_lowest_face(dev):
    """One triangle at faces 2, 3, 5 and 13 (identical rows, so equal t bit
    for bit): faces 2 and 3 fall to one lane of a quad (columns 2 and 3 of
    the first 8-face tile), 5 to another lane, and 13 to that lane again in
    the next tile.  Every ray through it gets face 2, from the kernel (its
    visiting order, then the quad's reduction by (t, face)) as from the
    plain version's first-index argmin."""
    rng = np.random.default_rng(13)
    tri = np.array([[-1.0, -1.0, -3.0], [1.0, -1.0, -3.0], [0.0, 1.0, -3.0]])
    tris = rng.uniform(-1, 1, (128, 1, 3)) + rng.uniform(-0.1, 0.1, (128, 3, 3)) + [0, 0, 30]
    tris[[2, 3, 5, 13]] = tri
    verts = torch.as_tensor(tris.reshape(1, -1, 3), dtype=torch.float32, device=dev)
    faces = torch.arange(384, device=dev).reshape(128, 3)
    d = np.concatenate([rng.uniform(-0.15, 0.15, (2048, 2)), -np.ones((2048, 1))], -1)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32,
                        device=dev)
    origin = torch.zeros(1, 3, device=dev)
    woop, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=mx.CHUNK)
    dirs, tm, _ = ik.pack_dirs(d[None], 1e30)
    out = mx.intersect_mxu_packed(dirs, tm, woop, boxes, 1e-4)
    plain = mx.intersect_mxu_packed_plain(dirs, tm, woop, boxes, 1e-4)
    _mxu_check(out, plain)
    hit = (out[1] >= 0) & (plain[1] >= 0)
    assert int(hit.sum()) > 1000
    assert bool((out[1][hit] == 2).all()) and bool((plain[1][hit] == 2).all())


def test_tc_sum_within_the_filter_bound(dev):
    """The tensor cores' TF32 k8 sum (`csrc/tc_probe.cu`, the instruction
    X1 forms d' with) multiplies exactly, and adds random products within
    `intersect_mxu.TC_SUM_BOUND` of the sum of their magnitudes, the bound
    X1's filter assumes."""
    rows = perf_probe.tc_random(20000)
    before = perf_probe.TC_KERNEL.launches
    got = perf_probe.tc_sums(rows, dev)
    assert perf_probe.TC_KERNEL.launches == before + 1
    prods = rows[..., 0] * rows[..., 1]
    assert bool(((got - prods.sum(1)).abs() <= mx.TC_SUM_BOUND * prods.abs().sum(1)).all())
    one = torch.zeros_like(rows)
    one[:, 3] = rows[:, 3]
    assert torch.equal(perf_probe.tc_sums(one, dev), one[:, 3, 0] * one[:, 3, 1])


def test_vpu_probe_matches_plain_bitwise(dev):
    x = perf_probe.vpu_input(dev)
    before = perf_probe.VPU_KERNEL.launches
    out = perf_probe.vpu_rounds(x)
    assert perf_probe.VPU_KERNEL.launches == before + 1
    plain = perf_probe.vpu_rounds_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(out, plain) and bool(torch.isfinite(out).all())
    assert torch.unique(out).numel() > 1000


def _occluder_scene(dev, n_variants=2, n_rays=4096):
    """A large quad (faces 0-1) in z = 0 with 126 small faces beside it fill
    the first 128-face cluster; 384 small faces lie far behind it.  Rays
    from around (0, 0, 4) toward the quad are all blocked by the first
    listed cluster, so the streamed kernels' any-hit loop leaves after the
    next batch's copy has started (B4 and B7g stage one cluster a batch,
    B2 and B7s two)."""
    rng = np.random.default_rng(7)
    quad = np.array([[-20, -20, 0], [20, -20, 0], [20, 20, 0], [-20, 20, 0]], np.float32)
    small = rng.uniform(-0.05, 0.05, size=(510, 3, 3)).astype(np.float32)
    centres = np.concatenate([
        rng.uniform(-1, 1, size=(126, 3)) * [1, 1, 0.01] + [0, 0, 0.1],
        rng.uniform(-3, 3, size=(384, 3)) * [1, 1, 0.1] + [0, 0, -30]]).astype(np.float32)
    tris = np.concatenate([quad[[[0, 1, 2], [0, 2, 3]]], small + centres[:, None, :]])
    verts = np.stack([tris.reshape(-1, 3)] * n_variants)
    faces = np.arange(tris.shape[0] * 3).reshape(-1, 3)
    u = rng.uniform(-0.3, 0.3, size=(n_variants, n_rays, 2))
    d = np.concatenate([u, -np.ones((n_variants, n_rays, 1))], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), d.shape).copy()
    o[..., :2] += rng.uniform(-0.2, 0.2, size=(n_variants, n_rays, 2)).astype(np.float32)
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (as_t(verts), torch.as_tensor(faces, dtype=torch.long, device=dev), as_t(o), as_t(d),
            torch.full((n_variants, n_rays), 100.0, device=dev))


@pytest.mark.parametrize("general", [False, True])
def test_stream_any_hit_exits_with_copy_in_flight(dev, general):
    """B2 (warp votes) and B4 (per-ray tests) on the occluder scene in
    any-hit mode: every ray is blocked by the first listed cluster, and
    every live ray reports one tested cluster (for B2, its warp tested no
    other; for B4, it opened no other); the lists hold a second batch, whose
    copy is started before the block leaves, and the next launch on the
    same stream sees no stale copy."""
    verts, faces, o, d, tmax = _occluder_scene(dev)
    if general:
        woop16, boxes = ist.pack_woop_streamed(verts, faces, None)
        rays, tm, _ = ik.pack_rays(o, d, tmax)
        lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
        fn = ist.intersect_stream_general_culled_packed
    else:
        origin = torch.tensor([[0.0, 0.0, 4.0]] * 2, device=dev)
        woop16, boxes = ist.pack_woop_streamed(verts, faces, origin)
        rays, tm, _ = ik.pack_dirs(d, tmax)
        lists, counts = ic.tile_cluster_lists(rays, boxes, t_min=1e-4, tmax_tiles=tm)
        fn = ist.intersect_stream_culled_packed
    assert int(counts.min()) >= 3 and bool((lists[..., 0] == 0).all())
    tested = torch.empty_like(tm, dtype=torch.int32)
    out = fn(rays, tm, woop16, boxes, 1e-4, True, lists=lists, counts=counts, tested=tested)
    plain = ist.stream_culled_packed_plain(rays, tm, woop16, boxes, lists, counts, 1e-4, True)
    _check(out, plain, True)
    assert bool((out[1] >= 0).all())  # every ray blocked, by the first cluster
    assert bool((tested == 1).all())  # and no warp (B2) or ray (B4) tested a second one
    # The next launch on the same stream sees no stale copy.
    again = fn(rays, tm, woop16, boxes, 1e-4, False, lists=lists, counts=counts)
    _check(again, ist.stream_culled_packed_plain(rays, tm, woop16, boxes, lists, counts, 1e-4),
           False)


@pytest.mark.parametrize("general", [False, True])
def test_unculled_stream_any_hit_exits_with_copy_in_flight(dev, general):
    """B7s and B7g walk the clusters in index order, so the quad's cluster
    (0) comes first and blocks every ray; the block leaves after the copy of
    the next batch (B7s: clusters 2-3, B7g: cluster 1) has started.  Every
    live ray reports one tested cluster: B7s's warps, B7g's rays test no
    other."""
    verts, faces, o, d, tmax = _occluder_scene(dev)
    if general:
        woop16, boxes = ist.pack_woop_streamed(verts, faces, None)
        rays, tm, _ = ik.pack_rays(o, d, tmax)
        fn = ist.intersect_stream_general_packed
    else:
        origin = torch.tensor([[0.0, 0.0, 4.0]] * 2, device=dev)
        woop16, boxes = ist.pack_woop_streamed(verts, faces, origin)
        rays, tm, _ = ik.pack_dirs(d, tmax)
        fn = ist.intersect_stream_packed
    assert boxes.shape[2] >= 2
    tested = torch.empty_like(tm, dtype=torch.int32)
    out = fn(rays, tm, woop16, boxes, 1e-4, True, tested=tested)
    _check(out, ist.stream_packed_plain(rays, tm, woop16, boxes, 1e-4, True), True)
    assert bool((out[1] >= 0).all())
    assert bool((tested == 1).all())
    again = fn(rays, tm, woop16, boxes, 1e-4, False)
    _check(again, ist.stream_packed_plain(rays, tm, woop16, boxes, 1e-4), False)


def _tested_case(dev, kernel):
    """(wrapper, args, kwargs, listed clusters per ray) of one kernel on
    `_inputs`, with its tile lists prebuilt where it has them."""
    verts, faces, o, d, tmax = _inputs(dev, seed=5)
    origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    dirs, _, _ = ik.pack_dirs(d, tmax)
    if kernel == "B3":
        tri, boxes = ik.pack_triangles(verts, faces)
        return ik.intersect_packed, (rays, tm, tri, boxes, 1e-4), {}, boxes.shape[2]
    if kernel == "B6":
        woop, boxes = ik.pack_triangles_woop(verts, faces, origin)
        return ik.intersect_shared_packed, (dirs, tm, woop, boxes, 1e-4), {}, boxes.shape[2]
    if kernel == "X1":
        woop, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=mx.CHUNK)
        return mx.intersect_mxu_packed, (dirs, tm, woop, boxes, 1e-4), {}, boxes.shape[2]
    if kernel in ("B7s", "B7g"):
        woop16, boxes = ist.pack_woop_streamed(verts, faces, origin if kernel == "B7s" else None)
        fn = ist.intersect_stream_packed if kernel == "B7s" else ist.intersect_stream_general_packed
        return fn, (dirs if kernel == "B7s" else rays, tm, woop16, boxes, 1e-4), {}, boxes.shape[2]
    if kernel in ("B1", "B2"):
        if kernel == "B1":
            table, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=ic.CHUNK)
            fn = ic.intersect_culled_packed
        else:
            table, boxes = ist.pack_woop_streamed(verts, faces, origin)
            fn = ist.intersect_stream_culled_packed
        lists, counts = ic.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
        rays = dirs
    else:
        if kernel == "B4":
            table, boxes = ist.pack_woop_streamed(verts, faces, None)
            fn = ist.intersect_stream_general_culled_packed
        else:
            table, boxes = ik.pack_triangles(verts, faces, chunk=igc.CHUNK)
            fn = igc.intersect_general_culled_packed
        lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
    per_ray = counts.expand(-1, -1, ik.RAY_TILE).reshape(tm.shape)
    return fn, (rays, tm, table, boxes, 1e-4), dict(lists=lists, counts=counts), per_ray


@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4", "B5", "B6", "B7s", "B7g", "X1"])
def test_tested_counts_bounded_by_lists(dev, kernel):
    """The per-ray count of tested clusters that the pair-test bound is
    taken from: 0 on dead rays, at most the listed clusters, some tested,
    fewer in any-hit mode than in closest-hit mode, and the same outputs
    as a launch that does not count."""
    fn, args, kw, listed = _tested_case(dev, kernel)
    tm = args[1]
    counts = {}
    for any_hit in (False, True):
        tested = torch.full_like(tm, -1, dtype=torch.int32)
        out = fn(*args, any_hit=any_hit, tested=tested, **kw)
        for a, b in zip(out, fn(*args, any_hit=any_hit, **kw)):
            assert torch.equal(a, b)
        counts[any_hit] = tested
    closest, any_hit = counts[False], counts[True]
    live = tm >= 0
    assert bool((closest[~live] == 0).all()) and bool((any_hit[~live] == 0).all())
    assert bool((closest <= torch.where(live, listed, 0)).all())
    assert bool((any_hit <= closest).all())
    assert int(closest.sum()) > 0


def test_wrappers_refuse_bad_inputs(dev):
    verts, faces, o, d, tmax = _inputs(dev, n_variants=1)
    tri, boxes = ik.pack_triangles(verts, faces)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    with pytest.raises(ValueError):
        ik.intersect_packed(rays, tm.double(), tri, boxes, 1e-4)
    with pytest.raises(ValueError):
        ik.intersect_packed(rays, tm, tri.cpu(), boxes, 1e-4)
    with pytest.raises(ValueError, match="tested"):  # only the kernel counts tested clusters
        ik.intersect_packed(rays.cpu(), tm.cpu(), tri.cpu(), boxes.cpu(), 1e-4,
                            tested=torch.zeros_like(tm.cpu(), dtype=torch.int32))


def _bounce_inputs(dev, seed, n_rays=6000, n_faces=500, n_variants=2):
    """`_inputs` with ill-conditioned bounce rays: every other ray starts on
    a random face (o' = W o - W v0 then cancels), the rest off the soup."""
    verts, faces, o, d, tmax = _inputs(dev, seed, n_rays, n_faces, n_variants)
    g = torch.Generator(device=dev).manual_seed(seed)
    on = torch.randint(0, n_faces, (n_variants, n_rays // 2), device=dev, generator=g)
    bary = torch.rand(n_variants, n_rays // 2, 3, device=dev, generator=g)
    bary = bary / bary.sum(-1, keepdim=True)
    tri = torch.stack([verts[i][faces[on[i]]] for i in range(n_variants)])  # (B, N/2, 3, 3)
    o = o.clone()
    o[:, ::2] = (bary[..., None] * tri).sum(2)
    return verts, faces, o, d, tmax


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", ["B4", "B7g"])
def test_general_stream_kernels_round_as_plain(dev, kernel, any_hit):
    """B4 and B7g on bounce rays that start on faces: the explicit fused
    steps of the kernels and `fma32` in the plain version round alike, so
    wherever the prims agree t is equal bit for bit; any-hit masks exact.
    The count of differing prims (t-ties) is printed."""
    verts, faces, o, d, tmax = _bounce_inputs(dev, seed=12)
    woop16, boxes = ist.pack_woop_streamed(verts, faces, None)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    if kernel == "B4":
        lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
        out = ist.intersect_stream_general_culled_packed(rays, tm, woop16, boxes, 1e-4, any_hit,
                                                         lists=lists, counts=counts)
        plain = ist.stream_culled_packed_plain(rays, tm, woop16, boxes, lists, counts, 1e-4,
                                               any_hit)
    else:
        out = ist.intersect_stream_general_packed(rays, tm, woop16, boxes, 1e-4, any_hit)
        plain = ist.stream_packed_plain(rays, tm, woop16, boxes, 1e-4, any_hit)
    _check(out, plain, any_hit)
    if not any_hit:
        same = (out[1] == plain[1]) & (plain[1] >= 0)
        print(f"{kernel}: {int(((out[1] != plain[1]) & (tm >= 0)).sum())} prims differ, "
              f"{int(same.sum())} hits agree")
        assert torch.equal(out[0][same], plain[0][same])


def _assert_winner_attributes(out, woop16):
    """The emitted normal and material of a streamed culled kernel: the
    gather from `woop16` at the kernel's own prim on every hit, (0, 0, 1)
    and 0 on every miss."""
    t, prim, nx, ny, nz, mat = out
    torch.cuda.synchronize()
    b = prim.shape[0]
    hit, idx = prim >= 0, prim.clamp(min=0).reshape(b, -1).long()
    assert bool(hit.any()) and bool((~hit).any())
    for got, row, miss in ((nx, 6, 0.0), (ny, 7, 0.0), (nz, 8, 1.0)):
        want = torch.gather(woop16[:, row], 1, idx).reshape(prim.shape)
        assert torch.equal(got[hit], want[hit]) and bool((got[~hit] == miss).all())
    want = torch.gather(woop16[:, ist.MAT_ROW], 1, idx).reshape(prim.shape).to(torch.int32)
    assert torch.equal(mat[hit], want[hit]) and bool((mat[~hit] == 0).all())


def test_general_culled_kernel_reads_winner_attributes(dev):
    """B4 reads its winner's W2 row and material id after the walk: equal
    to the plain gather at the kernel's own prim on every hit, (0, 0, 1)
    and 0 on every miss."""
    verts, faces, o, d, tmax = _bounce_inputs(dev, seed=13)
    face_mat = torch.arange(faces.shape[0], device=dev) % 7
    woop16, boxes = ist.pack_woop_streamed(verts, faces, None, face_mat)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    _assert_winner_attributes(ist.intersect_stream_general_culled_packed(
        rays, tm, woop16, boxes, 1e-4, emit_attrs=True), woop16)


def test_stream_culled_kernel_reads_winner_attributes(dev):
    """B2 reads its winner's W2 row and material id after the walk (not
    carried through it): equal to the plain version's wherever the prims
    agree, to the gather at the kernel's own prim on every hit, and
    (0, 0, 1) and 0 on every miss."""
    verts, faces, _, d, tmax = _inputs(dev, seed=15)
    origin = torch.tensor([[0.0, 0.5, 4.0]] * 3, device=dev)
    face_mat = torch.arange(faces.shape[0], device=dev) % 7
    woop16, boxes = ist.pack_woop_streamed(verts, faces, origin, face_mat)
    dirs, tm, _ = ik.pack_dirs(d, tmax)
    lists, counts = ic.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
    out = ist.intersect_stream_culled_packed(dirs, tm, woop16, boxes, 1e-4, emit_attrs=True,
                                             lists=lists, counts=counts)
    _check(out, ist.stream_culled_packed_plain(dirs, tm, woop16, boxes, lists, counts, 1e-4,
                                               emit_attrs=True), False)
    _assert_winner_attributes(out, woop16)


@pytest.mark.parametrize("kernel", ["B4", "B7g"])
def test_general_stream_tests_only_own_clusters(dev, kernel):
    """Two clusters of 128 small faces seen from the origin, one down -z and
    one along +x; every ray of the first 256-ray block looks down -z but ray
    5, which looks along +x.  B4 and B7g test a ray only against the
    clusters its own slab test opens: every live ray tests one cluster (ray
    5 the +x one), where a vote of its warp or block would have tested both,
    and no ray tests more clusters than its tile lists."""
    rng = np.random.default_rng(11)
    centres = np.concatenate([rng.uniform(-0.5, 0.5, (128, 3)) * [1, 1, 0.1] + [0, 0, -5],
                              rng.uniform(-0.5, 0.5, (128, 3)) * [0.1, 1, 1] + [5, 0, 0]])
    tris = rng.uniform(-0.05, 0.05, (256, 3, 3)) + centres[:, None]
    verts = torch.as_tensor(tris.reshape(1, -1, 3), dtype=torch.float32, device=dev)
    faces = torch.arange(768, device=dev).reshape(256, 3)
    d = np.concatenate([rng.uniform(-0.1, 0.1, (256, 2)), -np.ones((256, 1))], -1)
    d[5] = [1.0, 0.02, 0.01]
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32,
                        device=dev)[None]
    woop16, boxes = ist.pack_woop_streamed(verts, faces, None)
    rays, tm, _ = ik.pack_rays(torch.zeros_like(d), d, 1e30)
    tested = torch.full_like(tm, -1, dtype=torch.int32)
    if kernel == "B4":
        lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
        assert int(counts[0, 0, 0]) == 2
        out = ist.intersect_stream_general_culled_packed(rays, tm, woop16, boxes, 1e-4,
                                                         lists=lists, counts=counts,
                                                         tested=tested)
        plain = ist.stream_culled_packed_plain(rays, tm, woop16, boxes, lists, counts, 1e-4)
    else:
        out = ist.intersect_stream_general_packed(rays, tm, woop16, boxes, 1e-4, tested=tested)
        plain = ist.stream_packed_plain(rays, tm, woop16, boxes, 1e-4)
    _check(out, plain, False)
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
    tested = tested.reshape(-1)
    assert bool((tested[:256] == 1).all())
    assert bool((tested[256:] == 0).all())  # padding: dead


# B1, B2, B3, B5, B6 and B7s on one wrapper signature: (packed rays, tmax,
# table, boxes, t_min, any_hit, lists/counts or order keyword arguments).
# B3 and B5 take per-ray origins and test each ray against the clusters its
# own slab test opens; the others vote per warp over a shared origin.
_RESIDENT = ("B1", "B2", "B3", "B5", "B6", "B7s")
_GENERAL = ("B3", "B5")
_CHUNK = {"B1": ic.CHUNK, "B2": ist.STREAM_CHUNK, "B3": ik.CHUNK, "B5": igc.CHUNK,
          "B6": ik.CHUNK, "B7s": ist.STREAM_CHUNK}


def _resident_case(dev, kernel, verts, faces, o, d, tmax):
    """(wrapper, args, kwargs, plain version) of one of `_RESIDENT` on the
    given rays, with tile lists prebuilt and shared-origin rays starting at
    each variant's o[:, 0]."""
    if kernel in _GENERAL:
        tri, boxes = ik.pack_triangles(verts, faces, chunk=_CHUNK[kernel])
        rays, tm, _ = ik.pack_rays(o, d, tmax)
        if kernel == "B3":
            return ik.intersect_packed, (rays, tm, tri, boxes, 1e-4), {}, ik.intersect_packed_plain
        lists, counts = ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm)
        return (igc.intersect_general_culled_packed, (rays, tm, tri, boxes, 1e-4),
                dict(lists=lists, counts=counts),
                lambda *a, any_hit=False: igc.intersect_general_culled_packed_plain(
                    *a, lists, counts, 1e-4, any_hit))
    origin = o[:, 0].contiguous()
    dirs, tm, _ = ik.pack_dirs(d, tmax)
    if kernel in ("B2", "B7s"):
        woop, boxes = ist.pack_woop_streamed(verts, faces, origin)
    else:
        woop, boxes = ik.pack_triangles_woop(verts, faces, origin, chunk=_CHUNK[kernel])
    if kernel == "B6":
        order = ik.cluster_order(boxes)
        return (ik.intersect_shared_packed, (dirs, tm, woop, boxes, 1e-4), dict(order=order),
                lambda *a, any_hit=False: ik.intersect_shared_packed_plain(
                    *a, order, 1e-4, any_hit))
    if kernel == "B7s":
        return (ist.intersect_stream_packed, (dirs, tm, woop, boxes, 1e-4), {},
                lambda *a, any_hit=False: ist.stream_packed_plain(*a, 1e-4, any_hit))
    lists, counts = ic.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
    fn, plain = ((ic.intersect_culled_packed, ic.intersect_culled_packed_plain) if kernel == "B1"
                 else (ist.intersect_stream_culled_packed, ist.stream_culled_packed_plain))
    return (fn, (dirs, tm, woop, boxes, 1e-4), dict(lists=lists, counts=counts),
            lambda *a, any_hit=False: plain(*a, lists, counts, 1e-4, any_hit))


def _plain(kernel, plain, args, any_hit):
    if kernel == "B3":
        return plain(*args, any_hit=any_hit)
    return plain(*args[:4], any_hit=any_hit)


def _equal_where_prims_agree(out, plain):
    """t bit for bit wherever kernel and plain version give the same prim
    (both round every step alike); returns the number of such hits."""
    same = (out[1] == plain[1]) & (plain[1] >= 0)
    assert torch.equal(out[0][same], plain[0][same])
    return int(same.sum())


@pytest.mark.parametrize("kernel", _RESIDENT)
def test_resident_one_ray_opens_a_cluster(dev, kernel):
    """Two clusters seen from the origin, one down -z and one along +x;
    every ray of the first 256-ray block looks down -z but ray 5, which
    looks along +x.  B1, B2, B6 and B7s vote per warp: ray 5 opens the +x
    cluster for its warp (rays 0-31 test both clusters, the other warps
    one).  B3 and B5 test a ray only against the clusters its own slab test
    opens: every live ray tests one.  Outputs equal the plain version's, t
    bit for bit."""
    chunk = _CHUNK[kernel]
    rng = np.random.default_rng(11)
    centres = np.concatenate([rng.uniform(-0.5, 0.5, (chunk, 3)) * [1, 1, 0.1] + [0, 0, -5],
                              rng.uniform(-0.5, 0.5, (chunk, 3)) * [0.1, 1, 1] + [5, 0, 0]])
    tris = rng.uniform(-0.05, 0.05, (2 * chunk, 3, 3)) + centres[:, None]
    verts = torch.as_tensor(tris.reshape(1, -1, 3), dtype=torch.float32, device=dev)
    faces = torch.arange(6 * chunk, device=dev).reshape(2 * chunk, 3)
    d = np.concatenate([rng.uniform(-0.1, 0.1, (256, 2)), -np.ones((256, 1))], -1)
    d[5] = [1.0, 0.02, 0.01]
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32,
                        device=dev)[None]
    fn, args, kw, plain = _resident_case(dev, kernel, verts, faces, torch.zeros_like(d), d, 1e30)
    assert args[3].shape[2] == 2
    tested = torch.full_like(args[1], -1, dtype=torch.int32)
    out = fn(*args, tested=tested, **kw)
    expect = _plain(kernel, plain, args, False)
    _check(out, expect, False)
    assert torch.equal(out[0], expect[0]) and torch.equal(out[1], expect[1])
    tested = tested.reshape(-1)
    if kernel in _GENERAL:
        assert bool((tested[:256] == 1).all())
    else:
        assert bool((tested[:32] == 2).all()) and bool((tested[32:256] == 1).all())
    assert bool((tested[256:] == 0).all())  # padding: dead


@pytest.mark.parametrize("kernel,n_faces", [("B1", 5288), ("B1", 8192), ("B3", 8192),
                                            ("B6", 8192), ("B2", 11538), ("B7s", 11538),
                                            ("B5", 5288)])
def test_resident_walks_lists_longer_than_a_batch(dev, kernel, n_faces):
    """A soup of as many faces as the paths send each kernel: 5288 or 8192
    for B1, 8192 for B3 and B6, the reference shape's 11538 for B2 and B7s
    and mid's 5288 for B5.  Their walks (331 or 512 clusters of 16 faces,
    128 or 83 of 64, 91 of 128) span many staged batches of 256 faces.
    Closest hit against the plain version, t bit for bit where the prims
    agree; any-hit masks exact; the tested counts within the listed
    clusters."""
    verts, faces, o, d, tmax = _inputs(dev, seed=14, n_rays=4096, n_faces=n_faces,
                                       n_variants=2)
    if kernel not in _GENERAL:
        o = torch.tensor([[0.0, 0.5, 4.0]], device=dev).expand_as(o).contiguous()
    fn, args, kw, plain = _resident_case(dev, kernel, verts, faces, o, d, tmax)
    nc = args[3].shape[2]
    listed = kw["counts"].max() if "counts" in kw else nc
    assert int(listed) > 256 // _CHUNK[kernel]
    for any_hit in (False, True):
        tested = torch.empty_like(args[1], dtype=torch.int32)
        out = fn(*args, any_hit=any_hit, tested=tested, **kw)
        expect = _plain(kernel, plain, args, any_hit)
        _check(out, expect, any_hit)
        if not any_hit:
            assert _equal_where_prims_agree(out, expect) > 100
        assert int(tested.max()) <= nc and bool((tested[args[1] < 0] == 0).all())


@pytest.mark.parametrize("kernel", _RESIDENT)
def test_resident_any_hit_exits_with_next_batch_started(dev, kernel):
    """A large quad (faces 0-1, with degenerate faces filling its cluster)
    in front of 1022 small faces far behind it: every ray from around
    (0, 0, 4) is blocked by cluster 0, first on every walk.  In any-hit mode
    the warps of B1, B2, B6 and B7s stop testing after it (every live ray
    reports one tested cluster), and the rays of B3 and B5 stop opening
    clusters after the first batch (a batch's slab tests precede its tests,
    so a ray reports at most that batch's clusters); each block leaves the
    walk with the next batch's copy started, and the next launch on the
    stream sees no stale copy."""
    chunk = _CHUNK[kernel]
    rng = np.random.default_rng(7)
    quad = np.array([[-20, -20, 0], [20, -20, 0], [20, 20, 0], [-20, 20, 0]], np.float32)
    corner = np.repeat(quad[:1][None], chunk - 2, axis=0).repeat(3, axis=1)  # zero-area faces
    far = (rng.uniform(-3, 3, (1022, 1, 3)) * [1, 1, 0.1] + [0, 0, -30]
           + rng.uniform(-0.05, 0.05, (1022, 3, 3)))
    tris = np.concatenate([quad[[[0, 1, 2], [0, 2, 3]]], corner, far]).astype(np.float32)
    verts = torch.as_tensor(np.stack([tris.reshape(-1, 3)] * 2), device=dev)
    faces = torch.arange(tris.shape[0] * 3, device=dev).reshape(-1, 3)
    u = rng.uniform(-0.3, 0.3, size=(2, 4096, 2))
    d = np.concatenate([u, -np.ones((2, 4096, 1))], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.float32([0.0, 0.0, 4.0]), d.shape).copy()
    if kernel in _GENERAL:
        o[..., :2] += rng.uniform(-0.2, 0.2, size=(2, 4096, 2)).astype(np.float32)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    fn, args, kw, plain = _resident_case(dev, kernel, verts, faces, o, d,
                                         torch.full((2, 4096), 100.0, device=dev))
    assert args[3].shape[2] * chunk >= 4 * 256  # four batches or more
    tested = torch.empty_like(args[1], dtype=torch.int32)
    out = fn(*args, any_hit=True, tested=tested, **kw)
    _check(out, _plain(kernel, plain, args, True), True)
    assert bool((out[1] >= 0).all())  # every ray blocked
    if kernel in _GENERAL:
        assert bool((tested >= 1).all()) and int(tested.max()) <= 256 // chunk
    else:
        assert bool((tested == 1).all())  # by the first cluster, and tested no other
    again = fn(*args, **kw)
    _check(again, _plain(kernel, plain, args, False), False)


def test_batched_pattern_step_matches_per_variant_loop(dev):
    bridge, randomize, beams = main_path.build(dev)
    cfg, seeds = main_path.bench_config(size=256), [0, 1, 2, 3]
    loss, grad = main_path.pattern_step(bridge, randomize, beams, seeds, cfg)
    leaf = beams.detach().requires_grad_(True)
    loss_loop = torch.zeros((), device=dev)
    for seed in seeds:
        loss_i = main_path.render_batch(bridge, randomize, leaf, [seed], cfg).mean() / len(seeds)
        loss_i.backward()
        loss_loop += loss_i.detach()
    scale = float(leaf.grad.abs().max())
    assert scale > 0 and bool(torch.isfinite(grad).all())
    torch.testing.assert_close(loss, loss_loop, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(grad, leaf.grad, rtol=1e-5, atol=1e-5 * scale)


def test_texture_route_render_matches_cpu_plain(dev):
    from fireflies_tpu_torch.render import RenderConfig, pathtracer, rays  # noqa: PLC0415

    bridge, randomize, beams = main_path.build(dev)
    cfg = RenderConfig(width=128, height=32, spp=1, max_bounces=1, static_geometry=True)
    params = randomize(torch.Generator(device=dev).manual_seed(7), 0)
    imgs, grads = [], []
    for device in (dev, torch.device("cpu")):
        leaf = beams.detach().to(device).requires_grad_(True)
        scene = bridge.assemble(dict({k: v.to(device) for k, v in params.items()},
                                     **main_path.projector_params(leaf, analytic=False)))
        assert scene.projector.texture.shape == (256, 256, 3)
        o, d, _ = rays.camera_rays_tiled(scene.camera, cfg.width, cfg.height)
        img = pathtracer.trace_rays(scene, o, d, None, cfg,
                                    primary_origin=scene.camera.to_world[:, :3, 3])
        img.mean().backward()
        imgs.append(img.detach().cpu())
        grads.append(leaf.grad.cpu())
    img_k, img_p = imgs
    assert bool(torch.isfinite(img_k).all()) and float(img_p.max()) > 0
    bad = (img_k - img_p).abs().amax(-1) > 1e-4 * img_p.abs().max()
    assert float(bad.float().mean()) <= 1e-3
    g_k, g_p = grads
    assert float(g_p.abs().max()) > 0
    assert float((g_k - g_p).norm() / g_p.norm()) <= 1e-3


def test_geometry_route_render_and_translation_gradient_match_cpu_plain(dev):
    from fireflies_tpu_torch.render import pathtracer, rays  # noqa: PLC0415

    bridge, randomize, beams, _ = main_path.build_shape("geometry", dev)
    cfg = main_path.bench_config(size=128, bounces=1, static_geometry=False).replace(height=32)
    params = randomize(torch.Generator(device=dev).manual_seed(7), 0)
    imgs, grads = [], []
    for device in (dev, torch.device("cpu")):
        scene = bridge.assemble(dict({k: v.to(device) for k, v in params.items()},
                                     **main_path.projector_params(beams.to(device))))
        assert scene.geometry.normals is not None
        delta = torch.zeros(3, device=device, requires_grad=True)
        geo = scene.geometry
        scene = scene.replace(geometry=geo.replace(vertices=geo.vertices + delta))
        o, d, _ = rays.camera_rays_tiled(scene.camera, cfg.width, cfg.height)
        img = pathtracer.trace_rays(scene, o, d, None, cfg,
                                    primary_origin=scene.camera.to_world[:, :3, 3])
        img.mean().backward()
        imgs.append(img.detach().cpu())
        grads.append(delta.grad.cpu())
    img_k, img_p = imgs
    assert bool(torch.isfinite(img_k).all()) and float(img_p.max()) > 0
    bad = (img_k - img_p).abs().amax(-1) > 1e-4 * img_p.abs().max()
    assert float(bad.float().mean()) <= 1e-3
    g_k, g_p = grads
    assert float(g_p.abs().max()) > 0
    assert float((g_k - g_p).norm() / g_p.norm()) <= 1e-3
