"""The two CUDA intersection kernels against their plain PyTorch versions,
on the card.  Marked `cuda`; skipped where torch.cuda.is_available() is
false.  Run on a GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

Tolerance: any-hit masks exact; closest-hit prim equal except at t-ties
(1e-5 relative), t within 1e-5 relative where the prims agree.
"""

import numpy as np
import pytest
import torch

from fireflies_tpu_torch.render.cuda import intersect_culled as ic
from fireflies_tpu_torch.render.cuda import intersect_kernel as ik

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
    (t_k, p_k), (t_p, p_p) = kernel, plain
    torch.cuda.synchronize()
    assert torch.equal(p_k >= 0, p_p >= 0)
    if not any_hit:
        same = p_k == p_p
        tie = (t_k - t_p).abs() <= 1e-5 * t_p.abs().clamp(min=1.0)
        assert bool((same | tie).all())
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5, atol=1e-6)
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


def test_wrappers_refuse_bad_inputs(dev):
    verts, faces, o, d, tmax = _inputs(dev, n_variants=1)
    tri, boxes = ik.pack_triangles(verts, faces)
    rays, tm, _ = ik.pack_rays(o, d, tmax)
    with pytest.raises(ValueError):
        ik.intersect_packed(rays, tm.double(), tri, boxes, 1e-4)
    with pytest.raises(ValueError):
        ik.intersect_packed(rays, tm, tri.cpu(), boxes, 1e-4)
