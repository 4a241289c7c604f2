"""Port parity for X1, the reference's parked matrix-unit intersection
(experiments/intersect_mxu.py::intersect_mxu_shared): the port's plain
PyTorch version (`fireflies_tpu_torch.experiments.intersect_mxu`) against
the JAX Pallas kernel in interpret mode on the CPU, and the packing against
`pack_mxu_shared`.

Inputs: the 300-face soups of tests/test_torch_stream.py (two variants, two
2048-ray tiles, dead rays mixed into tile 0), cut to 4000 rays so that the
last 128-ray group holds padding rays, which vote.  Tolerances, as
tests/test_torch_unculled.py holds B6: prims equal, t within 1e-6 relative
(XLA forms d' = W d as a dot product, the port as separate multiplies and
adds), any-hit masks exact, dead rays never hit.  The packing is equal bit
for bit, and a per-ray t_max is exactly the t_max=1e30 result cut after the
scan.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import ORIGIN, _check, _scene, _t

from experiments import intersect_mxu as jx_mxu
from fireflies_tpu_torch.experiments import intersect_mxu as tc_mxu
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel

torch.set_num_threads(1)

N = 4000  # not a multiple of 128: the last group is partly padding


def _soup(seed):
    verts, faces, _, _, d, tmax = _scene(seed)
    return verts, faces, d[:, :N], tmax[:, :N], np.stack([ORIGIN, ORIGIN + 0.1])


def _jax(origin, d, verts, faces, **kw):
    out = jx_mxu.intersect_mxu_shared(jnp.asarray(origin), jnp.asarray(d), jnp.asarray(verts),
                                      jnp.asarray(faces), interpret=True, **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("any_hit", [False, True])
def test_mxu_plain_matches_pallas(any_hit):
    verts, faces, d, tmax, origin = _soup(31)
    args = (_t(verts), _t(faces, torch.long))
    outs = tc_mxu.intersect_mxu_shared(_t(origin), _t(d), *args, t_max=_t(tmax), any_hit=any_hit)
    assert outs[0].shape == (2, N) and outs[1].dtype == torch.int32
    i = int(any_hit)  # one variant against the reference per mode
    theirs = _jax(origin[i], d[i], verts[i], faces, t_max=jnp.asarray(tmax[i]), any_hit=any_hit)
    _check([x[i] for x in outs], theirs, any_hit, attrs=False)
    one = tc_mxu.intersect_mxu_shared(_t(origin[i]), _t(d[i]), _t(verts[i]), args[1],
                                      t_max=_t(tmax[i]), any_hit=any_hit)
    assert all(torch.equal(a, b[i]) for a, b in zip(one, outs))  # one scene = its batch row
    assert not (outs[1][:, : N // 2][:, ::5] >= 0).any()  # dead rays never hit


def test_mxu_per_ray_tmax_cuts_after_the_scan():
    """The reference's default t_max (1e30) against JAX, and a per-ray t_max
    (1 to 8, dead rays at -1) equal to that result cut where t >= t_max."""
    verts, faces, d, tmax, origin = _soup(32)
    args = (_t(origin), _t(d), _t(verts), _t(faces, torch.long))
    t_inf, p_inf = tc_mxu.intersect_mxu_shared(*args)
    _check([t_inf[0], p_inf[0]], _jax(origin[0], d[0], verts[0], faces), False, attrs=False)
    t_cut, p_cut = tc_mxu.intersect_mxu_shared(*args, t_max=_t(tmax))
    kept = (p_inf >= 0) & (t_inf < _t(tmax))
    assert torch.equal(p_cut, torch.where(kept, p_inf, -1))
    assert torch.equal(t_cut, torch.where(kept, t_inf, 0.0))
    assert 0 < int(kept.sum()) < int((p_inf >= 0).sum())


def test_mxu_degenerate_faces_never_hit():
    """A triangle with 1e-5 edges (det = |e1 x e2|^2 = 1e-20 < 1e-18) and a
    collinear one in front of a quad: their Woop rows are zero and the rays
    aimed at them hit the quad behind, in both packages."""
    c = np.float32([0.1, 0.2, -1.0])
    verts = np.float32([[-5, -5, -2], [5, -5, -2], [5, 5, -2], [-5, 5, -2],
                        c, c + [1e-5, 0, 0], c + [0, 1e-5, 0],
                        [-1, 0, -0.5], [1, 0, -0.5], [0.3, 0, -0.5]])
    rng = np.random.default_rng(34)
    # 296 small faces behind the origin fill the soups' 300 faces, so the
    # reference's jitted call is the one the tests above compiled.
    behind = (rng.uniform(-1, 1, (296, 1, 3)) + rng.uniform(-0.1, 0.1, (296, 3, 3))) + [0, 0, 50]
    verts = np.concatenate([verts, behind.reshape(-1, 3)]).astype(np.float32)
    faces = np.concatenate([[[0, 1, 2], [0, 2, 3], [4, 5, 6], [7, 8, 9]],
                            10 + np.arange(888).reshape(296, 3)]).astype(np.int32)
    at_tiny = c + [3.3e-6, 3.3e-6, 0] + rng.uniform(-1e-6, 1e-6, (N // 2, 3)) * [1, 1, 0]
    at_line = np.stack([rng.uniform(-0.9, 0.9, N // 2), np.zeros(N // 2), np.full(N // 2, -0.5)],
                       -1)
    d = np.concatenate([at_tiny, at_line]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origin = np.zeros(3, np.float32)
    woop, _ = tc_kernel.pack_triangles_woop(_t(verts)[None], _t(faces, torch.long),
                                            _t(origin)[None], chunk=tc_mxu.CHUNK)
    assert not woop[0, :, 2:4].any() and woop[0, :, :2].any()
    t, prim = tc_mxu.intersect_mxu_shared(_t(origin), _t(d), _t(verts), _t(faces, torch.long))
    t_j, prim_j = _jax(origin, d, verts, faces)
    assert bool(((prim == 0) | (prim == 1)).all())
    np.testing.assert_array_equal(prim.numpy(), prim_j)
    np.testing.assert_allclose(t.numpy(), t_j, rtol=1e-6)
