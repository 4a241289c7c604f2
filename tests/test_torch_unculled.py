"""Port parity for the resident kernel without tile lists (`tile_cull=False`,
the counterpart of the reference's FF_NO_TILE_CULL=1): the plain PyTorch
version of B6 (resident shared-origin, one front-to-back order) against the
JAX Pallas kernel in interpret mode on the CPU, and its visiting order.
B7s and B7g are in tests/test_torch_unculled_stream.py, the dispatcher's
routes and the render in tests/test_torch_unculled_render.py.

Kernel inputs: the 300-face soups of tests/test_torch_stream.py (two
variants, two 2048-ray tiles, dead rays mixed into tile 0), with its
tolerances: prims equal and any-hit masks exact; t within 1e-6 relative for
shared-origin rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import N_RAYS, ORIGIN, _check, _scene, _t

from fireflies_tpu.render.pallas import intersect_kernel as jx_kernel
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel

torch.set_num_threads(2)


@pytest.mark.parametrize("any_hit", [False, True])
def test_shared_plain_matches_pallas(any_hit):
    verts, faces, _, _, d, tmax = _scene(21)
    origin = np.stack([ORIGIN, ORIGIN + 0.1])
    outs = tc_kernel.intersect_cuda_shared(_t(origin), _t(d), _t(verts), _t(faces, torch.long),
                                           t_max=_t(tmax), any_hit=any_hit)
    assert outs[0].shape == (2, N_RAYS)
    for i in range(2):
        theirs = jx_kernel.intersect_pallas_shared(
            jnp.asarray(origin[i]), jnp.asarray(d[i]), jnp.asarray(verts[i]), jnp.asarray(faces),
            t_max=jnp.asarray(tmax[i]), any_hit=any_hit, interpret=True)
        _check([x[i] for x in outs], theirs, any_hit, attrs=False)
    assert not (outs[1][:, : N_RAYS // 2][:, ::5] >= 0).any()  # dead rays never hit


def test_cluster_order_matches_jax():
    """B6's visiting order: the reference's stable argsort of the centre
    distances, per variant."""
    verts, faces, *_ = _scene(22)
    origin = np.stack([ORIGIN, ORIGIN - 0.3])
    _, boxes = tc_kernel.pack_triangles_woop(_t(verts), _t(faces, torch.long), _t(origin))
    order = tc_kernel.cluster_order(boxes)
    assert order.dtype == torch.int32 and order.shape == (2, 5)
    for i in range(2):
        b = jnp.asarray(boxes[i].numpy())
        center = 0.5 * (b[:3] + b[3:])
        np.testing.assert_array_equal(order[i].numpy(),
                                      np.asarray(jnp.argsort(jnp.sum(center * center, axis=0))))
