"""Port parity for the streamed kernels without tile lists (`tile_cull=False`,
the reference's FF_NO_TILE_CULL=1): the plain PyTorch versions of B7s and
B7g against the JAX Pallas kernels in interpret mode on the CPU, on the
300-face soups of tests/test_torch_stream.py with its tolerances (prims
equal, any-hit masks exact; t within 1e-6 relative for shared-origin rays,
and for per-ray origins both packages within a conditioned float64 bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_stream import N_RAYS, ORIGIN, _check, _scene, _t

from fireflies_tpu.render.pallas import intersect_stream as jx_stream
from fireflies_tpu_torch.render.cuda import intersect_stream as tc_stream

torch.set_num_threads(2)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("general", [False, True])
def test_streamed_plain_matches_pallas(general, any_hit):
    verts, faces, _, o, d, tmax = _scene(23 + general)
    if general:
        outs = tc_stream.intersect_cuda_streamed_general(
            _t(o), _t(d), _t(verts), _t(faces, torch.long), t_max=_t(tmax), any_hit=any_hit)
    else:
        origin = np.stack([ORIGIN, ORIGIN + 0.1])
        outs = tc_stream.intersect_cuda_streamed(
            _t(origin), _t(d), _t(verts), _t(faces, torch.long), t_max=_t(tmax), any_hit=any_hit)
    assert len(outs) == 2 and outs[0].shape == (2, N_RAYS)
    for i in range(2):
        args = (jnp.asarray(d[i]), jnp.asarray(verts[i]), jnp.asarray(faces))
        kw = dict(t_max=jnp.asarray(tmax[i]), any_hit=any_hit, interpret=True)
        if general:
            theirs = jx_stream.intersect_pallas_streamed_general(jnp.asarray(o[i]), *args, **kw)
            rays = (o[i], d[i], verts[i], faces)
        else:
            theirs = jx_stream.intersect_pallas_streamed(jnp.asarray(origin[i]), *args, **kw)
            rays = None
        _check([x[i] for x in outs], theirs, any_hit, attrs=False, rays=rays)
    assert not (outs[1][:, : N_RAYS // 2][:, ::5] >= 0).any()
