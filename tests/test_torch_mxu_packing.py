"""X1's packing against the reference's (experiments/intersect_mxu.py):
`pack_triangles_woop` at chunk 128 and `pack_dirs` against
`pack_mxu_shared` and `pack_dirs_k8`, bit for bit, on the soups of
tests/test_torch_mxu.py.
"""

import jax.numpy as jnp
import numpy as np
import torch
from test_torch_mxu import N, _soup
from test_torch_stream import _t

from experiments import intersect_mxu as jx_mxu
from fireflies_tpu_torch.experiments import intersect_mxu as tc_mxu
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel

torch.set_num_threads(2)


def test_mxu_packing_matches_jax():
    """`pack_triangles_woop` at chunk 128 in the caller's face order is the
    reference's (w, o', boxes) bit for bit, padding faces included (zero
    rows, +-3e38 boxes), and `pack_dirs` holds the rows of `pack_dirs_k8`."""
    verts, faces, d, tmax, origin = _soup(33)
    woop, boxes = tc_kernel.pack_triangles_woop(_t(verts), _t(faces, torch.long), _t(origin),
                                                chunk=tc_mxu.CHUNK)
    dirs, tm, n = tc_kernel.pack_dirs(_t(d), _t(tmax))
    nc = boxes.shape[2]
    assert woop.shape == (2, 12, 384) and nc == 3 and n == N
    assert not woop[:, :, 300:].any()
    for i in range(2):
        w, op, bx = (np.asarray(x) for x in jx_mxu.pack_mxu_shared(
            jnp.asarray(verts[i]), jnp.asarray(faces), jnp.asarray(origin[i])))
        assert w.shape == (nc, 3, 8, 128) and op.shape == (nc, 8, 128)
        assert not w[:, :, 3:].any() and not op[:, 3:].any()  # the unused K slots
        ours_w = woop[i, :9].reshape(3, 3, nc, 128).permute(2, 0, 1, 3).numpy()
        np.testing.assert_array_equal(ours_w, w[:, :, :3])
        np.testing.assert_array_equal(woop[i, 9:].reshape(3, nc, 128).transpose(0, 1).numpy(),
                                      op[:, :3])
        np.testing.assert_array_equal(boxes[i].numpy(), bx)
        d_k8, tm_k8, _ = jx_mxu.pack_dirs_k8(jnp.asarray(d[i]), jnp.asarray(tmax[i]))
        np.testing.assert_array_equal(dirs[i].transpose(0, 1).numpy(), np.asarray(d_k8)[:, :3])
        np.testing.assert_array_equal(tm[i].numpy(), np.asarray(tm_k8))
