"""The coherent bounce draw of the reference-shape render path: one set of 5
uniforms per 2048-ray tile, repeated over the tile, and the BSDF sample it
drives against JAX `sample_v` with the same per-tile numpy uniforms (1e-5
relative, 1e-6 absolute).
"""

import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu.render import bsdf as jx_bsdf
from fireflies_tpu.render import vec3 as jx_vec3
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.render import bsdf as tc_bsdf
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import vec3 as tc_vec3

torch.set_num_threads(1)


def test_coherent_bounce_draw_matches():
    n = 5000  # three tiles, the last one partial
    gens = main_path.generators([3, 4], "cpu")
    uniforms = tc_pt.coherent_uniforms(gens, n, "cpu")
    assert len(uniforms) == 5 and uniforms[0].shape == (2, n)
    for u in uniforms:
        tiles = [u[:, k * 2048:(k + 1) * 2048] for k in range(3)]
        for t in tiles:
            assert torch.equal(t, t[:, :1].expand_as(t))  # one draw per tile
        assert len({float(t[0, 0]) for t in tiles}) == 3
    ref = torch.rand((5, 3), generator=torch.Generator().manual_seed(3))
    assert torch.equal(torch.stack(uniforms)[:, 0, ::2048], ref)

    # The per-tile draws drive the BSDF sample as in the reference.
    rng = np.random.default_rng(9)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo = np.where(np.sum(wo * nrm, -1, keepdims=True) < 0, -wo, wo)
    u = np.repeat(rng.uniform(size=(5, 3)).astype(np.float32), 2048, axis=1)[:, :n]
    mat = dict(base_color=(0.78, 0.35, 0.34), roughness=0.35, specular=0.6, metallic=0.0,
               spec_tint=0.0, clearcoat=0.0, clearcoat_gloss=1.0, sheen=0.0, sheen_tint=0.5,
               anisotropic=0.0, spec_trans=0.0, flatness=0.0, ior=1.5, thin=0.0,
               emission=(0.0, 0.0, 0.0))

    def params(lib):
        out = {}
        for k, v in mat.items():
            a = np.broadcast_to(np.asarray(v, np.float32), (n, 3) if np.ndim(v) else (n,)).copy()
            out[k] = jnp.asarray(a) if lib == "jax" else torch.as_tensor(a)
        out["_flags"] = frozenset()
        return out

    wi_j, _, _ = jx_bsdf.sample_v(params("jax"), jx_vec3.from_array(jnp.asarray(nrm)),
                                  jx_vec3.from_array(jnp.asarray(wo)), None,
                                  uniforms=tuple(jnp.asarray(x) for x in u))
    wi_t, _, _ = tc_bsdf.sample_v(params("torch"), tc_vec3.from_array(torch.as_tensor(nrm)),
                                  tc_vec3.from_array(torch.as_tensor(wo)),
                                  uniforms=tuple(torch.as_tensor(x) for x in u))
    np.testing.assert_allclose(wi_t.to_array().numpy(), np.asarray(wi_j.to_array()),
                               rtol=1e-5, atol=1e-6)
