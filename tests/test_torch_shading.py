"""Port parity: BSDF evaluation, pdf and sampling with injected draws,
against the JAX functions, for the diffuse and GGX lobes (the optional
lobes are in tests/test_torch_bsdf_lobes.py, the lights in
tests/test_torch_lights.py).

Inputs are random frames made with numpy and fed to both packages; both
vocalfold materials (and a metallic variant) are covered.  Tolerance:
1e-5 relative, with an absolute floor of 1e-6 — or, for values that sit on
an ill-conditioned spot (the GGX peak of a sampled direction, where
sin^2 of the half-vector angle carries ~1e-7 absolute rounding in either
package; a spot light's falloff ramp, which divides the cosine difference
by beam - cutoff), of 1e-5 times the largest value compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.render import bsdf as jx_bsdf
from fireflies_tpu.render import vec3 as jx_vec3
from fireflies_tpu_torch.render import bsdf as tc_bsdf
from fireflies_tpu_torch.render import vec3 as tc_vec3

torch.set_num_threads(1)

N = 4096
MATERIALS = {
    "mucosa": dict(base_color=(0.78, 0.35, 0.34), roughness=0.35, specular=0.6, metallic=0.0),
    "tissue": dict(base_color=(0.72, 0.30, 0.30), roughness=0.5, specular=0.5, metallic=0.0),
    "metal": dict(base_color=(0.9, 0.6, 0.2), roughness=0.2, specular=0.5, metallic=0.7),
}


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frames(seed):
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    wo = _unit(rng, N)
    wo = np.where(np.sum(wo * n, -1, keepdims=True) < 0, -wo, wo)  # viewer side
    wi = _unit(rng, N)
    u = rng.uniform(size=(3, N)).astype(np.float32)
    return n, wo, wi, u


def _params(mat, lib):
    full = dict(spec_tint=0.0, clearcoat=0.0, clearcoat_gloss=1.0, sheen=0.0, sheen_tint=0.5,
                anisotropic=0.0, spec_trans=0.0, flatness=0.0, ior=1.5, thin=0.0,
                emission=(0.0, 0.0, 0.0), **mat)
    out = {}
    for k, v in full.items():
        a = np.broadcast_to(np.asarray(v, np.float32), (N, 3) if np.ndim(v) else (N,)).copy()
        out[k] = jnp.asarray(a) if lib == "jax" else torch.as_tensor(a)
    out["_flags"] = frozenset()
    return out


def _v(a, lib):
    return (jx_vec3.from_array(jnp.asarray(a)) if lib == "jax"
            else tc_vec3.from_array(torch.as_tensor(a)))


def _close(ours, theirs, rtol=1e-5, atol=1e-6, ill_conditioned=False):
    if isinstance(ours, tc_vec3.Vec3):
        ours, theirs = ours.to_array(), theirs.to_array()
    theirs = np.asarray(theirs)
    if ill_conditioned:
        atol = 1e-5 * float(np.abs(theirs).max())
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_bsdf_matches(name):
    n, wo, wi, u = _frames(sorted(MATERIALS).index(name))
    pj, pt = _params(MATERIALS[name], "jax"), _params(MATERIALS[name], "torch")
    nj, woj, wij = _v(n, "jax"), _v(wo, "jax"), _v(wi, "jax")
    nt, wot, wit = _v(n, "torch"), _v(wo, "torch"), _v(wi, "torch")
    _close(tc_bsdf.evaluate_v(pt, nt, wot, wit), jx_bsdf.evaluate_v(pj, nj, woj, wij))
    _close(tc_bsdf.pdf_v(pt, nt, wot, wit), jx_bsdf.pdf_v(pj, nj, woj, wij))
    u_j = tuple(jnp.asarray(x) for x in u) + (jnp.zeros(N), jnp.zeros(N))
    u_t = tuple(torch.as_tensor(x) for x in u)
    wi_t, pdf_t, f_t = tc_bsdf.sample_v(pt, nt, wot, uniforms=u_t)
    wi_j, _, _ = jx_bsdf.sample_v(pj, nj, woj, None, uniforms=u_j)
    _close(wi_t, wi_j)
    # pdf and f of the sample, held against the reference at the port's
    # sampled direction (near the GGX peak they would amplify the last-ulp
    # differences of wi).
    wi_tj = _v(wi_t.to_array().numpy(), "jax")
    _close(pdf_t, jx_bsdf.pdf_v(pj, nj, woj, wi_tj), ill_conditioned=True)
    _close(f_t, jx_bsdf.evaluate_v(pj, nj, woj, wi_tj), ill_conditioned=True)
