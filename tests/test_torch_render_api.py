"""Port parity for the rest of the render API: `render/__init__`'s exports
and the array-form twins of the component (`_v`) functions, each held
against the JAX package's on the same inputs:

  * every name the reference's `render` exports exists in the port's, and
    `utils.math`'s get_{yaw,pitch,roll,x,y,z}_transform are its rotations;
  * `bsdf.evaluate` and `pdf_fn` on random frames (1e-5 relative, 1e-6
    absolute), and `sample` with the reference's five uniforms injected
    against its `sample_v`;
  * `lights.eval_light`, `eval_projector`, `total_incident` and
    `sample_one_light` (the reference's choice of emitter injected) on the
    vocalfold scene's spot light and beam projector, from the reference's
    randomized parameters;
  * `intersect.hit_attributes_v` on the vocalfold scene's camera hits, and
    `vec3.v3`, `lerp`, `gather`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fireflies_tpu import render as jx_render
from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import bsdf as jx_bsdf
from fireflies_tpu.render import intersect as jx_intersect
from fireflies_tpu.render import lights as jx_lights
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu.render import vec3 as jx_vec3
from fireflies_tpu.utils import math as jx_math
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch import render as tc_render
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.render import bsdf as tc_bsdf
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render import lights as tc_lights
from fireflies_tpu_torch.render import rays as tc_rays
from fireflies_tpu_torch.render import vec3 as tc_vec3
from fireflies_tpu_torch.utils import math as tc_math

torch.set_num_threads(2)

N = 256


def _close(got, ref, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def test_exports_and_rotation_aliases():
    missing = [n for n in jx_render.__all__ if n not in tc_render.__all__]
    assert not missing, missing
    assert all(callable(getattr(tc_render, n)) for n in tc_render.__all__)
    angle = torch.tensor([0.3, -1.1])
    for name in ("yaw", "pitch", "roll", "x", "y", "z"):
        fn = getattr(tc_math, f"get_{name}_transform")
        _close(fn(angle), np.stack([getattr(jx_math, f"get_{name}_transform")(jnp.asarray(a))
                                    for a in (0.3, -1.1)]))


def _frames(seed):
    rng = np.random.default_rng(seed)

    def unit():
        v = rng.normal(size=(N, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    n, wo, wi, tan = unit(), unit(), unit(), unit()
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    params = dict(base_color=rng.uniform(0.1, 0.9, (N, 3)), roughness=rng.uniform(0.3, 0.9, N),
                  metallic=rng.uniform(0, 1, N), specular=np.full(N, 0.5),
                  spec_tint=np.zeros(N), clearcoat=np.zeros(N), clearcoat_gloss=np.ones(N),
                  sheen=rng.uniform(0, 1, N), sheen_tint=np.full(N, 0.5),
                  anisotropic=np.zeros(N), spec_trans=np.zeros(N), flatness=np.zeros(N),
                  ior=np.full(N, 1.5), thin=np.zeros(N), emission=np.zeros((N, 3)))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return n, wo, wi, tan, params, rng.uniform(size=(5, N)).astype(np.float32)


def test_bsdf_array_forms():
    n, wo, wi, tan, params, u = _frames(0)
    pj = {k: jnp.asarray(v) for k, v in params.items()}

    def pt():
        return {k: torch.from_numpy(v)[None] for k, v in params.items()}

    def b(x):
        return torch.from_numpy(x)[None]

    _close(tc_bsdf.evaluate(pt(), b(n), b(wo), b(wi), tangent=b(tan))[0],
           jx_bsdf.evaluate(pj, n, wo, wi, tangent=tan))
    _close(tc_bsdf.pdf_fn(pt(), b(n), b(wo), b(wi))[0], jx_bsdf.pdf_fn(pj, n, wo, wi))
    wi_t, pdf_t, f_t = tc_bsdf.sample(pt(), b(n), b(wo), tangent=b(tan),
                                      uniforms=tuple(torch.from_numpy(x)[None] for x in u))
    wi_j, pdf_j, f_j = jx_bsdf.sample_v(pj, jx_vec3.from_array(n), jx_vec3.from_array(wo), None,
                                        tangent=jx_vec3.from_array(tan),
                                        uniforms=tuple(jnp.asarray(x) for x in u))
    assert wi_t.shape == f_t.shape == (1, N, 3) and pdf_t.shape == (1, N)
    _close(wi_t[0], wi_j.to_array())
    _close(pdf_t[0], pdf_j, rtol=1e-4)
    _close(f_t[0], f_j.to_array(), rtol=1e-4)


def _vocalfold():
    """The vocalfold scene (resolution 6) in both packages from the
    reference's randomized parameters, with the uniform beam projector."""
    jscene, kw = jx_scenes.vocalfold(resolution=6, n_anim_frames=2)
    jp = {k: np.asarray(v) for k, v in jax.jit(jscene.compile())(jax.random.key(2), 0).items()}
    beams = jx_laser.generate_uniform_rays(0.0275, 12, 12)
    jp.update({k: v if isinstance(v, tuple) else np.asarray(v) for k, v in
               jx_laser.rays_to_beam_params(beams, 30.0, sigma=10.0,
                                            texture_size=(256, 256)).items()})
    jrs = JxBridge(jscene, **kw).assemble({k: v if isinstance(v, tuple) else jnp.asarray(v)
                                           for k, v in jp.items()})
    tb, _, _ = main_path.build("cpu", resolution=6)
    return jrs, tb.assemble([from_jax_params(jp, "cpu")])


def test_light_array_forms():
    jrs, trs = _vocalfold()
    assert trs.lights.count >= 1 and trs.projector is not None
    # Points on the camera rays' hits, where the emitters light the scene.
    o, d = jx_rays.camera_rays(jrs.camera, 16, 16)
    hit = jx_intersect.intersect_brute(o, d, jrs.geometry)
    p = np.asarray(o + d * hit.t[:, None])
    pt = torch.from_numpy(p)[None]
    for i in range(trs.lights.count):
        for got, ref in zip(tc_lights.eval_light(trs.lights, i, pt),
                            jx_lights.eval_light(jrs.lights, i, p)):
            _close(got[0], ref)
    for got, ref in zip(tc_lights.eval_projector(trs.projector, pt),
                        jx_lights.eval_projector(jrs.projector, p)):
        _close(got[0], ref, atol=1e-5 * float(np.abs(np.asarray(ref)).max()))
    got_all = tc_lights.total_incident(trs.lights, trs.projector, pt)
    ref_all = jx_lights.total_incident(jrs.lights, jrs.projector, p)
    for got_l, ref_l in zip(got_all, ref_all):
        assert len(got_l) == len(ref_l) == trs.lights.count + 1
        for got, ref in zip(got_l, ref_l):
            _close(got[0], ref, atol=1e-5 * float(np.abs(np.asarray(ref)).max()))
    key = jax.random.key(4)
    choice = jax.random.randint(key, (p.shape[0],), 0, trs.lights.count + 1)
    got = tc_lights.sample_one_light(trs.lights, trs.projector, pt, None,
                                     choice=torch.from_numpy(np.asarray(choice))[None])
    ref = jx_lights.sample_one_light(jrs.lights, jrs.projector, p, key)
    for g, r in zip(got, ref):
        _close(g[0], r, atol=1e-5 * float(np.abs(np.asarray(r)).max()))
    drawn = tc_lights.sample_one_light(trs.lights, trs.projector, pt,
                                       [torch.Generator().manual_seed(0)])
    assert all(torch.isfinite(x).all() for x in drawn)


def test_hit_attributes_v_and_vec3_helpers():
    jrs, trs = _vocalfold()
    o, d = jx_rays.camera_rays(jrs.camera, 16, 16)
    hit_j = jx_intersect.intersect_brute(o, d, jrs.geometry)
    ref = jx_intersect.hit_attributes_v(jx_vec3.from_array(o), jx_vec3.from_array(d), hit_j,
                                        jrs.geometry)
    ot, dt = tc_rays.camera_rays(trs.camera, 16, 16)
    hit_t = tc_intersect.intersect_brute(ot, dt, trs.geometry)
    np.testing.assert_array_equal(hit_t.prim[0].numpy(), np.asarray(hit_j.prim))
    got = tc_intersect.hit_attributes_v(tc_vec3.from_array(ot), tc_vec3.from_array(dt), hit_t,
                                        trs.geometry)
    valid = np.asarray(hit_j.valid)
    assert valid.mean() > 0.5
    for key in ("position", "normal", "t", "u", "v", "mat_id", "mesh_id"):
        g, r = got[key], ref[key]
        g = g.to_array() if isinstance(g, tc_vec3.Vec3) else g
        r = r.to_array() if isinstance(r, jx_vec3.Vec3) else r
        _close(g[0][valid].to(torch.float32), np.asarray(r, np.float32)[valid], rtol=1e-5,
               atol=1e-5)

    rng = np.random.default_rng(1)
    a, b, table = (rng.normal(size=(3, 8)).astype(np.float32) for _ in range(3))
    idx = np.array([3, 0, 7, 7])
    t = 0.3
    for got, ref in ((tc_vec3.lerp(t, tc_vec3.v3(*torch.from_numpy(a)), tc_vec3.v3(
                          *torch.from_numpy(b))),
                      jx_vec3.lerp(t, jx_vec3.v3(*a), jx_vec3.v3(*b))),
                     (tc_vec3.gather(tc_vec3.v3(*torch.from_numpy(table)), torch.from_numpy(idx)),
                      jx_vec3.gather(jx_vec3.v3(*table), jnp.asarray(idx)))):
        _close(got.to_array(), ref.to_array())
