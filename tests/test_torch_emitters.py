"""Port parity for the emitters' sampling (render/lights.py) against the
JAX functions, with the reference's own draws (made from the key the way
it splits it) fed to the port as `uniforms=`:

  * the envmap lookup, its importance-sampling distribution, NEE samples
    and the pdf of a direction to 1e-5 (relative, 1e-6 absolute; near the
    poles the pdf's relative tolerance grows with the gain of
    sin(acos(y)) on y's rounding); the pdf
    integrates to 1 and is the sampler's own density (E[1 / pdf] = 4 pi)
    within 5%, as tests/test_envmap_nee.py holds the reference;
  * `sample_area_light` and `area_pdf_of_hit` to 1e-5, on two variants;
  * the bridge's emissive faces, light radii, projector aperture, envmap
    and `background_to_world` equal to the JAX `RenderScene`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import fireflies_tpu as jff
import fireflies_tpu_torch as tff
from fireflies_tpu import sampling as jsampling
from fireflies_tpu.assets import procedural as jproc
from fireflies_tpu.assets import scenes as jscenes
from fireflies_tpu.render import lights as jx_lights
from fireflies_tpu.render import texture as jx_tex
from fireflies_tpu.render import types as jx_types
from fireflies_tpu.render.bridge import SceneBridge as JxBridge
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch import sampling as tsampling
from fireflies_tpu_torch.assets import procedural as tproc
from fireflies_tpu_torch.assets import scenes as tscenes
from fireflies_tpu_torch.render import lights as tc_lights
from fireflies_tpu_torch.render import texture as tc_tex
from fireflies_tpu_torch.render import types as tc_types
from fireflies_tpu_torch.render.bridge import SceneBridge as TcBridge

torch.set_num_threads(1)

N = 4096


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(_np(ours), np.asarray(theirs), rtol=rtol, atol=atol)


def _envmap():
    """A dim, coloured envmap with one bright texel (as
    tests/test_envmap_nee.py's spot envmap, with a gradient)."""
    rng = np.random.default_rng(0)
    tex = (0.02 + 0.2 * rng.uniform(size=(16, 32, 3))).astype(np.float32)
    tex[4, 0] = 60.0
    return tex


def _dirs(seed, n=N):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_envmap_lookup_distribution_and_nee_match():
    env = _envmap()
    d = _dirs(1)

    @jax.jit
    def reference(env, d, key):
        dist = jx_lights.envmap_distribution(env)
        wi, pdf = jx_lights.sample_envmap_nee(dist, N, key)
        # The draws sample_envmap_nee makes: its key split into the cell's
        # and the jitter's.
        k_cell, k_jit = jax.random.split(key)
        return (dist["cdf"], dist["pmf"],
                jx_lights.envmap_pdf_of_dir(dist, d[:, 0], d[:, 1], d[:, 2]), wi.to_array(), pdf,
                jax.random.uniform(k_cell, (N,)), jax.random.uniform(k_jit, (2, N)))

    cdf, pmf, pdf_dir, wi_j, pdf_j, u, jit = (
        np.array(x) for x in reference(jnp.asarray(env), jnp.asarray(d), jax.random.key(3)))
    # The lookup eagerly: XLA's fused atan2 and acos round differently.
    look = jx_tex.sample_envmap(jnp.asarray(env), *(jnp.asarray(d[:, k]) for k in range(3)))
    t_env, t_d = torch.as_tensor(env), [torch.as_tensor(d[:, k]) for k in range(3)]
    _close(tc_tex.sample_envmap(t_env, *t_d), look)
    td = tc_lights.envmap_distribution(t_env)
    _close(td["cdf"], cdf)
    _close(td["pmf"], pmf)
    # Near a pole sin(acos(y)) turns y's rounding into a relative error of
    # about 6e-8 |y| / (1 - y^2): the tolerance grows by that gain.
    pole_gain = np.abs(d[:, 1]) / np.maximum(1.0 - d[:, 1] ** 2, 1e-12)
    ours = _np(tc_lights.envmap_pdf_of_dir(td, *t_d))
    assert (np.abs(ours - pdf_dir) <= 1e-6 + (1e-5 + 1e-6 * pole_gain) * np.abs(pdf_dir)).all()
    assert (pole_gain < 10).mean() > 0.95

    # The port samples the reference's distribution with its draws.
    jd_t = {"cdf": torch.as_tensor(cdf), "pmf": torch.as_tensor(pmf), "h": 16, "w": 32}
    wi_t, pdf_t = tc_lights.sample_envmap_nee(
        jd_t, N, uniforms=tuple(torch.as_tensor(x)[None] for x in (u, jit[0], jit[1])))
    _close(wi_t.to_array()[0], wi_j)
    _close(pdf_t[0], pdf_j)

    # A density: its integral over the sphere is 1, and the sampler draws
    # by it (E[1 / pdf] over its own samples = 4 pi).
    big = _dirs(2, 200_000)
    pdf = tc_lights.envmap_pdf_of_dir(td, *(torch.as_tensor(big[:, k]) for k in range(3)))
    assert abs(float(pdf.mean()) * 4 * np.pi - 1.0) < 0.05
    _, pdf_s = tc_lights.sample_envmap_nee(td, 200_000, [torch.Generator().manual_seed(1)])
    assert abs(float((1.0 / pdf_s).mean()) / (4 * np.pi) - 1.0) < 0.05


def _emissive_geometry():
    """Four emissive faces of different areas among six, two variants with
    different vertices, two materials."""
    rng = np.random.default_rng(5)
    verts = rng.uniform(-1, 1, size=(2, 12, 3)).astype(np.float32)
    faces = np.arange(18, dtype=np.int32).reshape(6, 3) % 12
    face_mat = np.array([0, 1, 1, 0, 1, 0], np.int32)
    emissive = np.array([1, 2, 4, 5], np.int32)
    emission = np.array([[[0, 0, 0], [4, 3, 2]], [[0, 0, 0], [1, 5, 2]]], np.float32)
    emission[:, 0] = [0.5, 0.5, 0.5]  # face 5's material emits too
    return verts, faces, face_mat, emissive, emission


def test_area_light_matches():
    verts, faces, face_mat, emissive, emission = _emissive_geometry()
    tgeo = tc_types.Geometry(vertices=torch.as_tensor(verts), faces=torch.as_tensor(faces).long(),
                             face_mat=torch.as_tensor(face_mat).long(),
                             face_mesh=torch.zeros(6, dtype=torch.long),
                             emissive_faces=torch.as_tensor(emissive).long())
    tmats = types_materials(torch.as_tensor(emission))
    p = np.random.default_rng(6).uniform(-2, 2, size=(2, N, 3)).astype(np.float32)
    prim = np.random.default_rng(7).integers(-1, 6, size=(2, N))
    @jax.jit
    def reference(verts, emission, p, prim, key):
        jgeo = jx_types.Geometry(vertices=verts, faces=jnp.asarray(faces),
                                 face_mat=jnp.asarray(face_mat),
                                 face_mesh=jnp.zeros(6, jnp.int32),
                                 emissive_faces=jnp.asarray(emissive))
        jmats = jx_types.Materials.default(2).replace(emission=emission)
        out = jx_lights.sample_area_light(jgeo, jmats, p, key)
        # The draws sample_area_light makes: its key split into the face's
        # and the barycentrics'.
        k_face, k_uv = jax.random.split(key)
        uv = jax.random.uniform(k_uv, (N, 2))
        return out + (jx_lights.area_pdf_of_hit(jgeo, prim),), (
            jax.random.uniform(k_face, (N,)), uv[:, 0], uv[:, 1])

    draws, refs = [], []
    for b in range(2):
        ref, drawn = reference(jnp.asarray(verts[b]), jnp.asarray(emission[b]), jnp.asarray(p[b]),
                               jnp.asarray(prim[b], jnp.int32), jax.random.key(10 + b))
        refs.append([np.asarray(x) for x in ref])
        draws.append([np.asarray(x) for x in drawn])
    uniforms = tuple(torch.as_tensor(np.stack([d[k] for d in draws])) for k in range(3))
    outs = tc_lights.sample_area_light(tgeo, tmats, torch.as_tensor(p), uniforms=uniforms)
    outs += (tc_lights.area_pdf_of_hit(tgeo, torch.as_tensor(prim)),)
    for b in range(2):
        for ours, theirs in zip(outs, refs[b]):
            _close(ours[b], theirs)
    assert float(outs[-1].min()) == 0.0 and float(outs[-1].max()) > 0.0


def types_materials(emission):
    zeros = torch.zeros(emission.shape[:2])
    return tc_types.Materials(
        **{f: zeros for f in ("roughness metallic specular spec_tint clearcoat clearcoat_gloss "
                              "sheen sheen_tint anisotropic spec_trans flatness ior thin").split()},
        base_color=torch.zeros_like(emission), emission=emission)


def _emitter_scene(ff, proc, scenes, sampling):
    """cornell_like with an emissive lamp, a radius on its light and a
    projector (the bridge gives it an aperture)."""
    scene, kw = scenes.cornell_like()
    v, f, uv = proc.make_plane(0.3, 1)
    lamp = ff.Mesh("mesh-lamp", v, f, uv)
    w = np.eye(4, dtype=np.float32)
    w[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    w[:3, 3] = [0.0, 0.98, 0.0]
    lamp.set_world(w)
    scene.add_mesh(lamp, material="mat-lamp")
    scene.add_material(ff.Material("mat-lamp", emission=(8.0, 8.0, 8.0)))
    scene.light("light-top").add_float_sampler("radius", sampling.ConstantSampler.of(0.05))
    proj = ff.Transformable("Projector")
    proj.set_world(np.eye(4, dtype=np.float32))
    scene.set_projector(proj)
    return scene, kw


def test_bridge_emitters_match():
    env = main_path.sky_envmap((8, 16))
    rot = np.array([[0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 0, 1]], np.float32)
    kw_extra = dict(background=env, background_to_world=rot, projector_aperture=0.02)
    js, jkw = _emitter_scene(jff, jproc, jscenes, jsampling)
    ts, tkw = _emitter_scene(tff, tproc, tscenes, tsampling)
    jb, tb = JxBridge(js, **jkw, **kw_extra), TcBridge(ts, **tkw, **kw_extra)
    jp = jax.jit(js.compile())(jax.random.key(0), 0)
    tp = ts.compile("cpu")(torch.Generator().manual_seed(0), 0)
    jr, tr = jb.assemble(jp), tb.assemble([tp, tp])
    np.testing.assert_array_equal(_np(tr.geometry.emissive_faces), np.asarray(jr.geometry.emissive_faces))
    assert len(tr.geometry.emissive_faces) == 2
    for b in range(2):
        np.testing.assert_array_equal(_np(tr.lights.radius[b]), np.asarray(jr.lights.radius))
        np.testing.assert_array_equal(_np(tr.projector.aperture[b]), np.asarray(jr.projector.aperture))
        np.testing.assert_array_equal(_np(tr.materials.emission[b]), np.asarray(jr.materials.emission))
    np.testing.assert_array_equal(_np(tr.background), np.asarray(jr.background))
    np.testing.assert_array_equal(_np(tr.background_to_world), np.asarray(jr.background_to_world))
