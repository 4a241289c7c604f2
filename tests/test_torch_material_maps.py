"""Port parity for the material maps and the samplers the reference's farm
scene randomizes with, against the JAX package, on inputs made with numpy.

  * the texture-stack lookups (packed and unpacked, a stack shared by the
    batch and one a variant) to 1e-6;
  * the bridge's texture tables from `set_texture`, from both key
    spellings ("<mat>.base_color.data", "<mat>.brdf_0.base_color.data"),
    and from static roughness and normal maps with per-variant overrides,
    against the JAX bridge's, exactly;
  * `_shading_base_color` / `_shading_normal` to 1e-5;
  * the Gaussian, integer, scalar-to-vec3 and constant samplers' eval sweeps
    exactly and their train draws in range, and the sampler hooks'
    (`add_float_sampler`, `add_vec3_sampler`) keys through `compile()`,
    nested keys resolved by `canonical_param`, exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import fireflies_tpu as jff
import fireflies_tpu_torch as tff
from fireflies_tpu import sampling as jsampling
from fireflies_tpu.assets import procedural as jproc
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render import texture as jx_tex
from fireflies_tpu.render import types as jx_types
from fireflies_tpu.render import vec3 as jx_vec3
from fireflies_tpu.render.bridge import SceneBridge as JxBridge
from fireflies_tpu_torch import sampling as tsampling
from fireflies_tpu_torch.assets import procedural as tproc
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import texture as tc_tex
from fireflies_tpu_torch.render import types as tc_types
from fireflies_tpu_torch.render import vec3 as tc_vec3
from fireflies_tpu_torch.render.bridge import SceneBridge as TcBridge

torch.set_num_threads(1)

N = 2048


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_stack_lookups_match():
    rng = np.random.default_rng(0)
    stacks = rng.uniform(size=(2, 3, 16, 24, 3)).astype(np.float32)  # (B, M, H, W, C)
    index = rng.integers(0, 3, size=(2, N))
    uv = rng.uniform(-0.1, 1.1, size=(2, N, 2)).astype(np.float32)
    t_stacks, t_index, t_uv = (torch.as_tensor(x) for x in (stacks, index, uv))
    t_table = tc_tex.pack_neighborhood_stack(t_stacks)
    assert t_table.shape == (2, 3 * 16 * 24, 12)
    per_variant = [tc_tex.bilinear_sample_stack(t_stacks, t_index, t_uv),
                   tc_tex.bilinear_sample_stack_packed(t_table, 16, 24, t_index, t_uv)]
    for b in range(2):
        j_index, j_uv = jnp.asarray(index[b], jnp.int32), jnp.asarray(uv[b])
        ref = jx_tex.bilinear_sample_stack(jnp.asarray(stacks[b]), j_index, j_uv)
        j_table = jx_tex.pack_neighborhood_stack(jnp.asarray(stacks[b]))
        np.testing.assert_allclose(_np(tc_tex.pack_neighborhood_stack(t_stacks[b])),
                                   np.asarray(j_table), rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(jx_tex.bilinear_sample_stack_packed(
            j_table, 16, 24, j_index, j_uv)), np.asarray(ref), rtol=1e-6, atol=1e-6)
        shared = [tc_tex.bilinear_sample_stack(t_stacks[b], t_index[b], t_uv[b]),
                  tc_tex.bilinear_sample_stack_packed(t_table[b], 16, 24, t_index[b], t_uv[b])]
        for out in shared + [x[b] for x in per_variant]:
            np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=1e-6, atol=1e-6)


def _maps(seed, size=8):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(size, size, 3)).astype(np.float32),
            rng.uniform(size=(size, size)).astype(np.float32),
            rng.uniform(size=(size, size, 3)).astype(np.float32))


def _map_scene(ff, proc, sampling):
    """Three planes: mat-a with set_texture and a roughness map, mat-b with a
    texture sampler on the nested key and a normal map, mat-c plain."""
    scene = ff.Scene()
    base_a, rough_a, _ = _maps(1)
    base_b, _, normal_b = _maps(2)
    for i, name in enumerate("abc"):
        v, f, uv = proc.make_plane(0.5, 1)
        mesh = ff.Mesh("mesh-" + name, v + np.float32([i - 1.0, 0.0, 0.0]), f, uv)
        scene.add_mesh(mesh, material="mat-" + name)
        scene.add_material(ff.Material("mat-" + name))
    scene.material("mat-a").set_texture(base_a)
    scene.material("mat-a").set_roughness_texture(rough_a)
    scene.material("mat-b").add_vec3_sampler("brdf_0.base_color.data",
                                             sampling.ConstantSampler.of(base_b))
    scene.material("mat-b").set_normal_texture(normal_b)
    cam = ff.Transformable("PerspectiveCamera")
    w = np.eye(4, dtype=np.float32)
    w[2, 3] = 3.0
    cam.set_world(w)
    scene.set_camera(cam)
    return scene


def test_bridge_texture_tables_match():
    js, ts = _map_scene(jff, jproc, jsampling), _map_scene(tff, tproc, tsampling)
    jb, tb = JxBridge(js), TcBridge(ts)
    jp = jax.jit(js.compile())(jax.random.key(0), 0)
    tp = ts.compile("cpu")(torch.Generator().manual_seed(0), 0)
    assert {"mat-a.base_color.data", "mat-b.brdf_0.base_color.data"} <= set(tp)
    _, rough_o, normal_o = _maps(3)
    override = {"mat-a.roughness.data": rough_o, "mat-c.normalmap.data": normal_o}
    tm = tb.assemble([tp, dict(tp, **{k: torch.as_tensor(v) for k, v in override.items()})])
    tm = tm.materials
    # Both variants pass the same base-colour tensors (set_texture's, and the
    # ConstantSampler's), so that stack is shared: (M, H, W, C) without the
    # variant axis.  The overrides give each variant its own maps.
    assert tm.textures.dim() == 4 and tm.roughness_tex.dim() == tm.normal_tex.dim() == 5
    for b, extra in enumerate(({}, override)):
        jm = jb.assemble(dict(jp, **{k: jnp.asarray(v) for k, v in extra.items()})).materials
        for field in ("textures", "has_texture", "roughness_tex", "has_roughness_tex",
                      "normal_tex", "has_normal_tex"):
            got = getattr(tm, field)
            got = got if field == "textures" else got[b]
            np.testing.assert_array_equal(_np(got), np.asarray(getattr(jm, field)), err_msg=field)
    assert tm.has_normal_tex.tolist() == [[False, True, False], [False, True, True]]


def test_shading_base_color_and_normal_match():
    rng = np.random.default_rng(4)
    base, rough, normal = (rng.uniform(size=(2, 16, 16, c)).astype(np.float32)
                           for c in (3, 1, 3))
    has = np.array([True, False])
    mat_id = rng.integers(0, 2, size=N)
    uv = rng.uniform(size=(N, 2)).astype(np.float32)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tangent = rng.normal(size=(N, 3)).astype(np.float32)
    rows = dict(base_color=rng.uniform(size=(N, 3)).astype(np.float32),
                roughness=rng.uniform(size=N).astype(np.float32))

    jm = jx_types.Materials.default(2).replace(
        textures=jnp.asarray(base), has_texture=jnp.asarray(has),
        roughness_tex=jnp.asarray(rough), has_roughness_tex=jnp.asarray(has),
        normal_tex=jnp.asarray(normal), has_normal_tex=jnp.asarray(has))
    jscene = types.SimpleNamespace(materials=jm, projector=None)
    jattrs = dict(uv_x=jnp.asarray(uv[:, 0]), uv_y=jnp.asarray(uv[:, 1]),
                  mat_id=jnp.asarray(mat_id, jnp.int32),
                  tangent=jx_vec3.from_array(jnp.asarray(tangent)))
    jparams = jx_pt._shading_base_color(jscene, {k: jnp.asarray(v) for k, v in rows.items()},
                                        jattrs)
    jns = jx_pt._shading_normal(jscene, jattrs, jx_vec3.from_array(jnp.asarray(n)))

    def t1(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype)[None]

    zeros = torch.zeros(1, 2)
    tattrs = dict(uv_x=t1(uv[:, 0]), uv_y=t1(uv[:, 1]), mat_id=t1(mat_id, torch.long),
                  tangent=tc_vec3.from_array(t1(tangent)))
    # The maps as a per-variant (1, M, H, W, C) stack and as a shared
    # (M, H, W, C) one (what the bridge gives when every variant passes the
    # same maps).
    for stack in (t1, torch.as_tensor):
        tm = tc_types.Materials(
            **{f: zeros for f in ("roughness metallic specular spec_tint clearcoat "
                                  "clearcoat_gloss sheen sheen_tint anisotropic spec_trans "
                                  "flatness ior thin").split()},
            base_color=torch.zeros(1, 2, 3), emission=torch.zeros(1, 2, 3),
            textures=stack(base), has_texture=t1(has), roughness_tex=stack(rough),
            has_roughness_tex=t1(has), normal_tex=stack(normal), has_normal_tex=t1(has))
        tscene = types.SimpleNamespace(materials=tm, projector=None)
        tparams = tc_pt._shading_base_color(tscene, {k: t1(v) for k, v in rows.items()}, tattrs)
        tns = tc_pt._shading_normal(tscene, tattrs, tc_vec3.from_array(t1(n)))
        for k in ("base_color", "roughness"):
            np.testing.assert_allclose(_np(tparams[k][0]), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(_np(tns.to_array()[0]), np.asarray(jns.to_array()),
                                   rtol=1e-5, atol=1e-6)
    mapped = (has[mat_id])
    assert np.abs(_np(tns.to_array()[0])[mapped] - n[mapped]).max() > 0.1


def test_samplers_and_hooks_match():
    pairs = [
        (jsampling.GaussianSampler.create([0.5, 1.0], [0.2, 0.3]),
         tsampling.GaussianSampler.create([0.5, 1.0], [0.2, 0.3])),
        (jsampling.UniformIntegerSampler.create([0, 3], [5, 4]),
         tsampling.UniformIntegerSampler.create([0, 3], [5, 4])),
        (jsampling.UniformScalarToVec3Sampler.create(5.0, 25.0),
         tsampling.UniformScalarToVec3Sampler.create(5.0, 25.0)),
        (jsampling.ConstantSampler.of([1.0, 2.0, 3.0]), tsampling.ConstantSampler.of([1.0, 2.0, 3.0])),
    ]
    gen = torch.Generator().manual_seed(0)
    for js, ts in pairs:
        for step in (0, 1, 7, 2003):
            np.testing.assert_array_equal(_np(ts.sample(gen, step, train=False, device="cpu")),
                                          np.asarray(js.sample(None, step, train=False)))
        draws = ts.sample(gen, 0, train=True).numpy()
        ref = np.asarray(js.sample(jax.random.key(0), 0, train=True))
        assert draws.shape == ref.shape and draws.dtype == ref.dtype
    gauss, integer, grey, _ = (torch.stack([p[1].sample(gen) for _ in range(2000)]).numpy()
                               for p in pairs)
    np.testing.assert_allclose(gauss.mean(0), [0.5, 1.0], atol=0.02)
    np.testing.assert_allclose(gauss.std(0), [0.2, 0.3], rtol=0.06)
    assert set(integer[:, 0]) == {0, 1, 2, 3, 4} and set(integer[:, 1]) == {3}
    assert (grey[:, 0] == grey[:, 2]).all() and 5.0 <= grey.min() and grey.max() < 25.0

    def scene(ff, sampling):
        sc = ff.Scene()
        v, f = (jproc if ff is jff else tproc).make_plane()[:2]
        sc.add_mesh(ff.Mesh("mesh-plane", v, f), material="mat-p")
        mat = ff.Material("mat-p")
        mat.add_float_sampler("brdf_0.roughness.value", sampling.UniformSampler.create(0.1, 0.9))
        mat.set_texture(np.full((4, 4, 3), 0.25, np.float32))
        sc.add_material(mat)
        light = ff.Light("emit-Spot", kind="spot", intensity=(12.0, 12.0, 12.0))
        light.add_vec3_sampler("intensity.value",
                               sampling.UniformScalarToVec3Sampler.create(5.0, 25.0))
        light.add_float_sampler("radius", sampling.ConstantSampler.of(0.05))
        sc.add_light(light)
        cam = ff.Transformable("PerspectiveCamera")
        sc.set_camera(cam)
        sc.eval()
        return sc

    jfn, tfn = jax.jit(scene(jff, jsampling).compile()), scene(tff, tsampling).compile("cpu")
    for step in (0, 3, 12):
        jp = jfn(jax.random.key(step), step)
        tp = tfn(torch.Generator().manual_seed(step), step)
        assert set(jp) == set(tp)
        for k in ("emit-Spot.intensity.value", "emit-Spot.intensity", "emit-Spot.radius",
                  "mat-p.brdf_0.roughness.value", "mat-p.roughness", "mat-p.base_color.data"):
            np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]), err_msg=k)
