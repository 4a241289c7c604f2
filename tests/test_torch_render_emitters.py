"""Port parity for whole renders with the emitters and lobes of this slice,
on a 128x16 film (one 2048-ray tile):

  * a scene with an area light (an emissive quad), an envmap under a
    rotated `background_to_world` (with its NEE), a point light with a
    soft-shadow aperture and a low-poly glass sphere (54 faces), 2
    bounces, rendered by both packages over 64 seeds at spp 1: the film's
    per-channel means, and each 16x16 block's, agree within 3 standard
    errors, computed from both renders' variance over the seeds; the
    film's standard error is held under 1% of its mean (the realized one
    is about 0.6%), so the comparison resolves a few percent;
  * a uniform envmap over a diffuse quad against its analytic value a L
    (tests/test_envmap_nee.py's check: NEE and BSDF escapes weighed by MIS,
    no double count), within 5%;
  * the shared first vertex (`shared_primary`: one set of vertex-0
    aperture, envmap and area-light draws, fresh bounce draws a sample)
    against the per-sample path at the same noise floor;
  * tests/test_mb3_grad_nan.py's scene with every lobe on (flags None):
    d(mean image)/d(dx) at max_bounces=2 equals the reference's exact 0.0
    at this film and spp 2, and at max_bounces=3 it is finite, where the
    reference's is NaN.  The 0.0 is structural: dx slides the blocker
    within its own plane, so no hit point, normal or distance depends on
    it and without edge sampling every path's derivative is 0.  The
    reference's two gradients take minutes to compile on the CPU, so they
    are not computed here: `python tests/test_torch_render_emitters.py`
    prints them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

W, H, SEEDS = 128, 16, 8
SCENE_SEEDS = 64  # the emitter scene's renders in each package

torch.set_num_threads(1)


def _build(ff, proc, sampling, look_at_np):
    """Floor and back wall, an emissive lamp quad, a glass sphere
    (make_sphere(0.35, 4, 8): 48 faces) and a point light with radius 0.1."""
    scene = ff.Scene()

    def plane(name, world, size=1.0, **mat):
        v, f, uv = proc.make_plane(size, 1)
        mesh = ff.Mesh("mesh-" + name, v, f, uv)
        mesh.set_world(np.asarray(world, np.float32))
        scene.add_mesh(mesh, material="mat-" + name)
        scene.add_material(ff.Material("mat-" + name, **mat))

    def pose(rot, t):
        w = np.eye(4, dtype=np.float32)
        w[:3, :3], w[:3, 3] = rot, t
        return w

    plane("floor", pose([[1, 0, 0], [0, 0, 1], [0, -1, 0]], [0, -1, 0]), base_color=(0.7,) * 3)
    plane("back", pose(np.eye(3), [0, 0, -1]), base_color=(0.6, 0.5, 0.4))
    plane("lamp", pose([[1, 0, 0], [0, 0, -1], [0, 1, 0]], [0, 0.98, 0]), size=0.3,
          emission=(8.0, 8.0, 8.0))
    v, f, uv = proc.make_sphere(0.35, rings=4, segments=8)
    sphere = ff.Mesh("mesh-sphere", v, f, uv)
    sphere.set_world(pose(np.eye(3), [0.0, -0.6, 0.0]))
    scene.add_mesh(sphere, material="mat-sphere")
    scene.add_material(ff.Material("mat-sphere", spec_trans=1.0, roughness=0.2, ior=1.5))
    cam = ff.Transformable("PerspectiveCamera")
    cam.set_world(look_at_np((0.0, 0.0, 2.8), (0.0, 0.0, 0.0)))
    scene.set_camera(cam)
    light = ff.Light("light-top", kind="point", intensity=(4.0, 4.0, 4.0))
    light.set_world(pose(np.eye(3), [0.5, 0.6, 0.5]))
    light.add_float_sampler("radius", sampling.ConstantSampler.of(0.1))
    scene.add_light(light)
    env = np.full((16, 32, 3), 0.3, np.float32)
    env[4, 8] = 50.0
    rot = pose([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]], [0, 0, 0])
    return scene, dict(camera_fov=50.0, background=env, background_to_world=rot)


def _torch_scene(copies):
    import fireflies_tpu_torch as tff
    from fireflies_tpu_torch import sampling
    from fireflies_tpu_torch.assets import procedural
    from fireflies_tpu_torch.render import SceneBridge
    from fireflies_tpu_torch.utils.math import look_at_np

    scene, kw = _build(tff, procedural, sampling, look_at_np)
    params = scene.compile("cpu")(torch.Generator().manual_seed(0), 0)
    return SceneBridge(scene, **kw).assemble([params] * copies)


def _torch_render(cfg, seeds):
    from fireflies_tpu_torch import main_path
    from fireflies_tpu_torch.render import render_rgb

    with torch.no_grad():
        return render_rgb(_torch_scene(len(seeds)), main_path.generators(seeds, "cpu"),
                          cfg).numpy()


def _mean_and_se(imgs):
    """Per-channel film mean over (seeds, pixels) and its standard error
    from each pixel's variance over the seeds."""
    k = imgs.shape[0]
    var = imgs.var(axis=0, ddof=1).reshape(-1, 3)
    return imgs.mean(axis=(0, 1, 2)), np.sqrt(var.sum(0) / k) / var.shape[0]


def _block_means_and_se(imgs, size=16):
    """Per-channel mean of each size x size block over (seeds, pixels) and
    its standard error from the variance of the block's mean over the
    seeds; each (H / size, W / size, 3)."""
    k, h, w, c = imgs.shape
    blocks = imgs.reshape(k, h // size, size, w // size, size, c).mean(axis=(2, 4))
    return blocks.mean(0), blocks.std(0, ddof=1) / np.sqrt(k)


def test_emitter_scene_mean_agrees():
    import fireflies_tpu as jff
    from fireflies_tpu import sampling
    from fireflies_tpu.assets import procedural
    from fireflies_tpu.render import RenderConfig, SceneBridge, render_rgb
    from fireflies_tpu.utils.math import look_at_np

    from fireflies_tpu_torch.render import RenderConfig as TcConfig

    scene, kw = _build(jff, procedural, sampling, look_at_np)
    rs = SceneBridge(scene, **kw).assemble(jax.jit(scene.compile())(jax.random.key(0), 0))
    assert rs.materials.flags == {"trans"} and rs.geometry.faces.shape == (54, 3)
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=2)
    img_j = np.asarray(jax.jit(jax.vmap(lambda k: render_rgb(rs, k, cfg)))(
        jax.random.split(jax.random.key(1), SCENE_SEEDS)))
    img_t = _torch_render(TcConfig(width=W, height=H, spp=1, max_bounces=2), range(SCENE_SEEDS))
    assert np.isfinite(img_t).all() and img_t.shape == img_j.shape
    (m_j, se_j), (m_t, se_t) = _mean_and_se(img_j), _mean_and_se(img_t)
    se = np.sqrt(se_j ** 2 + se_t ** 2)
    assert (np.abs(m_t - m_j) <= 3 * se).all(), (m_t, m_j, se)
    assert (se < 0.01 * m_j).all(), se / m_j
    (b_j, bse_j), (b_t, bse_t) = _block_means_and_se(img_j), _block_means_and_se(img_t)
    bse = np.sqrt(bse_j ** 2 + bse_t ** 2)
    assert (np.abs(b_t - b_j) <= 3 * bse).all(), (np.abs(b_t - b_j) / bse).max()


def test_uniform_envmap_matches_analytic():
    """Uniform envmap L over a large diffuse quad of albedo a, seen from
    below its centre: each pixel's radiance is a L."""
    from fireflies_tpu_torch import main_path
    from fireflies_tpu_torch.render import RenderConfig, render_rgb
    from fireflies_tpu_torch.render.types import Camera, Geometry, Lights, Materials, RenderScene

    light, albedo = 1.5, 0.6
    verts = torch.tensor([[[-10, -10, -2.0], [10, -10, -2.0], [10, 10, -2.0], [-10, 10, -2.0]]])
    geo = Geometry(vertices=verts, faces=torch.tensor([[0, 1, 2], [0, 2, 3]]),
                   face_mat=torch.zeros(2, dtype=torch.long),
                   face_mesh=torch.zeros(2, dtype=torch.long))
    one = torch.ones(1, 1)
    mats = Materials(base_color=torch.full((1, 1, 3), albedo), roughness=one, metallic=0 * one,
                     specular=0 * one, spec_tint=0 * one, clearcoat=0 * one,
                     clearcoat_gloss=one, sheen=0 * one, sheen_tint=0.5 * one,
                     anisotropic=0 * one, spec_trans=0 * one, flatness=0 * one,
                     ior=1.5 * one, thin=0 * one, emission=torch.zeros(1, 1, 3))
    lights = Lights(kinds=(), to_world=torch.zeros(1, 0, 4, 4), intensity=torch.zeros(1, 0, 3),
                    cutoff_cos=torch.zeros(1, 0), beam_cos=torch.zeros(1, 0),
                    active=torch.zeros(1, 0, dtype=torch.bool))
    cam = Camera(to_world=torch.eye(4)[None], fov=torch.tensor([45.0]),
                 near=torch.tensor([0.01]), far=torch.tensor([1000.0]))
    scene = RenderScene(geometry=geo, materials=mats, lights=lights, camera=cam,
                        background=torch.full((8, 16, 3), light))
    with torch.no_grad():
        img = render_rgb(scene, main_path.generators([2], "cpu"),
                         RenderConfig(width=W, height=H, spp=16, max_bounces=2))
    assert float(img.mean()) == pytest.approx(albedo * light, rel=0.05)


def test_shared_primary_agrees_with_per_sample():
    from fireflies_tpu_torch.render import RenderConfig

    cfg = RenderConfig(width=W, height=H, spp=2, max_bounces=2)
    (m_s, se_s), (m_p, se_p) = (
        _mean_and_se(_torch_render(cfg.replace(shared_primary=shared), range(s0, s0 + SEEDS)))
        for shared, s0 in ((True, 100), (False, 200)))
    assert (np.abs(m_s - m_p) <= 3 * np.sqrt(se_s ** 2 + se_p ** 2)).all(), (m_s, m_p)


QUADS = np.array([
    [[-1, -1, -2], [1, -1, -2], [1, 1, -2], [-1, 1, -2]],
    [[-2, -1.2, 0], [2, -1.2, 0], [2, 1.5, 0], [-2, 1.5, 0]],
    [[-3, -4, -2.4], [3, -4, -2.4], [3, -4, -0.8], [-3, -4, -0.8]],
    [[-1, -2, -1.4], [1, -2, -1.4], [1, -2, -0.6], [-1, -2, -0.6]]], np.float32)
MB3_CFG = dict(width=W, height=H, spp=2)


def _mb3_grad(max_bounces: int) -> float:
    """tests/test_mb3_grad_nan.py's scene in the port: wall A, wall B, an
    emissive panel (emission without emissive_faces) and a grey blocker
    moved by dx along x; d(mean red)/d(dx) at dx = 1."""
    from fireflies_tpu_torch.render import RenderConfig, render_rgb
    from fireflies_tpu_torch.render.types import Camera, Geometry, Lights, Materials, RenderScene

    dx = torch.tensor(1.0, requires_grad=True)
    quads = torch.as_tensor(QUADS)
    blocker = quads[3] + torch.stack([dx, torch.zeros_like(dx), torch.zeros_like(dx)])
    faces = [f for q in range(4) for f in ([4 * q, 4 * q + 1, 4 * q + 2],
                                           [4 * q, 4 * q + 2, 4 * q + 3])]
    geo = Geometry(vertices=torch.cat([quads[:3].reshape(-1, 3), blocker])[None],
                   faces=torch.tensor(faces), face_mat=torch.tensor([0, 0, 0, 0, 1, 1, 0, 0]),
                   face_mesh=torch.tensor([0, 0, 1, 1, 2, 2, 3, 3]))
    one = torch.ones(1, 2)
    mats = Materials(base_color=torch.tensor([[[0.8] * 3, [0.0] * 3]]), roughness=one,
                     metallic=0 * one, specular=0 * one, spec_tint=0 * one, clearcoat=0 * one,
                     clearcoat_gloss=one, sheen=0 * one, sheen_tint=0.5 * one,
                     anisotropic=0 * one, spec_trans=0 * one, flatness=0 * one, ior=1.5 * one,
                     thin=0 * one, emission=torch.tensor([[[0.0] * 3, [24.0] * 3]]), flags=None)
    lights = Lights(kinds=(), to_world=torch.zeros(1, 0, 4, 4), intensity=torch.zeros(1, 0, 3),
                    cutoff_cos=torch.zeros(1, 0), beam_cos=torch.zeros(1, 0),
                    active=torch.zeros(1, 0, dtype=torch.bool))
    cam = Camera(to_world=torch.eye(4)[None], fov=torch.tensor([60.0]),
                 near=torch.tensor([0.01]), far=torch.tensor([1000.0]))
    scene = RenderScene(geometry=geo, materials=mats, lights=lights, camera=cam)
    img = render_rgb(scene, [torch.Generator().manual_seed(0)],
                     RenderConfig(max_bounces=max_bounces, **MB3_CFG))
    assert float(img.detach().max()) > 0
    img[..., 0].mean().backward()
    return float(dx.grad)


def test_mb3_gradient_finite_where_the_reference_nans():
    # The reference at this film: 0.0 at max_bounces=2, NaN at 3 (see the
    # module docstring for the script that prints them).  The 0.0 is
    # structural: dx moves the blocker within its own plane, so nothing a
    # path reads depends on it.
    assert _mb3_grad(2) == 0.0
    assert np.isfinite(_mb3_grad(3))


if __name__ == "__main__":
    # The reference's gradients on the mb=3 scene at MB3_CFG (several
    # minutes of compilation on the CPU).
    import sys
    from pathlib import Path

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(Path(__file__).parent))
    import test_mb3_grad_nan as ref

    from fireflies_tpu.render import RenderConfig
    from fireflies_tpu.render.pathtracer import render_rgb

    for mb in (2, 3):
        cfg = RenderConfig(max_bounces=mb, tri_chunk=16, **MB3_CFG)
        grad = jax.grad(lambda dx, cfg=cfg: jnp.mean(
            render_rgb(ref._scene(dx), jax.random.key(0), cfg)[..., 0]))(jnp.asarray(1.0))
        print(f"max_bounces={mb}: d(mean image)/d(dx) = {float(grad)}")
