"""Port parity for the warped-area render (`RenderConfig(reparam=True)`)
and its pose step:

  * `render_rgb(reparam=True)` on tests/test_reparam.py's emissive quad
    moving towards the camera (a pure boundary term: the detached render's
    gradient is 0) at max_bounces=1, 128x32, with JAX's jitter and
    constellation draws injected into the port (no emitter is sampled, so
    the render is deterministic given them): the image within 1e-5 of
    JAX's, and d(mean image)/d(dz) within 1e-3 relative, the tolerance of
    the warp's second derivatives through float32 reciprocals;
  * `reparam_indirect` (max_bounces=3, the first bounce warped) on an
    emissive quad before an emissive diffuse backdrop (base lobes only,
    which keeps JAX's compile short), the quad moving towards the camera,
    so that the backdrop's bounce sees its silhouette:
    with JAX's draws injected (both passes' jitter, the camera's and the
    bounce's constellations, the BSDF uniforms of both bounces) the image
    within 1e-5 of JAX's and d(mean image)/d(dz) within 1e-3 relative; the
    warped bounce's share of that gradient is held well above the
    tolerance, so the hook (offset origin, bounce gate, throughput x area)
    is what the comparison checks;
  * `reparam_indirect` on that scene with every lobe: the warped
    directions keep the image's value, and the gradient is finite with the
    warped bounce and without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.render import RenderConfig as JxConfig
from fireflies_tpu.render import pathtracer as jx_pt
from fireflies_tpu.render.types import Camera as JxCamera
from fireflies_tpu.render.types import Geometry as JxGeometry
from fireflies_tpu.render.types import Lights as JxLights
from fireflies_tpu.render.types import Materials as JxMaterials
from fireflies_tpu.render.types import RenderScene as JxScene
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import pathtracer as tc_pt
from fireflies_tpu_torch.render import rays as tc_rays
from fireflies_tpu_torch.render import reparam as tc_reparam
from fireflies_tpu_torch.render import types as tc

torch.set_num_threads(1)

W, H = 128, 32
FOV, HALF, Z = 60.0, 0.5, -2.0
EMISSION = np.array([2.0, 1.0, 0.5], np.float32)
K_AUX, RADIUS = 8, 0.06
QUAD = np.array([[-HALF, -HALF, Z], [HALF, -HALF, Z], [HALF, HALF, Z], [-HALF, HALF, Z]],
                np.float32)
FACES = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
MAT_FIELDS = ("base_color roughness metallic specular spec_tint clearcoat clearcoat_gloss sheen "
              "sheen_tint anisotropic spec_trans flatness ior thin emission").split()


def _jx_scene(verts, faces, emission, flags=None):
    n_f = faces.shape[0]
    geo = JxGeometry(vertices=verts, faces=jnp.asarray(faces),
                     face_mat=jnp.asarray(np.arange(n_f) // 2, jnp.int32),
                     face_mesh=jnp.zeros(n_f, jnp.int32))
    mats = JxMaterials.default(len(emission)).replace(emission=jnp.asarray(emission), flags=flags)
    return JxScene(geometry=geo, materials=mats, lights=JxLights.empty(),
                   camera=JxCamera.create(jnp.eye(4), fov=FOV))


def _tc_scene(verts, faces, emission, flags=None):
    """The port's scene of the same quad(s), one variant."""
    n_f, n_m = faces.shape[0], len(emission)
    jm = JxMaterials.default(n_m)
    mats = tc.Materials(**{f: torch.tensor(np.asarray(getattr(jm, f)))[None] for f in MAT_FIELDS
                           if f != "emission"}, emission=torch.tensor(emission)[None],
                         flags=flags)
    geo = tc.Geometry(vertices=verts[None], faces=torch.tensor(faces).long(),
                      face_mat=torch.tensor(np.arange(n_f) // 2).long(),
                      face_mesh=torch.zeros(n_f, dtype=torch.long))
    lights = tc.Lights(kinds=(), to_world=torch.zeros(1, 0, 4, 4), intensity=torch.zeros(1, 0, 3),
                       cutoff_cos=torch.zeros(1, 0), beam_cos=torch.zeros(1, 0),
                       active=torch.zeros(1, 0, dtype=torch.bool))
    cam = tc.Camera(to_world=torch.eye(4)[None], fov=torch.tensor([FOV]),
                    near=torch.tensor([0.01]), far=torch.tensor([1000.0]))
    return tc.RenderScene(geometry=geo, materials=mats, lights=lights, camera=cam)


def _jax_draws(key, n=W * H, k_aux=K_AUX, bounces=0, indirect=0, n_bsdf=3):
    """The uniforms JAX's render_rgb(reparam=True) draws at spp 1, in the
    order the port draws them: the value pass's jitter (tile-major) and the
    BSDF uniforms (u_sel, u1, u2; n_bsdf 5 adds the transmission lobe's u3,
    u4) of its first `bounces` bounces, the
    warped pass's jitter (row-major), its constellation, and its bounces'
    BSDF uniforms, each of the first `indirect` followed by the bounce's
    constellation."""
    m = k_aux + tc_reparam._n_scout(k_aux)

    def bsdf(k_path, bounce):
        bkey = jax.random.fold_in(k_path, bounce)
        ks = jax.random.split(jax.random.fold_in(bkey, 1), 5)
        return bkey, jnp.stack([jax.random.uniform(k, (n,)) for k in ks[:n_bsdf]])

    k_primal, k_grad = jax.random.split(key)
    k_pix, k_path = jax.random.split(jax.random.split(k_primal, 1)[0])
    draws = [jax.random.uniform(k_pix, (n, 2))]
    draws += [bsdf(k_path, i)[1] for i in range(bounces)]
    k_pix, k_path = jax.random.split(jax.random.split(k_grad, 1)[0])
    k_jit, k_warp = jax.random.split(k_pix)
    draws += [jax.random.uniform(k_jit, (n, 2)), jax.random.uniform(k_warp, (1, m, 2))]
    for i in range(bounces):
        bkey, u = bsdf(k_path, i)
        draws.append(u)
        if i < indirect:
            draws.append(jax.random.uniform(jax.random.fold_in(bkey, 11), (1, m, 2)))
    return [np.asarray(x) for x in draws]


@pytest.fixture
def injected(monkeypatch):
    """Replace the port's draws by a queue of given arrays, by shape."""
    queue: list = []

    def fake_uniform(gens, shape, device):
        for i, x in enumerate(queue):
            if x.shape == tuple(shape):
                return torch.tensor(queue.pop(i))[None].to(device)
        raise AssertionError(f"unexpected draw of shape {shape}")

    for mod in (tc_pt, tc_rays, tc_reparam):
        monkeypatch.setattr(mod, "uniform", fake_uniform)
    return queue


def test_render_rgb_reparam_matches_jax(injected):
    key = jax.random.key(3)
    cfg = dict(width=W, height=H, spp=1, max_bounces=1, reparam=True, reparam_k_aux=K_AUX,
               reparam_radius=RADIUS)

    def jx_mean(dz):
        verts = jnp.asarray(QUAD) + jnp.stack([0 * dz, 0 * dz, dz])
        img = jx_pt.render_rgb(_jx_scene(verts, FACES, EMISSION[None]), key, JxConfig(**cfg))
        return jnp.mean(img, axis=(0, 1)), img

    (mean_j, img_j), (g_j, _) = jax.jit(lambda z: jax.jvp(jx_mean, (z,), (jnp.ones_like(z),)))(
        jnp.float32(0.0))
    injected.extend(_jax_draws(key))
    dz = torch.zeros((), requires_grad=True)
    verts = torch.tensor(QUAD) + torch.stack([0 * dz, 0 * dz, dz])
    img_t = tc_pt.render_rgb(_tc_scene(verts, FACES, EMISSION[None]), [None],
                             TcConfig(**cfg))[0]
    g_t = torch.stack([torch.autograd.grad(img_t[..., c].mean(), dz, retain_graph=True)[0]
                       for c in range(3)]).numpy()
    assert not injected  # every draw was taken
    img_t = img_t.detach().numpy()
    assert np.abs(img_t - np.asarray(img_j)).max() <= 1e-5 * np.abs(img_j).max()
    g_j = np.asarray(g_j)
    assert (g_j > 0.05).all(), g_j  # the quad's growth: a boundary term only
    assert np.linalg.norm(g_t - g_j) <= 1e-3 * np.linalg.norm(g_j), (g_t, g_j)


# An emissive quad before an emissive diffuse backdrop (materials 0, 1);
# MOVE_FRONT: dz moves the quad alone.
BACK = np.concatenate([QUAD[:, :2] * 4.0, np.full((4, 1), 2 * Z, np.float32)], axis=1)
FACES2 = np.concatenate([FACES, FACES + 4])
EMISSION2 = np.array([[2.0, 1.0, 0.5], [0.2, 0.3, 0.4]], np.float32)
MOVE_FRONT = np.zeros((8, 3), np.float32)
MOVE_FRONT[:4, 2] = 1.0
H2, K_AUX2 = 16, 4
INDIRECT = dict(width=W, height=H2, spp=1, max_bounces=3, reparam=True, reparam_k_aux=K_AUX2,
                reparam_radius=RADIUS, reparam_indirect=True, reparam_ind_radius=0.05,
                reparam_ind_bounces=1)


def test_reparam_indirect_matches_jax(injected):
    key = jax.random.key(4)

    def jx_mean(dz):
        verts = jnp.asarray(np.concatenate([QUAD, BACK])) + dz * jnp.asarray(MOVE_FRONT)
        img = jx_pt.render_rgb(_jx_scene(verts, FACES2, EMISSION2, frozenset()), key,
                               JxConfig(**INDIRECT))
        return jnp.mean(img, axis=(0, 1)), img

    (mean_j, img_j), (g_j, _) = jax.jit(lambda z: jax.jvp(jx_mean, (z,), (jnp.ones_like(z),)))(
        jnp.float32(0.0))

    def port(indirect):
        injected.extend(_jax_draws(key, W * H2, K_AUX2, bounces=2, indirect=int(indirect)))
        dz = torch.zeros((), requires_grad=True)
        verts = torch.tensor(np.concatenate([QUAD, BACK])) + dz * torch.tensor(MOVE_FRONT)
        img = tc_pt.render_rgb(_tc_scene(verts, FACES2, EMISSION2, frozenset()), [None],
                               TcConfig(**INDIRECT).replace(reparam_indirect=indirect))[0]
        g = torch.stack([torch.autograd.grad(img[..., c].mean(), dz, retain_graph=True)[0]
                         for c in range(3)]).numpy()
        assert not injected  # every draw was taken, no other made
        return img.detach().numpy(), g

    img_t, g_t = port(True)
    _, g_direct = port(False)
    img_j, g_j = np.asarray(img_j), np.asarray(g_j)
    assert np.abs(img_t - img_j).max() <= 1e-5 * np.abs(img_j).max()
    assert np.linalg.norm(g_t - g_j) <= 1e-3 * np.linalg.norm(g_j), (g_t, g_j)
    # The warped bounce's share, 10x the tolerance at least.
    assert np.linalg.norm(g_t - g_direct) >= 1e-2 * np.linalg.norm(g_j), (g_t, g_direct)


def test_reparam_indirect_keeps_value():
    """The same scene with every lobe: with reparam_indirect the bounce
    directions are warped; the value stays the plain render's (same
    generators) and the gradient is finite, with and without the warped
    bounce (these generators reach a Fresnel term's sqrt at exactly 0,
    whose unguarded gradient was NaN)."""
    cfg = TcConfig(**INDIRECT)
    dz = torch.zeros((), requires_grad=True)

    def render(cfg):
        verts = torch.tensor(np.concatenate([QUAD, BACK])) + dz * torch.tensor(MOVE_FRONT)
        return tc_pt.render_rgb(_tc_scene(verts, FACES2, EMISSION2),
                                [torch.Generator().manual_seed(1)], cfg)

    img = render(cfg)
    torch.testing.assert_close(img.detach(), render(cfg.replace(reparam=False)).detach(),
                               rtol=0.0, atol=0.0)
    for indirect, im in ((True, img), (False, render(cfg.replace(reparam_indirect=False)))):
        (g,) = torch.autograd.grad(im.mean(), dz)
        assert torch.isfinite(g), indirect
