"""Port parity for the warped-area warp field (render/reparam.py) and the
depth renderer built on it:

  * `_edge_topology` (open edges, the face across each shared edge) is
    identical to JAX's on the vocalfold mesh at resolution 6, whose fold
    has open edges and shared ones;
  * `make_warp_field(debug=True)` on tests/test_reparam_chunk.py's 3-face
    scene and on tests/test_reparam_shadow.py's occluder over a receiver
    with its light, JAX's constellation injected: every aux ray's prim
    equal, and V, b0, q_min and the candidate weights w within 1e-5
    absolute (NDC units; the slot sums run in another order); on the
    shadow scene the shadow features' gates equal and their boundary
    distances within 1e-5 where the gate is on;
  * the port's `render_depth_reparam` at 48^2 (its own draws, 3 seeds)
    within 15% of tests/test_reparam.py's analytic boundary flux of a
    translating quad, and the detached depth's gradient 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.render import reparam as jx_reparam
from fireflies_tpu.render.types import Camera as JxCamera
from fireflies_tpu.render.types import Geometry as JxGeometry
from fireflies_tpu_torch.assets import scenes as tc_scenes
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import SceneBridge as TcBridge
from fireflies_tpu_torch.render import integrators as tc_integrators
from fireflies_tpu_torch.render import reparam as tc_reparam
from fireflies_tpu_torch.render import types as tc

torch.set_num_threads(1)

FOV = 60.0
K_AUX, RADIUS = 4, 0.1
M = K_AUX + tc_reparam._n_scout(K_AUX)


def _geometries(verts, faces):
    n_f = faces.shape[0]
    jx = JxGeometry(vertices=jnp.asarray(verts), faces=jnp.asarray(faces),
                    face_mat=jnp.zeros(n_f, jnp.int32), face_mesh=jnp.zeros(n_f, jnp.int32))
    t = tc.Geometry(vertices=torch.tensor(verts)[None], faces=torch.tensor(faces).long(),
                    face_mat=torch.zeros(n_f, dtype=torch.long),
                    face_mesh=torch.zeros(n_f, dtype=torch.long))
    return jx, t


def _camera():
    return tc.Camera(to_world=torch.eye(4)[None], fov=torch.tensor([FOV]),
                     near=torch.tensor([0.01]), far=torch.tensor([1000.0]))


def test_edge_topology_identical():
    scene, kw = tc_scenes.vocalfold(resolution=6, n_anim_frames=4)
    faces = np.asarray(TcBridge(scene, **kw)._faces, np.int32)
    verts = np.zeros((int(faces.max()) + 1, 3), np.float32)
    jx, t = _geometries(verts, faces)
    open_j, nbr_j = jx_reparam._edge_topology(jx)
    open_t, nbr_t = tc_reparam._edge_topology(t)
    assert 0 < int(open_t.sum()) < open_t.numel()
    np.testing.assert_array_equal(open_t.numpy(), np.asarray(open_j))
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))


def _chunk_scene():
    verts = np.array([[-2, -2, -3], [2, -2, -3], [2, 2, -3], [-2, 2, -3], [-0.45, -0.5, -1.5],
                      [0.55, -0.5, -1.5], [0.55, 0.5, -1.5]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32)
    u = np.random.default_rng(1).uniform(-0.8, 0.8, (200, 2)).astype(np.float32)
    return verts, faces, u, None


def _shadow_scene():
    """The occluder at dx = 0.3 casts its shadow's right edge at x = -0.8
    on the receiver; the samples straddle it."""
    b = 2.5
    verts = np.array([[-b, -b, -2], [b, -b, -2], [b, b, -2], [-b, b, -2], [-3.2, -0.6, -1],
                      [-2.4, -0.6, -1], [-2.4, 0.6, -1], [-3.2, 0.6, -1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    edge = -0.8 / (2.0 * np.tan(np.deg2rad(FOV / 2.0)))
    rng = np.random.default_rng(2)
    u = np.stack([edge + rng.uniform(-0.15, 0.15, 300), rng.uniform(-0.5, 0.5, 300)], -1)
    return verts, faces, u.astype(np.float32), np.array([[-4.0, 0.0, 0.0]], np.float32)


@pytest.mark.parametrize("make", [_chunk_scene, _shadow_scene], ids=["chunk", "shadow"])
def test_warp_field_matches(make):
    verts, faces, u, light = make()
    jx, t = _geometries(verts, faces)
    warp_j = jx_reparam.make_warp_field(
        JxCamera.create(jnp.eye(4), fov=FOV), jx, jax.random.key(5), k_aux=K_AUX, radius=RADIUS,
        tri_chunk=16, debug=True, light_positions=None if light is None else jnp.asarray(light))
    _, dj = jax.jit(warp_j)(jnp.asarray(u))
    xi = np.asarray(jax.random.uniform(jax.random.key(5), (1, M, 2)))
    warp_t = tc_reparam.make_warp_field(
        _camera(), t, k_aux=K_AUX, radius=RADIUS, debug=True, uniforms=torch.tensor(xi)[None],
        light_positions=None if light is None else torch.tensor(light)[None])
    with torch.no_grad():
        _, dt = warp_t(torch.tensor(u)[None])
    np.testing.assert_array_equal(dt["prim"][0].numpy(), np.asarray(dj["prim"]))
    v_j = np.sum(np.asarray(dj["w"])[..., None] * np.asarray(dj["val_c"]), axis=1)
    assert np.abs(v_j - u).max() > 1e-3  # the field moves somewhere
    np.testing.assert_allclose(dt["v_ndc"][0].numpy(), v_j, rtol=0.0, atol=1e-5)
    for name in ("b0", "q_min", "w"):
        np.testing.assert_allclose(dt[name][0].numpy(), np.asarray(dj[name]), rtol=0.0,
                                   atol=1e-5, err_msg=name)
    if light is not None:
        (sj,), (st,) = dj["shadow"], dt["shadow"]
        ok_j = np.transpose(np.asarray(sj["per_slot"]["ok_s"]), (1, 0, 2))  # (n, J, K)
        assert ok_j.any()
        np.testing.assert_array_equal(st["ok"][0].numpy(), ok_j)
        fb_j = np.transpose(np.asarray(sj["per_slot"]["fbnd_s"]), (1, 0, 2))
        np.testing.assert_allclose(st["fbnd"][0].numpy()[ok_j], fb_j[ok_j], rtol=0.0, atol=1e-5)


HALF, Z = 0.5, -2.0


def _analytic_boundary_grad(dx: float) -> float:
    """tests/test_reparam.py's quadrature of the depth flux through the
    quad's moving vertical edges."""
    tanf = np.tan(np.deg2rad(FOV / 2.0))
    c = 2.0 * tanf
    ys = np.linspace(-HALF / c, HALF / c, 4001)

    def g(x):
        return np.trapezoid(2.0 * np.sqrt(1.0 + (x * tanf) ** 2 + (ys * tanf) ** 2), ys)

    return float((g((dx + HALF) / c) - g((dx - HALF) / c)) / (4.0 * c))


def _quad_scene(dx):
    verts = torch.tensor([[-HALF, -HALF, Z], [HALF, -HALF, Z], [HALF, HALF, Z],
                          [-HALF, HALF, Z]]) + torch.stack([dx, 0 * dx, 0 * dx])
    geo = tc.Geometry(vertices=verts[None], faces=torch.tensor([[0, 1, 2], [0, 2, 3]]),
                      face_mat=torch.zeros(2, dtype=torch.long),
                      face_mesh=torch.zeros(2, dtype=torch.long))
    one = torch.ones(1, 1)
    mats = tc.Materials(**{f: one for f in (
        "roughness metallic specular spec_tint clearcoat clearcoat_gloss sheen sheen_tint "
        "anisotropic spec_trans flatness ior thin").split()}, base_color=torch.ones(1, 1, 3),
        emission=torch.zeros(1, 1, 3))
    lights = tc.Lights(kinds=(), to_world=torch.zeros(1, 0, 4, 4), intensity=torch.zeros(1, 0, 3),
                       cutoff_cos=torch.zeros(1, 0), beam_cos=torch.zeros(1, 0),
                       active=torch.zeros(1, 0, dtype=torch.bool))
    return tc.RenderScene(geometry=geo, materials=mats, lights=lights, camera=_camera())


def test_depth_reparam_matches_analytic_flux():
    ref = _analytic_boundary_grad(0.3)
    cfg = TcConfig(width=48, height=48)
    grads = []
    for seed in range(3):
        dx = torch.tensor(0.3, requires_grad=True)
        depth = tc_reparam.render_depth_reparam(_quad_scene(dx), cfg,
                                                [torch.Generator().manual_seed(seed)],
                                                k_aux=12, radius=0.06)
        (g,) = torch.autograd.grad(depth.mean(), dx)
        grads.append(float(g))
    assert np.mean(grads) == pytest.approx(ref, rel=0.15), (grads, ref)
    # The same quad's depth without the warp (128x16: the tile-major route)
    # sees no boundary and gets no gradient.
    dx = torch.tensor(0.3, requires_grad=True)
    plain = tc_integrators.render_depth_differentiable(_quad_scene(dx),
                                                      TcConfig(width=128, height=16))
    (g,) = torch.autograd.grad(plain.mean(), dx)
    assert abs(float(g)) < 1e-6
