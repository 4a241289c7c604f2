"""Port parity for the warped-area reparameterizations against the JAX
package's, on tests/test_reparam_chunk.py's 3-face scene (a backdrop and a
triangle): the same inputs made with numpy and JAX's own constellation
draw injected into the port.

  * `reparam_ndc` (n = 100 NDC samples, k_aux 4, radius 0.1, one light,
    so shadow features take part) at chunk 0 and 32, its parameters
    theta = (the triangle's x, the camera's x, the fov, the light's y);
  * `reparam_direction` (70 directions, k_aux 4, radius 0.15) at chunk 0
    and 32, theta = (the triangle's x, the origins' offset, the directions'
    tilt): origins and directions depend on theta, as the path tracer's
    offset origin and BSDF sample do.

Values: u' is u and the area 1, exactly (d' equals JAX's normalized w
within 1e-6).  Each theta-derivative of a random linear functional of (u',
area) within 1e-3 relative of JAX's: it runs through the divergence's
second derivatives, whose float32 reciprocals such as 1 / (B^2 + fb)
amplify rounding.  JAX's side is one compiled forward-mode Jacobian per
function (jax.jacfwd; the reverse-mode compile is slower), shared by both
chunk sizes: JAX's own chunked result equals its unchunked one
(tests/test_reparam_chunk.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fireflies_tpu.render import reparam as jx_reparam
from fireflies_tpu.render.types import Camera as JxCamera
from fireflies_tpu.render.types import Geometry as JxGeometry
from fireflies_tpu_torch.render import reparam as tc_reparam
from fireflies_tpu_torch.render import types as tc

torch.set_num_threads(2)

VERTS = np.array([[-2.0, -2.0, -3.0], [2.0, -2.0, -3.0], [2.0, 2.0, -3.0], [-2.0, 2.0, -3.0],
                  [-0.5, -0.5, -1.5], [0.5, -0.5, -1.5], [0.5, 0.5, -1.5]], np.float32)
FACES = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32)
MOVES = np.zeros((7, 3), np.float32)
MOVES[4:, 0] = 1.0  # dx moves the triangle
LIGHT = np.array([[0.3, 1.5, 0.5]], np.float32)
K_AUX = 4
M = K_AUX + tc_reparam._n_scout(K_AUX)

rng = np.random.default_rng(7)
U = rng.uniform(-0.8, 0.8, (100, 2)).astype(np.float32)
C_NDC = rng.normal(size=(100, 2)).astype(np.float32)
W_DIR = -np.abs(rng.normal(size=(70, 3)) * [0.3, 0.3, 1.0]).astype(np.float32)
W_DIR /= np.linalg.norm(W_DIR, axis=-1, keepdims=True)
C_DIR = rng.normal(size=(70, 3)).astype(np.float32)
XI_NDC = np.asarray(jax.random.uniform(jax.random.key(5), (1, M, 2)))
XI_DIR = np.asarray(jax.random.uniform(jax.random.key(6), (1, M, 2)))
THETA_NDC = np.array([0.05, 0.1, 0.0, 0.0], np.float32)
THETA_DIR = np.array([0.02, 0.0, 0.0], np.float32)
X_MOVE = rng.normal(size=(70, 3)).astype(np.float32) * 0.05  # origins' offset
W_TILT = rng.normal(size=(70, 3)).astype(np.float32)  # directions' tilt


E_TX = np.zeros((4, 4), np.float32)
E_TX[0, 3] = 1.0  # the camera's x translation


def _cam_to_world(xp, theta):
    return xp.asarray(np.eye(4, dtype=np.float32)) + theta[1] * xp.asarray(E_TX)


def _jx_geo(dx):
    return JxGeometry(vertices=jnp.asarray(VERTS) + dx * jnp.asarray(MOVES),
                      faces=jnp.asarray(FACES), face_mat=jnp.zeros(3, jnp.int32),
                      face_mesh=jnp.zeros(3, jnp.int32))


def _tc_geo(dx):
    return tc.Geometry(vertices=(torch.tensor(VERTS) + dx * torch.tensor(MOVES))[None],
                       faces=torch.tensor(FACES).long(), face_mat=torch.zeros(3, dtype=torch.long),
                       face_mesh=torch.zeros(3, dtype=torch.long))


def _light(theta, xp):
    return xp.asarray(LIGHT) + theta[3] * xp.asarray(np.array([[0.0, 1.0, 0.0]], np.float32))


def _origins_dirs(theta, xp, normalize):
    x = theta[1] * xp.asarray(X_MOVE)
    w = xp.asarray(W_DIR) + theta[2] * xp.asarray(W_TILT)
    return x, normalize(w)


def _jacobian(f, theta):
    """(jacobian, aux) of f: theta -> (scalar, aux), one compile."""
    return jax.jit(jax.jacfwd(f, has_aux=True))(jnp.asarray(theta))


@pytest.fixture(scope="module")
def jax_ndc():
    def functional(theta):
        cam = JxCamera.create(_cam_to_world(jnp, theta), fov=60.0 + 10.0 * theta[2])
        u_new, area = jx_reparam.reparam_ndc(cam, jnp.asarray(U), _jx_geo(theta[0]),
                                             jax.random.key(5), k_aux=K_AUX, radius=0.1,
                                             tri_chunk=16, light_positions=_light(theta, jnp))
        s = jnp.sum(u_new * C_NDC) + jnp.sum(area * C_NDC[:, 0])
        return s, s

    g, v = _jacobian(functional, THETA_NDC)
    return float(v), np.asarray(g)


@pytest.fixture(scope="module")
def jax_direction():
    def unit(w):
        return w / jnp.linalg.norm(w, axis=-1, keepdims=True)

    def functional(theta):
        x, w = _origins_dirs(theta, jnp, unit)
        d_new, area = jx_reparam.reparam_direction(x, w, _jx_geo(theta[0]), jax.random.key(6),
                                                   k_aux=K_AUX, radius=0.15, tri_chunk=16)
        s = jnp.sum(d_new * C_DIR) + jnp.sum(area * C_DIR[:, 0])
        return s, (s, d_new)

    g, (v, d_j) = _jacobian(functional, THETA_DIR)
    return float(v), np.asarray(g), np.asarray(d_j)


def _assert_jacobian(g_t, g_j):
    """Each theta-derivative within 1e-3 relative of JAX's; each is one
    the functional sees (well above float32 rounding)."""
    assert (np.abs(g_j) > 1e-2).all(), g_j
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("chunk", [0, 32])
def test_reparam_ndc_matches(jax_ndc, chunk):
    v_j, g_j = jax_ndc
    theta = torch.tensor(THETA_NDC, requires_grad=True)
    cam = tc.Camera(to_world=_cam_to_world(torch, theta)[None], fov=(60.0 + 10.0 * theta[2])[None],
                    near=torch.tensor([0.01]), far=torch.tensor([1000.0]))
    u = torch.tensor(U)[None]
    u_new, area = tc_reparam.reparam_ndc(cam, u, _tc_geo(theta[0]), k_aux=K_AUX, radius=0.1,
                                         light_positions=_light(theta, torch)[None], chunk=chunk,
                                         uniforms=torch.tensor(XI_NDC)[None])
    assert torch.equal(u_new.detach(), u) and torch.equal(area.detach(), torch.ones(1, 100))
    s = (u_new[0] * torch.tensor(C_NDC)).sum() + (area[0] * torch.tensor(C_NDC[:, 0])).sum()
    (g_t,) = torch.autograd.grad(s, theta)
    assert float(s.detach()) == pytest.approx(v_j, rel=1e-6)
    assert abs(g_j[0]) > 1.0  # the functional sees the triangle's silhouette
    _assert_jacobian(g_t.numpy(), g_j)


@pytest.mark.parametrize("chunk", [0, 32])
def test_reparam_direction_matches(jax_direction, chunk):
    v_j, g_j, d_j = jax_direction
    theta = torch.tensor(THETA_DIR, requires_grad=True)
    x, w = _origins_dirs(theta, torch,
                         lambda v: v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    d_new, area = tc_reparam.reparam_direction(x[None], w[None], _tc_geo(theta[0]), k_aux=K_AUX,
                                               radius=0.15, chunk=chunk,
                                               uniforms=torch.tensor(XI_DIR)[None])
    np.testing.assert_allclose(d_new.detach()[0].numpy(), d_j, rtol=0.0, atol=1e-6)
    assert torch.equal(area.detach(), torch.ones(1, 70))
    s = (d_new[0] * torch.tensor(C_DIR)).sum() + (area[0] * torch.tensor(C_DIR[:, 0])).sum()
    (g_t,) = torch.autograd.grad(s, theta)
    assert float(s.detach()) == pytest.approx(v_j, rel=1e-6)
    _assert_jacobian(g_t.numpy(), g_j)
