"""Port parity for the projector texture route's modules, on the same numpy
inputs through the JAX functions and the port's:

  * the point rasters (`rasterize_points`, `sum_points`, `softor_points`,
    the latter two over chunks with a padded last one), values and point
    gradients;
  * the beam pattern's textures (`rays_to_texture`, `rays_to_texture_rgb`
    with the blur off and on, 64x64) and `gaussian_blur2d`, values and beam
    (or image) gradients;
  * `bilinear_sample` and `bilinear_sample_packed` (values, texture and uv
    gradients) against each other and against JAX, shared and one texture
    a variant;
  * the textured projector of `eval_projector_v` at random points, with and
    without the packed table.
Tolerance: 1e-5 relative, with an absolute floor of 1e-5 of the largest
value (the splats fall off as exp(-d^4), so small values carry the
exponential's relative error); the packed and unpacked lookups agree to
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_lights import _look_at
from test_torch_shading import N, _close, _v

from fireflies_tpu import postprocessing as jx_post
from fireflies_tpu.graphics import rasterization as jx_raster
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.render import lights as jx_lights
from fireflies_tpu.render import texture as jx_texture
from fireflies_tpu.render import types as jx_types
from fireflies_tpu_torch import postprocessing as tc_post
from fireflies_tpu_torch.graphics import rasterization as tc_raster
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.render import lights as tc_lights
from fireflies_tpu_torch.render import texture as tc_texture
from fireflies_tpu_torch.render import types as tc_types
from fireflies_tpu_torch.render import vec3 as tc_vec3

torch.set_num_threads(1)


def _value_and_vjp(jx_fn, tc_fn, args, weights):
    """Each package's f(*args) and the gradient of sum(weights * f) with
    respect to every arg: ((value_jax, grads_jax), (value_torch,
    grads_torch))."""
    def value_and_vjp(w, *a):
        val, vjp = jax.vjp(jx_fn, *a)
        return val, vjp(w)

    val_j, grads_j = jax.jit(value_and_vjp)(jnp.asarray(weights), *(jnp.asarray(a) for a in args))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    val_t = tc_fn(*leaves)
    (val_t * torch.as_tensor(weights)).sum().backward()
    return (val_j, grads_j), (val_t, [x.grad for x in leaves])


def _check(jax_side, torch_side):
    (val_j, grads_j), (val_t, grads_t) = jax_side, torch_side
    assert float(np.abs(np.asarray(val_j)).max()) > 0
    _close(val_t, val_j, ill_conditioned=True)
    for g_t, g_j in zip(grads_t, grads_j):
        assert float(np.abs(np.asarray(g_j)).max()) > 0
        _close(g_t, g_j, ill_conditioned=True)


def test_point_rasters_match():
    rng = np.random.default_rng(11)
    pts = rng.uniform(0.0, 1.0, size=(37, 2)).astype(np.float32)
    size = (24, 40)
    for jx_fn, tc_fn, shape in (
            (lambda p: jx_raster.rasterize_points(p, 10.0, size),
             lambda p: tc_raster.rasterize_points(p, 10.0, size), (37, *size)),
            (lambda p: jx_raster.sum_points(p, 10.0, size, chunk=16),
             lambda p: tc_raster.sum_points(p, 10.0, size, chunk=16), size),
            (lambda p: jx_raster.softor_points(p, 30.0, size, chunk=16),
             lambda p: tc_raster.softor_points(p, 30.0, size, chunk=16), size)):
        weights = rng.normal(size=shape).astype(np.float32)
        _check(*_value_and_vjp(jx_fn, tc_fn, (pts,), weights))
    stack = rng.uniform(0.0, 0.5, size=(5, 8, 9)).astype(np.float32)
    _close(tc_raster.softor(torch.as_tensor(stack)), jx_raster.softor(jnp.asarray(stack)))


def test_beam_textures_and_blur_match():
    rng = np.random.default_rng(12)
    rays = np.asarray(jx_laser.generate_uniform_rays(0.0275, 12, 12))
    size = (64, 64)
    _check(*_value_and_vjp(
        lambda r: jx_laser.rays_to_texture(r, 30.0, 10.0, size),
        lambda r: tc_laser.rays_to_texture(r, 30.0, 10.0, size),
        (rays,), rng.normal(size=(144, *size)).astype(np.float32)))
    for blur in (0, 5):
        _check(*_value_and_vjp(
            lambda r: jx_laser.rays_to_texture_rgb(r, 30.0, 10.0, size, blur_kernel=blur),
            lambda r: tc_laser.rays_to_texture_rgb(r, 30.0, 10.0, size, blur_kernel=blur),
            (rays,), rng.normal(size=(*size, 3)).astype(np.float32)))
    for shape in ((20, 30), (20, 30, 3)):
        image = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
        _check(*_value_and_vjp(
            lambda x: jx_post.gaussian_blur2d(x, (5, 3), (3.0, 1.5)),
            lambda x: tc_post.gaussian_blur2d(x, (5, 3), (3.0, 1.5)),
            (image,), rng.normal(size=shape).astype(np.float32)))


def test_bilinear_sample_matches():
    rng = np.random.default_rng(13)
    h, w = 16, 24
    tex = rng.uniform(0.0, 1.0, size=(h, w, 3)).astype(np.float32)
    uv = rng.uniform(-0.05, 1.05, size=(500, 2)).astype(np.float32)
    weights = rng.normal(size=(500, 3)).astype(np.float32)
    jax_side = _value_and_vjp(jx_texture.bilinear_sample, tc_texture.bilinear_sample,
                              (tex, uv), weights)
    _check(*jax_side)
    packed = _value_and_vjp(
        lambda t, u: jx_texture.bilinear_sample_packed(
            jx_texture.pack_neighborhood_table(t), h, w, u),
        lambda t, u: tc_texture.bilinear_sample_packed(
            tc_texture.pack_neighborhood_table(t), h, w, u),
        (tex, uv), weights)
    _check(*packed)
    for a, b in zip([jax_side[1][0], *jax_side[1][1]], [packed[1][0], *packed[1][1]]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # One texture a variant: each variant's lookup equals its own texture's.
    texs = torch.as_tensor(rng.uniform(0.0, 1.0, size=(3, h, w, 3)).astype(np.float32))
    uvs = torch.as_tensor(rng.uniform(0.0, 1.0, size=(3, 7, 11, 2)).astype(np.float32))
    each = torch.stack([tc_texture.bilinear_sample(texs[b], uvs[b]) for b in range(3)])
    assert torch.equal(tc_texture.bilinear_sample(texs, uvs), each)
    table = tc_texture.pack_neighborhood_table(texs)
    torch.testing.assert_close(tc_texture.bilinear_sample_packed(table, h, w, uvs), each,
                               rtol=1e-6, atol=1e-6)


def test_texture_projector_matches():
    rng = np.random.default_rng(14)
    p = rng.uniform(-0.6, 0.6, size=(N, 3)).astype(np.float32) * [1.0, 1.0, 0.3]
    to_world = _look_at((0.35, 0.0, 1.9), (0.0, 0.0, 0.0))
    tex = rng.uniform(0.0, 1.0, size=(32, 48, 3)).astype(np.float32)
    pj = jx_types.Projector.create(jnp.asarray(to_world), jnp.asarray(tex), fov=30.0, scale=20.0)
    eval_j = jax.jit(jx_lights.eval_projector_v)
    wi_j, dist_j, rad_j = eval_j(pj, _v(p, "jax"))
    assert float(np.asarray(rad_j.to_array()).max()) > 0

    def projector(texture):
        return tc_types.Projector(
            to_world=torch.as_tensor(to_world)[None].expand(2, 4, 4), fov=torch.tensor([30.0] * 2),
            near=torch.tensor([0.01] * 2), far=torch.tensor([1000.0] * 2), texture=texture,
            scale=torch.tensor([20.0] * 2))

    pts = tc_vec3.from_array(torch.as_tensor(p)[None].expand(2, N, 3))
    other = torch.as_tensor(rng.uniform(0.0, 1.0, size=(32, 48, 3)).astype(np.float32))
    shared, per_variant = torch.as_tensor(tex), torch.stack([torch.as_tensor(tex), other])
    for texture in (shared, per_variant):
        pt = projector(texture)
        for table in (None, tc_texture.pack_neighborhood_table(texture)):
            wi_t, dist_t, rad_t = tc_lights.eval_projector_v(pt, pts, tex_table=table)
            _close(wi_t.to_array()[0], wi_j.to_array())
            _close(dist_t[0], dist_j)
            _close(rad_t.to_array()[0], rad_j.to_array(), ill_conditioned=True)
    # The second variant looks up its own texture.
    pj2 = jx_types.Projector.create(jnp.asarray(to_world), jnp.asarray(other.numpy()), fov=30.0,
                                    scale=20.0)
    _close(rad_t.to_array()[1], eval_j(pj2, _v(p, "jax"))[2].to_array(),
           ill_conditioned=True)
