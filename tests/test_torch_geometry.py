"""Port parity for the modules of the differentiable face-table attribute
route, on the same numpy inputs through the JAX functions and the port's
(the port batched over 2 variants, JAX one variant at a time):

  * `build_face_table`, `hit_attributes_table` and `_interp_smooth_normal`
    on random faces (some degenerate: a repeated corner, a flat uv
    triangle) with uvs and smooth normals (some rows zero, the flat-shaded
    fallback), and rays aimed at random points of the faces, some missing:
    every attribute, and the vertex gradient of a random weighting of them;
  * `compute_vertex_normals` (an unreferenced vertex included) and its
    vertex gradient; the bridge's normals for the smooth vocalfold scene;
  * `points_to_ndc`, `soft_silhouette` through `render_soft_silhouette` and
    its vertex gradient, and `hybrid_pose_loss`;
  * `RenderConfig.ray_chunk`: a one-bounce render traced in chunks of 1000
    rays (not a multiple of the 2048-ray tile; the last one padded) equals
    the unchunked one.
Tolerance: 1e-5 relative with an absolute floor of 1e-5 of the largest
value, but for the re-derived attributes, held with their condition
number (see the first test); gradients 1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_stream import _plane64

from fireflies_tpu.assets import scenes as jx_scenes
from fireflies_tpu.optim import inverse as jx_inverse
from fireflies_tpu.render import SceneBridge as JxBridge
from fireflies_tpu.render import intersect as jx_intersect
from fireflies_tpu.render import rays as jx_rays
from fireflies_tpu.render import soft as jx_soft
from fireflies_tpu.render import types as jx_types
from fireflies_tpu.render import vec3 as jx_vec3
from fireflies_tpu_torch import main_path
from fireflies_tpu_torch.interop import from_jax_params
from fireflies_tpu_torch.optim import inverse as tc_inverse
from fireflies_tpu_torch.render import RenderConfig as TcConfig
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render import soft as tc_soft
from fireflies_tpu_torch.render import types as tc_types
from fireflies_tpu_torch.render import vec3 as tc_vec3

torch.set_num_threads(2)

B, V, F, N = 2, 40, 64, 512


def _close(ours, ref, rtol=1e-5):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _rel_l2(ours, ref, bound=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert np.isfinite(ours).all() and np.abs(ref).max() > 0
    rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert rel <= bound, rel


def _geometry_inputs(rng):
    verts = rng.normal(size=(B, V, 3)).astype(np.float32)
    faces = rng.integers(0, V - 1, size=(F, 3)).astype(np.int32)  # vertex V-1 unreferenced
    faces[:, 1] = np.where(faces[:, 1] == faces[:, 0], (faces[:, 0] + 1) % (V - 1), faces[:, 1])
    faces[:, 2] = np.where((faces[:, 2] == faces[:, 0]) | (faces[:, 2] == faces[:, 1]),
                           (np.maximum(faces[:, 0], faces[:, 1]) + 1) % (V - 1), faces[:, 2])
    faces[3] = (faces[3, 0], faces[3, 0], faces[3, 2])  # zero area: det = 0
    uvs = rng.random(size=(V, 2)).astype(np.float32)
    uvs[faces[5]] = uvs[faces[5, 0]]  # one flat uv triangle: the tangent guard
    mask = (rng.random(V) < 0.7).astype(np.float32)  # zero rows: the flat fallback
    face_mat = rng.integers(0, 3, F).astype(np.int32)
    face_mesh = rng.integers(0, 2, F).astype(np.int32)
    return verts, faces, uvs, mask, face_mat, face_mesh


def _rays(rng, verts, faces):
    """Rays from random origins towards a random barycentric point of
    their (random) face, some outside the triangle; prim -1 on a third."""
    prim = rng.integers(0, F, size=(B, N))
    bary = rng.uniform(-0.2, 1.0, size=(B, N, 2))
    corners = [np.take_along_axis(verts, faces[prim][..., k:k + 1].repeat(3, -1), 1)
               for k in range(3)]
    target = (corners[0] + (corners[1] - corners[0]) * bary[..., :1]
              + (corners[2] - corners[0]) * bary[..., 1:])
    o = (target + rng.normal(size=(B, N, 3)) * 2.0).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    prim = np.where(rng.random((B, N)) < 0.33, -1, prim).astype(np.int32)
    return o, d, prim


def _tc_attrs(verts, faces, uvs, mask, face_mat, face_mesh, o, d, prim, dtype=torch.float32):
    """The port's face table and attributes (3-vectors as (..., 3))."""
    vert_t = torch.as_tensor(verts, dtype=dtype).requires_grad_(True)
    faces_t = torch.as_tensor(faces, dtype=torch.long)
    geo = tc_types.Geometry(
        vertices=vert_t, faces=faces_t, face_mat=torch.as_tensor(face_mat, dtype=torch.long),
        face_mesh=torch.as_tensor(face_mesh, dtype=torch.long),
        uvs=torch.as_tensor(uvs, dtype=dtype),
        normals=(tc_types.compute_vertex_normals(vert_t, faces_t)
                 * torch.as_tensor(mask, dtype=dtype)[:, None]))
    table = tc_intersect.build_face_table(geo)
    prim_t = torch.as_tensor(prim)
    zeros = torch.zeros(prim.shape, dtype=dtype)
    hit = tc_types.Hit(t=zeros, prim=prim_t, u=zeros, v=zeros, valid=prim_t >= 0)
    out = tc_intersect.hit_attributes_table(tc_vec3.from_array(torch.as_tensor(o, dtype=dtype)),
                                            tc_vec3.from_array(torch.as_tensor(d, dtype=dtype)),
                                            hit, table, True, True)
    return vert_t, table, {k: (x.to_array() if isinstance(x, tc_vec3.Vec3) else x)
                           for k, x in out.items()}


def test_face_table_and_hit_attributes_match():
    """Both packages against the float64 evaluation, per ray within
    (1e-5 + 4 u kappa) of the attribute's largest value, u = 2^-24 and kappa
    the ray-plane condition number of tests/test_torch_stream.py (the
    re-derived t, u, v divide by det; XLA contracts a*b+c, the port rounds
    each operation).  The reference normalizes the zero-area face's zero
    normal to NaN (its rsqrt guard 1e-40 flushes to 0 on the CPU); there
    the port's stays finite, with t = u = v = 0 (det = 0).  The vertex
    gradient of a random weighting of every attribute, on the rays that
    miss the zero-area face, within 1e-4 relative L2."""
    rng = np.random.default_rng(0)
    inputs = _geometry_inputs(rng)
    verts, faces, uvs, mask, face_mat, face_mesh = inputs
    o, d, prim = _rays(rng, verts, faces)
    weights = {k: rng.normal(size=(B, N)).astype(np.float32)
               for k in ("t", "u", "v", "uv_x", "uv_y")}
    weights.update({k: rng.normal(size=(B, N, 3)).astype(np.float32)
                    for k in ("position", "normal", "tangent", "smooth_normal")})

    def jx_attrs(vert, o_, d_, prim_):
        normals = jx_types.compute_vertex_normals(vert, jnp.asarray(faces)) * mask[:, None]
        geo = jx_types.Geometry(vertices=vert, faces=jnp.asarray(faces),
                                face_mat=jnp.asarray(face_mat), face_mesh=jnp.asarray(face_mesh),
                                uvs=jnp.asarray(uvs), normals=normals)
        table = jx_intersect.build_face_table(geo)
        zeros = jnp.zeros(prim_.shape, jnp.float32)
        hit = jx_types.Hit(t=zeros, prim=prim_, u=zeros, v=zeros, valid=prim_ >= 0)
        out = jx_intersect.hit_attributes_table(jx_vec3.from_array(o_), jx_vec3.from_array(d_),
                                                hit, table, True, True)
        return table, {k: (x.to_array() if isinstance(x, jx_vec3.Vec3) else x)
                       for k, x in out.items()}

    def jx_loss(vert, o_, d_, prim_, w):
        attrs = jx_attrs(vert, o_, d_, prim_)[1]
        return sum(jnp.sum(attrs[k] * w[k]) for k in w)

    attrs_j = jax.jit(jx_attrs)
    ref = [attrs_j(verts[b], o[b], d[b], prim[b]) for b in range(B)]
    theirs = {k: np.stack([np.asarray(r[1][k]) for r in ref]) for k in ref[0][1]}
    vert_t, table, ours = _tc_attrs(*inputs, o, d, prim)
    _, table64, exact = _tc_attrs(*inputs, o, d, prim, dtype=torch.float64)
    assert table.shape == (B, F, 26) and set(ours) == set(theirs)
    _close(table.detach(), np.stack([np.asarray(r[0]) for r in ref]))

    zero_area = prim == 3
    assert zero_area.any() and (prim < 0).any()
    with np.errstate(divide="ignore", invalid="ignore"):  # the zero-area face
        kappa = np.stack([_plane64(o[b], d[b], verts[b], faces, np.maximum(prim[b], 0))[1]
                          for b in range(B)])
    for k, x64 in exact.items():
        x64 = x64.detach().numpy()
        x_t, x_j = ours[k].detach().numpy(), theirs[k]
        assert np.isfinite(x_t).all()
        if k in ("mat_id", "mesh_id"):
            np.testing.assert_array_equal(x_t, x64)
            np.testing.assert_array_equal(x_j, x64)
            continue
        bound = (1e-5 + 4 * 2.0**-24 * np.where(zero_area, 0.0, kappa)) * np.abs(x64).max()
        for x, name in ((x_t, "port"), (x_j, "jax")):
            err = np.abs(x - x64)
            if err.ndim == 3:
                err = err.max(-1)
            ok = err <= bound
            if name == "jax":  # its NaN normal on the zero-area face only
                ok |= zero_area & ~np.isfinite(err)
            assert ok.all(), (k, name, float(np.nanmax(err / bound)))
    for k in ("t", "u", "v"):
        assert (ours[k].detach().numpy()[zero_area & (prim >= 0)] == 0.0).all()
    assert (ours["t"].detach().numpy()[prim < 0] == 1.0).all()
    assert (ours["u"].detach().numpy()[prim < 0] == 0.0).all()

    prim_g = np.where(zero_area, -1, prim).astype(np.int32)
    grad_j = jax.jit(jax.grad(jx_loss))
    ref_grad = np.stack([grad_j(verts[b], o[b], d[b], prim_g[b], {k: w[b] for k, w in
                                                                      weights.items()})
                         for b in range(B)])
    vert_t, _, ours = _tc_attrs(*inputs, o, d, prim_g)
    sum(((ours[k] * torch.as_tensor(w)).sum() for k, w in weights.items())).backward()
    _rel_l2(vert_t.grad, ref_grad)


def test_vertex_normals_and_bridge_normals_match():
    rng = np.random.default_rng(1)
    verts, faces, *_ = _geometry_inputs(rng)
    w = rng.normal(size=(B, V, 3)).astype(np.float32)
    fn_j = jax.jit(lambda x: jx_types.compute_vertex_normals(x, jnp.asarray(faces)))
    g_j = jax.jit(jax.grad(lambda x, w_: jnp.sum(
        jx_types.compute_vertex_normals(x, jnp.asarray(faces)) * w_)))
    vert_t = torch.as_tensor(verts).requires_grad_(True)
    vn = tc_types.compute_vertex_normals(vert_t, torch.as_tensor(faces, dtype=torch.long))
    _close(vn.detach(), np.stack([fn_j(v) for v in verts]))
    assert (vn[:, V - 1] == 0).all()  # unreferenced: zero, finite cotangent
    (vn * torch.as_tensor(w)).sum().backward()
    _rel_l2(vert_t.grad, np.stack([g_j(v, w_) for v, w_ in zip(verts, w)]))

    jx_scene, kw = jx_scenes.vocalfold(resolution=8, n_anim_frames=4, smooth=True)
    jp = {k: np.asarray(v) for k, v in jax.jit(jx_scene.compile())(jax.random.key(3), 0).items()}
    ref = jax.jit(lambda p: JxBridge(jx_scene, **kw).assemble(p).geometry.normals)(jp)
    bridge, _, _ = main_path.build("cpu", resolution=8, smooth=True)
    geo = bridge.assemble([from_jax_params(jp, "cpu")]).geometry
    assert geo.uvs.shape == (geo.vertices.shape[1], 2)
    _close(geo.normals[0], ref)


def test_soft_silhouette_and_vertex_gradient_match():
    """The port's render_soft_silhouette of two assembled variants (mesh 0's
    faces) against JAX's points_to_ndc and soft_silhouette of the same
    vertices and cameras; the gradient of hybrid_pose_loss with respect to
    a translation of every vertex."""
    bridge, randomize, _ = main_path.build("cpu", resolution=8)
    gens = main_path.generators([1, 2], "cpu")
    scene = bridge.assemble([randomize(g, 0) for g in gens])
    geo, cam = scene.geometry, scene.camera
    rng = np.random.default_rng(2)
    h, w = 32, 48
    target = rng.random((B, h, w)).astype(np.float32)
    faces = geo.faces.numpy()
    face_mask = geo.face_mesh.numpy() == 0

    def jx_loss(verts, to_world, fov, delta, tgt):
        camera = jx_types.Camera(to_world=to_world, fov=fov, near=0.01, far=1000.0)
        ndc = jx_rays.points_to_ndc(camera, verts + delta)
        mask = jx_soft.soft_silhouette(ndc, jnp.asarray(faces), h, w,
                                       face_mask=jnp.asarray(face_mask))
        loss = jx_inverse.hybrid_pose_loss(jnp.zeros((h, w, 3)), jnp.ones((h, w, 3)), mask, tgt)
        return loss, mask

    loss_grad = jax.jit(jax.value_and_grad(jx_loss, argnums=3, has_aux=True))
    outs = [loss_grad(geo.vertices[b].numpy(), cam.to_world[b].numpy(), cam.fov[b].numpy(),
                      jnp.zeros(3), target[b]) for b in range(B)]
    (loss_j, mask_j), grad_j = zip(*(aux for aux, _ in outs)), [g for _, g in outs]

    delta = torch.zeros(3, requires_grad=True)
    scene = scene.replace(geometry=geo.replace(vertices=geo.vertices + delta))
    mask_t = tc_soft.render_soft_silhouette(scene, TcConfig(width=w, height=h), mesh_id=0)
    assert mask_t.shape == (B, h, w) and 0.05 < float(mask_t.detach().mean()) < 0.95
    _close(mask_t.detach(), np.stack(mask_j))
    loss_t = tc_inverse.hybrid_pose_loss(torch.zeros(B, h, w, 3), torch.ones(B, h, w, 3), mask_t,
                                         torch.as_tensor(target))
    loss_t.backward()
    _close(float(loss_t.detach()), np.mean(loss_j))
    _rel_l2(delta.grad, np.mean(grad_j, axis=0))


def test_ray_chunk_matches_unchunked():
    bridge, randomize, beams = main_path.build("cpu", resolution=8)
    cfg = TcConfig(width=128, height=16, spp=1, max_bounces=1, static_geometry=False)
    seeds = [5, 6]
    with torch.no_grad():
        full = main_path.render_batch(bridge, randomize, beams, seeds, cfg)
        chunked = main_path.render_batch(bridge, randomize, beams, seeds,
                                         cfg.replace(ray_chunk=1000))
    assert full.shape == (2, 16, 128, 3) and full.max() > 0
    torch.testing.assert_close(chunked, full, rtol=1e-6, atol=0.0)
