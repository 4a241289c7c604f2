"""Port parity for the projection classes and the geometry helpers they
stand on, on the same inputs as the JAX package:

  * the rest of `utils/math` (look-at, skew, vector-to-vector rotations,
    homogeneous points, normals, min-max normalization, dot, the numpy
    point transform) and `utils/intersections` (ray-plane, ray-box,
    sphere-sphere) within 1e-6;
  * `Camera`: accessors, keys, the projection matrix, `world` with and
    without randomized params, `origin`, `points_to_ndc` / `pointsToNDC`;
  * `Laser`: the generators (by count; random with the JAX draws given as
    `ndc`; Poisson-disk with the numpy Bridson on both sides), world rays,
    NDC round trips, epipolar segments and their rendered lines (1e-6);
  * `Laser.save` / `load` across the packages, both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import fireflies_tpu as ff
from fireflies_tpu import projection as jx_projection
from fireflies_tpu import sampling as jx_sampling
from fireflies_tpu.projection import laser as jx_laser
from fireflies_tpu.sampling import poisson as jx_poisson
from fireflies_tpu.utils import intersections as jx_isect
from fireflies_tpu.utils import math as jx_math
from fireflies_tpu_torch.entity.transformable import Transformable
from fireflies_tpu_torch.projection import camera as tc_camera
from fireflies_tpu_torch.projection import laser as tc_laser
from fireflies_tpu_torch.utils import intersections as tc_isect
from fireflies_tpu_torch.utils import math as tc_math

torch.set_num_threads(2)

CAM_WORLD = jx_math.look_at_np([0.3, -0.2, 2.5], [0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
PROJ_WORLD = jx_math.look_at_np([0.8, 0.1, 2.2], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])


def _close(got, ref, tol=1e-6):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(np.abs(ref).max(), 1.0))


def test_math_and_intersections_match():
    rng = np.random.default_rng(1)
    t = torch.from_numpy
    v1, v2 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    for a, b in ((v1, v2), (v1, v1 * 2.0), (v1, -v1)):
        got = tc_math.rotation_matrix_from_vectors(t(a), t(b))
        _close(got, jx_math.rotation_matrix_from_vectors(jnp.asarray(a), jnp.asarray(b)))
        _close(got @ t(a / np.linalg.norm(a)), b / np.linalg.norm(b), 1e-5)
    _close(tc_math.skew(t(v1)), jx_math.skew(jnp.asarray(v1)))
    _close(tc_math.look_at(t(v1), t(v2), [0.0, 1.0, 0.0]), jx_math.look_at(v1, v2, [0.0, 1.0, 0.0]))
    pts = rng.normal(size=(9, 3)).astype(np.float32)
    _close(tc_math.convert_points_to_homogeneous(t(pts)),
           jx_math.convert_points_to_homogeneous(jnp.asarray(pts)))
    _close(tc_math.transform_points_np(pts, CAM_WORLD), jx_math.transform_points_np(pts, CAM_WORLD))
    m = (CAM_WORLD @ np.diag([1.5, 0.5, 2.0, 1.0])).astype(np.float32)
    _close(tc_math.transform_normals(t(pts), t(m)), jx_math.transform_normals(jnp.asarray(pts), m))
    x = rng.normal(size=(5, 4)).astype(np.float32)
    _close(tc_math.normalize(t(x)), jx_math.normalize(jnp.asarray(x)))
    _close(tc_math.normalize(torch.ones(3)), jx_math.normalize(jnp.ones(3)))
    for axis in (0, -1):
        _close(tc_math.normalize_channelwise(t(x), axis),
               jx_math.normalize_channelwise(jnp.asarray(x), axis))
    _close(tc_math.dot(t(x), t(x), keepdims=True), jx_math.dot(jnp.asarray(x), x, keepdims=True))
    lo, hi = np.zeros(3, np.float32), np.asarray([1.0, 2.0, 4.0], np.float32)
    u = tc_math.random_between(torch.Generator().manual_seed(0), lo, hi)
    assert u.shape == (3,) and bool(((u >= t(lo)) & (u < t(hi))).all())

    o = rng.normal(size=(12, 3)).astype(np.float32)
    d = rng.normal(size=(12, 3)).astype(np.float32)
    d[0] = [1.0, 0.0, 0.0]  # parallel to the plane below: the clamped denominator
    po, pn = np.asarray([0.1, 0.2, 0.3], np.float32), np.asarray([0.0, 0.0, 1.0], np.float32)
    _close(tc_isect.ray_plane_t(t(o), t(d), t(po), t(pn)), jx_isect.ray_plane_t(o, d, po, pn))
    _close(tc_isect.ray_plane(t(o), t(d), t(po), t(pn)), jx_isect.ray_plane(o, d, po, pn), 1e-5)
    inv = (1.0 / d).astype(np.float32)
    bmin, bmax = np.full(3, -0.5, np.float32), np.full(3, 0.7, np.float32)
    hit, tn = tc_isect.ray_aabb(t(o), t(inv), t(bmin), t(bmax))
    hit_ref, tn_ref = jx_isect.ray_aabb(o, inv, bmin, bmax)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    assert 0 < int(hit.sum()) < 12
    _close(tn, tn_ref)
    r = rng.uniform(0.1, 1.0, 12).astype(np.float32)
    np.testing.assert_array_equal(
        tc_isect.sphere_sphere(t(o), t(r), t(d), t(r)).numpy(),
        np.asarray(jx_isect.sphere_sphere(o, r, d, r)))


def _pair(name, world, parent_world=None):
    """The same entity (with a parent when given) in both packages."""
    jt, tt = ff.Transformable(name), Transformable(name)
    jt.set_world(world)
    tt.set_world(world)
    if parent_world is not None:
        jp, tp = ff.Transformable(name + "-parent"), Transformable(name + "-parent")
        jp.set_world(parent_world)
        tp.set_world(parent_world)
        jt.set_parent(jp)
        tt.set_parent(tp)
    return jt, tt


def test_camera_matches():
    parent = jx_math.translation_matrix_np([0.0, 0.2, 0.1])
    jt, tt = _pair("Camera", CAM_WORLD, parent)
    np.testing.assert_array_equal(tt.non_randomized_world(), jt.non_randomized_world())
    jcam = jx_projection.Camera(jt, fov=50.0, near_clip=0.05, far_clip=20.0)
    tcam = tc_camera.Camera(tt, fov=50.0, near_clip=0.05, far_clip=20.0, device="cpu")
    for name in ("fov", "near_clip", "far_clip"):
        assert getattr(tcam, name)() == getattr(jcam, name)()
    assert tcam.full_key("fov") == tcam.key() + ".x_fov" and tcam.transformable() is tt
    assert tcam.key().startswith("PerspectiveCamera")
    np.testing.assert_array_equal(tcam.perspective(), np.asarray(jcam.perspective()))
    _close(tcam.world(), jcam.world())
    _close(tcam.origin(), jcam.origin())
    pts = np.random.default_rng(4).normal(size=(10, 3)).astype(np.float32)
    _close(tcam.points_to_ndc(torch.from_numpy(pts)), jcam.points_to_ndc(jnp.asarray(pts)), 1e-5)
    moved = jx_math.translation_matrix_np([0.0, 0.0, 0.5]) @ CAM_WORLD
    params = {"Camera.to_world": torch.from_numpy(moved)}
    _close(tcam.pointsToNDC(torch.from_numpy(pts), params),
           jcam.pointsToNDC(jnp.asarray(pts), {"Camera.to_world": jnp.asarray(moved)}), 1e-5)
    _close(tcam.origin({"other.to_world": params["Camera.to_world"]}), jcam.origin())


def test_laser_generators_and_epipolar_lines_match(monkeypatch):
    monkeypatch.setattr(jx_sampling, "bridson", jx_poisson._bridson_numpy)
    fov = 25.0
    by_count = tc_laser.generate_uniform_rays_by_count(4, 3, fov, device="cpu")
    _close(by_count, jx_laser.generate_uniform_rays_by_count(4, 3, fov))
    key = jax.random.key(7)
    ndc = np.asarray(jax.random.uniform(key, (20, 2), minval=-1.0, maxval=1.0))
    _close(tc_laser.generate_random_rays(None, 20, fov, ndc=torch.from_numpy(ndc)),
           jx_laser.generate_random_rays(key, 20, fov))
    drawn = tc_laser.generate_random_rays(torch.Generator().manual_seed(0), 20, fov)
    assert float(tc_camera.directions_to_ndc(drawn, fov).abs().max()) <= 1.0
    blue = tc_laser.generate_blue_noise_rays(96, 64, 30, fov, seed=2, device="cpu")
    blue_ref = jx_laser.generate_blue_noise_rays(96, 64, 30, fov, seed=2)
    assert blue.shape[0] > 15
    _close(blue, blue_ref)

    jp, tp = _pair("Projector", PROJ_WORLD)
    jc, tc = _pair("Camera", CAM_WORLD)
    rays = jx_laser.generate_uniform_rays_by_count(3, 4, 20.0)
    jl = jx_projection.Laser(jp, rays, fov=20.0, near_clip=1.0, far_clip=4.0)
    tl = tc_laser.Laser(tp, torch.from_numpy(np.asarray(rays)), fov=20.0, near_clip=1.0,
                        far_clip=4.0)
    jcam = jx_projection.Camera(jc, fov=60.0)
    tcam = tc_camera.Camera(tc, fov=60.0, device="cpu")
    _close(tl.rays(), jl.rays())
    _close(tl.originPerRay(), jl.origin_per_ray())
    ndc_ref = jl.project_rays_to_ndc()
    _close(tl.projectRaysToNDC(), ndc_ref)
    _close(tl.project_ndc_points_to_rays(tl.project_rays_to_ndc()), rays)
    _close(tl.projectNDCPointsToWorld(torch.from_numpy(np.asarray(ndc_ref))),
           jl.project_ndc_points_to_rays(ndc_ref))
    segs = tc_laser.epipolar_line_segments(tl.local_rays(), tl.world(), tcam.world(), 60.0, 1.0, 4.0)
    segs_ref = jx_laser.epipolar_line_segments(rays, jl.world(), jcam.world(), 60.0, 1.0, 4.0)
    _close(segs, segs_ref, 1e-5)
    img = tl.render_epipolar_lines(tcam, 30.0, (32, 48))
    img_ref = np.asarray(jl.render_epipolar_lines(jcam, 30.0, (32, 48)))
    assert img.shape == (12, 32, 48) and img_ref.max() > 0.5
    np.testing.assert_allclose(img.numpy(), img_ref, rtol=0, atol=1e-5 * img_ref.max())
    tl.normalize_rays()
    tl.clamp_to_fov(0.5)
    assert float(tl.project_rays_to_ndc().abs().max()) <= 0.5 + 1e-6


def test_laser_save_load_across_packages(tmp_path):
    jp, tp = _pair("Projector", PROJ_WORLD)
    rays = np.array(jx_laser.generate_uniform_rays_by_count(3, 3, 30.0))
    rays[0, 0] = 2.5e-9  # a component written with an exponent
    # near_clip's shortest repr, 1e-05, has no '.': YAML 1.1 would read it
    # as a string, so both packages write 1.0e-05.
    jl = jx_projection.Laser(jp, rays, fov=30.0, near_clip=1e-5, far_clip=250.0)
    jl.save(str(tmp_path / "jax.yml"))
    loaded = tc_laser.Laser.load(str(tmp_path / "jax.yml"), tp, device="cpu")
    np.testing.assert_array_equal(loaded.local_rays().numpy(), rays)
    assert (loaded.fov(), loaded.near_clip(), loaded.far_clip()) == (30.0, 1e-5, 250.0)
    loaded.save(str(tmp_path / "port.yml"))
    # The port writes the bytes yaml.safe_dump writes.
    assert (tmp_path / "port.yml").read_bytes() == (tmp_path / "jax.yml").read_bytes()
    assert "1.0e-05" in (tmp_path / "port.yml").read_text()
    back = jx_projection.Laser.load(str(tmp_path / "port.yml"), jp)
    np.testing.assert_array_equal(np.asarray(back.local_rays()), rays)
    assert (back.fov(), back.near_clip(), back.far_clip()) == (30.0, 1e-5, 250.0)
    again = tc_laser.Laser.load(str(tmp_path / "port.yml"), tp, device="cpu")
    np.testing.assert_array_equal(again.local_rays().numpy(), rays)
    # A JSON file of the earlier port still loads.
    (tmp_path / "old.json").write_text(
        '{"rays": [[0.0, 0.0, -1.0]], "fov": 30.0, "near_clip": 1.0e-05, "far_clip": 250.0}\n')
    old = tc_laser.Laser.load(str(tmp_path / "old.json"), tp, device="cpu")
    assert old.local_rays().tolist() == [[0.0, 0.0, -1.0]] and old.near_clip() == 1e-5