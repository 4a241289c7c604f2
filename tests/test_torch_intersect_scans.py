"""Port parity for the intersection front end: the port's brute-force
scans against the JAX scans, the dispatchers against the port's scans, and
the small contracts of the kernel wrappers (unknown backends refused,
prebuilt tile lists, launch records).

Inputs and tolerances as tests/test_torch_intersect.py: t within 1e-5
relative; prim exact except where two faces give the same t within 1e-5;
any-hit compares the blocked mask exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_intersect import ORIGIN, _geo_j, _geo_t, _scene, assert_hits_match

import fireflies_tpu.render.intersect as jx_intersect
from fireflies_tpu_torch._build import Kernel
from fireflies_tpu_torch.render import RenderConfig
from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel

torch.set_num_threads(2)


def test_port_scans_match_reference_scans():
    """The port's intersect_brute / occluded against the JAX scans, and the
    two dispatchers against the port's scans."""
    verts, faces, o, d, tmax = _scene(2, n_variants=1)
    geo = _geo_t(verts, faces)
    ot, dt, tm = torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)
    hit = tc_intersect.intersect_brute(ot, dt, geo, t_max=tm)
    blocked = tc_intersect.occluded(ot, dt, geo, t_max=tm)
    ref = jx_intersect.intersect_brute(jnp.asarray(o[0]), jnp.asarray(d[0]),
                                       _geo_j(verts[0], faces), t_max=jnp.asarray(tmax[0]))
    ref_b = jx_intersect.occluded(jnp.asarray(o[0]), jnp.asarray(d[0]),
                                  _geo_j(verts[0], faces), t_max=jnp.asarray(tmax[0]))
    assert_hits_match(hit.t[0], hit.prim[0], ref.t, ref.prim)
    np.testing.assert_array_equal(blocked[0].numpy(), np.asarray(ref_b))

    via = tc_intersect.closest_hit(ot, dt, geo, t_max=tm, emit_attrs=True)
    assert_hits_match(via.t, via.prim, hit.t, hit.prim)
    assert via.mat is not None and via.nx.shape == via.t.shape
    np.testing.assert_array_equal(
        tc_intersect.occluded_any(ot, dt, geo, t_max=tm).numpy(), blocked.numpy())

    origin = torch.as_tensor(ORIGIN)[None]
    o_s = origin[:, None, :].expand_as(dt)
    via_s = tc_intersect.closest_hit(o_s, dt, geo, t_max=tm, shared_origin=origin)
    ref_s = tc_intersect.intersect_brute(o_s, dt, geo, t_max=tm)
    assert_hits_match(via_s.t, via_s.prim, ref_s.t, ref_s.prim)
    np.testing.assert_array_equal(
        tc_intersect.occluded_any(o_s, dt, geo, t_max=tm, shared_origin=origin).numpy(),
        tc_intersect.occluded(o_s, dt, geo, t_max=tm).numpy())


def test_dispatchers_refuse_unknown_backend():
    verts, faces, o, d, _ = _scene(5, n_variants=1)
    geo = _geo_t(verts, faces)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    with pytest.raises(ValueError):
        tc_intersect.closest_hit(ot, dt, geo, backend="jax")
    with pytest.raises(ValueError):
        tc_intersect.occluded_any(ot, dt, geo, backend="pallas")
    with pytest.raises(ValueError):
        RenderConfig(backend="jax")


def test_shared_culled_takes_prebuilt_lists():
    verts, faces, _, d, tmax = _scene(6)
    woop, boxes = tc_kernel.pack_triangles_woop(
        torch.as_tensor(verts), torch.as_tensor(faces, dtype=torch.long),
        torch.as_tensor(np.stack([ORIGIN, ORIGIN + 0.1])), chunk=16)
    dirs, tm, _ = tc_kernel.pack_dirs(torch.as_tensor(d), torch.as_tensor(tmax))
    lists, counts = tc_culled.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)
    built = tc_culled.intersect_culled_packed(dirs, tm, woop, boxes, 1e-4)
    given = tc_culled.intersect_culled_packed(dirs, tm, woop, boxes, 1e-4, lists=lists,
                                              counts=counts)
    assert torch.equal(built[0], given[0]) and torch.equal(built[1], given[1])
    assert bool((built[1] >= 0).any())


def test_kernel_records_inputs_only_on_request():
    kernel = Kernel("ff_unused", [])
    kernel.record(a=1)
    assert kernel.recorded is None
    kernel.recorded = []
    kernel.record(a=1, b=2)
    assert kernel.recorded == [{"a": 1, "b": 2}] and kernel.launches == 0
