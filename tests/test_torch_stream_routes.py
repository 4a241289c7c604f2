"""The dispatcher's face-count routes: with the thresholds lowered below a
300-face soup, shared and general rays take the streamed plain versions (or
B5's) and agree with the brute-force scans (prims equal, t within 1e-5
relative), and the streamed route's emitted normal and material agree with
the gathered ones.
"""

import numpy as np
import pytest
import torch
from test_torch_stream import ORIGIN, _counting, _scene, _t

from fireflies_tpu_torch.render import intersect as tc_intersect
from fireflies_tpu_torch.render.cuda import intersect_general_culled as tc_gculled
from fireflies_tpu_torch.render.cuda import intersect_stream as tc_stream
from fireflies_tpu_torch.render.types import Geometry

torch.set_num_threads(2)


@pytest.mark.parametrize("route", ["streamed", "general_culled"])
def test_dispatcher_routes_by_face_count(monkeypatch, route):
    """With the thresholds lowered below the soup's 300 faces, shared and
    general rays take the streamed plain versions (or B5's), agree with
    the brute-force scans, and the streamed route's emitted normal and
    material agree with the gathered ones."""
    verts, faces, face_mat, o, d, tmax = _scene(15, n_variants=1)
    geo = Geometry(vertices=_t(verts), faces=_t(faces, torch.long),
                   face_mat=_t(face_mat, torch.long), face_mesh=torch.zeros(300, dtype=torch.long))
    ot, dt, tm = _t(o), _t(d), _t(tmax)
    origin = _t(ORIGIN)[None]
    o_s = origin[:, None, :].expand_as(dt)
    if route == "streamed":
        monkeypatch.setattr(tc_intersect, "RESIDENT_MAX_FACES", 0)
        calls = _counting(monkeypatch, tc_stream, "stream_culled_packed_plain")
    else:
        monkeypatch.setattr(tc_intersect, "GEN_CULL_MIN_FACES", 0)
        calls = _counting(monkeypatch, tc_gculled, "intersect_general_culled_packed_plain")
    ref = tc_intersect.intersect_brute(ot, dt, geo, t_max=tm)
    via = tc_intersect.closest_hit(ot, dt, geo, t_max=tm, emit_attrs=True)
    np.testing.assert_array_equal(via.prim.numpy(), ref.prim.numpy())
    np.testing.assert_allclose(via.t.numpy(), ref.t.numpy(), rtol=1e-5, atol=1e-6)
    gathered = tc_intersect._attrs_fallback(via, geo)
    hit = via.valid
    n_k = torch.stack([via.nx, via.ny, via.nz], -1)[hit]
    n_g = torch.stack([gathered.nx, gathered.ny, gathered.nz], -1)[hit]
    torch.testing.assert_close(n_k / n_k.norm(dim=-1, keepdim=True),
                               n_g / n_g.norm(dim=-1, keepdim=True), rtol=1e-5, atol=1e-6)
    assert torch.equal(via.mat[hit].long(), gathered.mat[hit].long())
    np.testing.assert_array_equal(
        tc_intersect.occluded_any(ot, dt, geo, t_max=tm).numpy(),
        tc_intersect.occluded(ot, dt, geo, t_max=tm).numpy())
    expected_general = 2
    if route == "streamed":
        via_s = tc_intersect.closest_hit(o_s, dt, geo, t_max=tm, shared_origin=origin,
                                         emit_attrs=True)
        ref_s = tc_intersect.intersect_brute(o_s, dt, geo, t_max=tm)
        np.testing.assert_array_equal(via_s.prim.numpy(), ref_s.prim.numpy())
        np.testing.assert_array_equal(
            tc_intersect.occluded_any(o_s, dt, geo, t_max=tm, shared_origin=origin).numpy(),
            tc_intersect.occluded(o_s, dt, geo, t_max=tm).numpy())
        expected_general += 2
    assert len(calls) == expected_general
