"""The fused rounding of the general-origin plain versions against numpy
references that form each fused step in float64 and round it once to
float32 (`test_torch_fused._fused64`): B4's and B7g's general Woop test and
B3's Moller-Trumbore test, t bit for bit and prims equal, on soup rays half
of which start on a face (bounce rays, where the terms cancel).
"""

import numpy as np
import torch
from test_torch_fused import _fused64
from test_torch_stream import N_RAYS, _scene, _t

from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel
from fireflies_tpu_torch.render.cuda import intersect_stream as tc_stream

torch.set_num_threads(1)


def _woop_general_numpy(o, d, tmax, woop16, t_min, fused=True):
    """The general Woop test of the streamed kernels in numpy over every
    (ray, face) pair, each fused step formed in float64 and rounded once to
    float32 (or, with fused=False, every operation rounded on its own), then
    the closest hit by argmin.  Returns (t, prim) of the rays."""
    w = [woop16[k][None] for k in range(12)]
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*o.T, *d.T))
    if fused:
        f = _fused64
    else:
        def f(a, b, c):
            return (a * b + c).astype(np.float32)
    o_ = [f(w[3 * k + 2], oz, f(w[3 * k + 1], oy, f(w[3 * k], ox, -w[9 + k]))) for k in range(3)]
    d_ = [f(w[3 * k + 2], dz, f(w[3 * k + 1], dy, w[3 * k] * dx)) for k in range(3)]
    sgn = np.where(d_[2] >= 0, np.float32(1), np.float32(-1))
    dn = d_[2] * sgn
    tn = -o_[2] * sgn
    u_n, v_n = f(o_[0], dn, tn * d_[0]), f(o_[1], dn, tn * d_[1])
    eps = np.float32(1e-6)
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = ((dn > np.float32(1e-12)) & (u_n >= -eps * dn) & (v_n >= -eps * dn)
              & (u_n + v_n <= np.float32(1.0 + 1e-6) * dn) & (tn > np.float32(t_min) * dn)
              & (tn < tmax[:, None] * dn))
        t = np.where(ok, tn / np.where(ok, dn, np.float32(1)), np.float32(3e38))
    prim = np.argmin(t, axis=1)
    best = t[np.arange(t.shape[0]), prim]
    hit = ok.any(axis=1)
    return np.where(hit, best, np.float32(0)), np.where(hit, prim, -1)


def test_general_plain_rounds_fused_steps():
    """The plain general branch (B4, B7g) against a numpy reference that
    forms each fused step in float64 and rounds it once: t bit for bit and
    prims equal, on soup rays half of which start on a face (bounce rays,
    where o' = W o - W v0 cancels), over every face.  The fused steps
    matter here: every operation rounded alone moves t on some rays."""
    verts, faces, _, o, d, tmax = _scene(16, n_variants=1)
    rng = np.random.default_rng(16)
    v = verts[0][faces[rng.integers(0, len(faces), N_RAYS // 2)]]
    bary = rng.dirichlet(np.ones(3), size=N_RAYS // 2)
    o[0, N_RAYS // 2:] = np.einsum("nk,nkc->nc", bary, v).astype(np.float32)
    woop16, _ = tc_stream.pack_woop_streamed(_t(verts), _t(faces, torch.long), None)
    rays, tm, _ = tc_kernel.pack_rays(_t(o), _t(d), _t(tmax))
    t, prim = tc_kernel.woop_hits_plain(rays, tm, woop16, None, 1e-4, tc_stream.STREAM_CHUNK)
    live = tmax[0] >= 0
    w = woop16[0].numpy()
    t_np, p_np = _woop_general_numpy(o[0], d[0], tmax[0], w, 1e-4)
    np.testing.assert_array_equal(prim[0].numpy()[:N_RAYS][live], p_np[live])
    np.testing.assert_array_equal(t[0].numpy()[:N_RAYS][live], t_np[live])
    assert (p_np[live] >= 0).sum() > 100
    t_unfused, _ = _woop_general_numpy(o[0], d[0], tmax[0], w, 1e-4, fused=False)
    assert (t_unfused[live] != t_np[live]).sum() > 0


def _mt_numpy(o, d, tmax, tri, t_min, fused=True):
    """B3's rational Moller-Trumbore test in numpy over every (ray, face)
    pair: with `fused`, each component of P = d x e2 and the dots det, u and
    v formed in float64 and rounded once per fused step, every other
    operation (T, Q = T x e1, t's dot) rounded on its own; without, every
    operation on its own.  Then the closest hit by argmin.  Returns (t, prim)
    of the rays."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tri[k][None] for k in range(9))
    ox, oy, oz, dx, dy, dz = (x[:, None] for x in (*o.T, *d.T))
    if fused:
        def cross(ay, az, by, bz):
            return _fused64(ay, bz, -(az * by))

        def dot(ax, ay, az, bx, by, bz):
            return _fused64(az, bz, _fused64(ay, by, ax * bx))
    else:
        def cross(ay, az, by, bz):
            return ay * bz - az * by

        def dot(ax, ay, az, bx, by, bz):
            return ax * bx + ay * by + az * bz
    px, py, pz = cross(dy, dz, e2y, e2z), cross(dz, dx, e2z, e2x), cross(dx, dy, e2x, e2y)
    det = dot(e1x, e1y, e1z, px, py, pz)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    qx, qy, qz = ty * e1z - tz * e1y, tz * e1x - tx * e1z, tx * e1y - ty * e1x
    sgn = np.where(det >= 0, np.float32(1), np.float32(-1))
    dn = det * sgn
    un = dot(tx, ty, tz, px, py, pz) * sgn
    vn = dot(dx, dy, dz, qx, qy, qz) * sgn
    tn = (e2x * qx + e2y * qy + e2z * qz) * sgn
    eb = np.float32(1e-6) * dn
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = ((dn >= np.float32(1e-9)) & (un >= -eb) & (vn >= -eb) & (un + vn <= dn + eb)
              & (tn > np.float32(t_min) * dn) & (tn < tmax[:, None] * dn))
        t = np.where(ok, tn / np.where(ok, dn, np.float32(1)), np.float32(3e38))
    prim = np.argmin(t, axis=1)
    best = t[np.arange(t.shape[0]), prim]
    hit = ok.any(axis=1)
    return np.where(hit, best, np.float32(0)), np.where(hit, prim, -1)


def test_mt_plain_rounds_fused_steps():
    """B3's and B5's plain version (`mt_hits_plain`) against the
    numpy reference over every face: t bit for bit and prims equal on soup
    rays half of which start on a face.  The fused steps matter: every
    operation rounded alone moves t on some rays."""
    verts, faces, _, o, d, tmax = _scene(18, n_variants=1)
    rng = np.random.default_rng(18)
    v = verts[0][faces[rng.integers(0, len(faces), N_RAYS // 2)]]
    bary = rng.dirichlet(np.ones(3), size=N_RAYS // 2)
    o[0, N_RAYS // 2:] = np.einsum("nk,nkc->nc", bary, v).astype(np.float32)
    tri, _ = tc_kernel.pack_triangles(_t(verts), _t(faces, torch.long))
    rays, tm, _ = tc_kernel.pack_rays(_t(o), _t(d), _t(tmax))
    t, prim = tc_kernel.mt_hits_plain(rays, tm, tri, 1e-4)
    live = tmax[0] >= 0
    tri0 = tri[0].numpy()
    t_np, p_np = _mt_numpy(o[0], d[0], tmax[0], tri0, 1e-4)
    np.testing.assert_array_equal(prim[0].numpy()[:N_RAYS][live], p_np[live])
    np.testing.assert_array_equal(t[0].numpy()[:N_RAYS][live], t_np[live])
    assert (p_np[live] >= 0).sum() > 100
    t_unfused, _ = _mt_numpy(o[0], d[0], tmax[0], tri0, 1e-4, fused=False)
    assert (t_unfused[live] != t_np[live]).sum() > 0
