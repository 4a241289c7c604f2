"""The fused multiply-adds of the plain versions: `fma32` rounds a * b + c
once, as the card's __fmaf_rn, and B1's plain version (the shared-origin
Woop test with fused steps) equals, bit for bit, a numpy reference that
forms each fused step in float64 and rounds it once to float32.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch
from test_torch_stream import N_RAYS, ORIGIN, _scene, _t

from fireflies_tpu_torch.render.cuda import intersect_culled as tc_culled
from fireflies_tpu_torch.render.cuda import intersect_kernel as tc_kernel

torch.set_num_threads(1)


def _round32(exact):
    """The float32 nearest to a Fraction, ties to the even significand."""
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.int32)) & 1))


@pytest.mark.parametrize("case", ["tie", "random"])
def test_fma32_rounds_once(case):
    """`fma32` rounds a * b + c once to float32, as the card's __fmaf_rn: on
    a product exactly halfway between two float32 values plus a tiny c,
    where a float64 sum rounded again to float32 lands on the wrong side,
    and on random operands against exact rational arithmetic."""
    if case == "tie":
        # 24929 * 673 = 2^24 + 1, so a * b = 1 + 2^-24: halfway between 1 and 1 + 2^-23.
        a, b, c = (np.float32(24929 * 2.0**-14),), (np.float32(673 * 2.0**-10),), (2.0**-80,)
    else:
        rng = np.random.default_rng(5)
        a, b = rng.normal(size=(2, 300))
        c = rng.normal(size=300) * np.exp2(rng.integers(-30, 30, size=300))
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    ours = tc_kernel.fma32(_t(a), _t(b), _t(c)).numpy()
    for x, y, z, got in zip(a, b, c, ours):
        want = _round32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
        assert got == want, (x, y, z, got, want)
    if case == "tie":
        assert ours[0] == np.float32(1 + 2.0**-23)
        assert np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0])) == 1.0


def _fused64(a, b, c):
    """One fused step: a * b + c of float32 arrays rounded once to float32.
    The float64 sum s is one rounding from the exact sum, and rounding it
    to float32 again errs only where s is exactly halfway between two
    float32 values (any midpoint nearer the exact sum than s would be a
    nearer float64), so those elements are rounded from exact fractions."""
    a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float64) for x in (a, b, c)))
    s = a * b + c
    out = s.astype(np.float32)
    other = np.nextafter(out, np.where(s > out, np.float32(np.inf), np.float32(-np.inf)))
    mid = (s != out) & ((out.astype(np.float64) + other) / 2 == s)
    for i in zip(*np.nonzero(mid)):
        out[i] = _round32(Fraction(a[i]) * Fraction(b[i]) + Fraction(c[i]))
    return out


def _woop_shared_numpy(d, tmax, woop, t_min, fused=True):
    """The shared-origin Woop test of B1 in numpy over every (ray, face)
    pair, each fused step formed in float64 and rounded once to float32
    (or, with fused=False, every operation rounded on its own), then the
    closest hit by argmin.  Returns (t, prim) of the rays."""
    w = [woop[k][None] for k in range(12)]
    dx, dy, dz = (x[:, None] for x in d.T)
    if fused:
        f = _fused64
    else:
        def f(a, b, c):
            return (a * b + c).astype(np.float32)
    d_ = [f(w[3 * k + 2], dz, f(w[3 * k + 1], dy, w[3 * k] * dx)) for k in range(3)]
    sgn = np.where(d_[2] >= 0, np.float32(1), np.float32(-1))
    dn = d_[2] * sgn
    tn = -w[11] * sgn
    u_n, v_n = f(w[9], dn, tn * d_[0]), f(w[10], dn, tn * d_[1])
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


def test_shared_plain_rounds_fused_steps():
    """B1's plain version (`woop_hits_plain` with fused=True) against the
    numpy reference over every face: t bit for bit and prims equal on the
    live rays of a soup seen from a shared origin.  The fused steps matter:
    every operation rounded alone moves t on some rays."""
    verts, faces, _, _, d, tmax = _scene(17, n_variants=1)
    woop, _ = tc_kernel.pack_triangles_woop(_t(verts), _t(faces, torch.long), _t(ORIGIN[None]),
                                            chunk=tc_culled.CHUNK)
    dirs, tm, _ = tc_kernel.pack_dirs(_t(d), _t(tmax))
    t, prim = tc_kernel.woop_hits_plain(dirs, tm, woop, None, 1e-4, tc_culled.CHUNK, fused=True)
    live = tmax[0] >= 0
    w = woop[0].numpy()
    t_np, p_np = _woop_shared_numpy(d[0], tmax[0], w, 1e-4)
    np.testing.assert_array_equal(prim[0].numpy()[:N_RAYS][live], p_np[live])
    np.testing.assert_array_equal(t[0].numpy()[:N_RAYS][live], t_np[live])
    assert (p_np[live] >= 0).sum() > 100
    t_unfused, _ = _woop_shared_numpy(d[0], tmax[0], w, 1e-4, fused=False)
    assert (t_unfused[live] != t_np[live]).sum() > 0
