"""X1's split-TF32 arithmetic on the CPU (`fireflies_tpu_torch.experiments.
intersect_mxu`): `tf32_round` against an independent rounding of float32 to
TF32 (nearest, ties away from zero, as `cvt.rna.tf32.f32`), the split
products against the float64 product W d within `SPLIT_BOUND`, and the
premise of the CUDA kernel's filter (`pair_filter`, `FILTER_C`): it passes
every pair the plain version accepts, with the tensor cores' sum anywhere
within `TC_SUM_BOUND`, and would not with d' from one TF32 pass.

Inputs: seeded numpy values (normal, at ties, subnormal, infinite, NaN) and
the soups of tests/test_torch_mxu.py.
"""

import numpy as np
import pytest
import torch
from test_torch_mxu import _soup
from test_torch_stream import _t

from fireflies_tpu_torch.experiments import intersect_mxu as mx
from fireflies_tpu_torch.render.cuda import intersect_kernel as ik

torch.set_num_threads(1)


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """float32 -> TF32 by comparing the two neighbours in float64: the value
    with the low 13 bits cleared and the next TF32 number away from zero (one
    TF32 step, 2^(e - 10) for exponent e, further; 2^128 rounds to infinity);
    the nearer wins, a tie the one away from zero."""
    bits = x.view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    exponent = ((bits >> 23) & 0xFF).astype(np.int64)
    step = np.ldexp(1.0, np.maximum(exponent, 1) - 127 - 10)
    x64 = x.astype(np.float64)
    up = down + np.copysign(step, x64)
    with np.errstate(over="ignore"):
        return np.where(np.abs(x64 - down) < np.abs(up - x64), down, up).astype(np.float32)


def test_tf32_round_is_round_to_nearest_away():
    """`tf32_round` keeps 10 stored mantissa bits (the low 13 zero), equals
    the reference rounding on normal values, exact ties, subnormals and
    values past the largest TF32 number, passes infinities and NaN through,
    and its hi/lo split leaves at most 2^-22 |x| (2^-137, half the least
    TF32 step, below 2^-115)."""
    rng = np.random.default_rng(0)
    normal = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    bits = rng.integers(0, 2**31, 4000, dtype=np.uint64).astype(np.uint32)
    ties = ((bits & np.uint32(0x7FFFE000)) | np.uint32(0x1000)).view(np.float32)  # halfway
    sub = (rng.integers(1, 2**23, 2000, dtype=np.uint64).astype(np.uint32)).view(np.float32)
    edge = np.array([3.4028235e38, -3.4028235e38, 0.0, -0.0, 1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11],
                    np.float32)
    x = np.concatenate([normal, ties, -ties, sub, -sub, edge]).astype(np.float32)
    x = x[np.isfinite(x)]
    hi = mx.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(hi, _rna_reference(x))
    finite = np.isfinite(hi)
    assert not (hi[finite].view(np.uint32) & 0x1FFF).any()
    assert np.isinf(hi[x == np.float32(3.4028235e38)]).all()  # past the largest TF32 number
    lo = mx.tf32_round(torch.from_numpy(x - np.where(finite, hi, 0))).numpy()
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))[finite]
    assert np.all(err <= np.maximum(2.0**-22 * np.abs(x[finite].astype(np.float64)), 2.0**-137))
    special = torch.tensor([np.inf, -np.inf, np.nan])
    out = mx.tf32_round(special)
    assert torch.equal(out[:2], special[:2]) and bool(torch.isnan(out[2]))


@pytest.mark.parametrize("seed", [31, 33])
def test_split_products_within_split_bound(seed):
    """The eight split products of d'_k, summed in float64, lie within
    SPLIT_BOUND S_k of s (W d) in float64, and S_k is within 2^-9 of
    sum_i |W_ki| |s d_i|; the scale s is within 2^-11 of 1 and takes d_x to
    its TF32 rounding, the kernel's scaled d_x, within 2^-23."""
    verts, faces, d, _, origin = _soup(seed)
    woop, _ = ik.pack_triangles_woop(_t(verts), _t(faces, torch.long), _t(origin), chunk=mx.CHUNK)
    for bi in range(2):
        rays, w = _t(d[bi]), woop[bi, :9]
        s, m, s_abs = mx.split_products(rays, w)
        assert float((s.double() - 1).abs().max()) <= 2.0**-11
        hx = mx.tf32_round(rays[:, 0]).double()
        assert bool(((s * rays[:, 0]).double() - hx).abs().le(2.0**-23 * hx.abs()).all())
        scaled = s.double()[:, None] * rays.double()
        for k in range(3):
            rows = w[3 * k:3 * k + 3].double()
            truth = scaled @ rows
            assert bool(((m[k] - truth).abs() <= mx.SPLIT_BOUND * s_abs[k]).all())
            ref_abs = scaled.abs() @ rows.abs()
            assert bool(((s_abs[k] - ref_abs).abs() <= 2.0**-9 * ref_abs).all())


def test_filter_passes_every_pair_the_plain_version_accepts():
    """On a soup with per-ray t_max and dead rays, for every pair of every
    ray: the split products' exact sum M lies within (FILTER_C -
    TC_SUM_BOUND) S of s times the plain version's float32 d', so the
    tensor cores' d', within TC_SUM_BOUND S of M, lies within FILTER_C S of
    it; the kernel's filter (`pair_filter`) on d' at either end of that
    range passes every pair the plain version accepts; and d' from one TF32
    pass (no lo parts) lies farther than FILTER_C S from the plain d' on
    some pairs, so the filter would not hold for it."""
    verts, faces, d, _, origin = _soup(32)
    woop, _ = ik.pack_triangles_woop(_t(verts), _t(faces, torch.long), _t(origin), chunk=mx.CHUNK)
    worst, worst_single, n_ok, sent = 0.0, 0.0, 0, 0
    for bi in range(2):
        rays, rows = _t(d[bi]), woop[bi]
        dp, _, _, _, _, ok = mx._pair_test(rays[:, 0:1], rays[:, 1:2], rays[:, 2:3], rows, 1e-4)
        plain = torch.stack(dp).double()
        s, m, s_abs = mx.split_products(rays, rows[:9])
        on = s_abs > 0
        worst = max(worst, float(((m - s.double()[:, None] * plain).abs()[on] / s_abs[on]).max()))
        for sign in (-1.0, 1.0):
            passes = mx.pair_filter(rays, rows, 1e-4, (m + sign * mx.TC_SUM_BOUND * s_abs).float())
            assert bool(passes[ok].all())
            sent = max(sent, int(passes.sum()))
        n_ok += int(ok.sum())
        hd, hw = mx.tf32_round(rays).double(), mx.tf32_round(rows[:9]).double()
        single = torch.stack([hd @ hw[3 * k:3 * k + 3] for k in range(3)])
        worst_single = max(worst_single, float(((single - plain).abs()[on] / s_abs[on]).max()))
    assert worst <= mx.FILTER_C - mx.TC_SUM_BOUND, worst
    assert worst_single > mx.FILTER_C, worst_single
    assert n_ok > 1000 and sent < 0.05 * d[0].shape[0] * woop.shape[2], (n_ok, sent)
