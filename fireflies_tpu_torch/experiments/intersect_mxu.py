"""X1: the shared-origin Woop closest hit of the reference's matrix-unit
experiment, as a CUDA kernel (`csrc/intersect_mxu.cu`) with its plain
PyTorch version.

Counterpart of experiments/intersect_mxu.py (`intersect_mxu_shared`, Pallas
body `_kernel_mxu`).  Like the reference it is not wired into the renderer:
`intersect_mxu_shared` is its only entry point.  The TPU kernel forms the
per-pair transform d' = W d of a 128-ray x 128-face block as three K=8
matmuls at Precision.HIGHEST; the CUDA kernel forms it on the tensor cores
as split-TF32 mma.sync tiles (16 rays x 8 faces x 8 product slots: each
operand split into TF32 hi and lo parts, W_hi d_hi + W_hi d_lo + W_lo d_hi,
with the ray scaled so that d_x is a TF32 number; see the .cu header).
What both compute:

  * faces in clusters of 128 in the caller's order (no Morton order),
    packed by `pack_triangles_woop` at chunk 128: Woop rows W0, W1, W2 and
    o' = W (o - v0), zero rows where det = |e1 x e2|^2 < 1e-18 and for the
    padding faces, cluster boxes shifted by -origin;
  * directions packed by `pack_dirs`: SoA, padded to whole 2048-ray tiles
    with d = (0, 0, 1) and tmax = -1 (the reference's K=8 slot layout is a
    matmul artefact);
  * per pair: dp = W d; unless |dp_z| < 1e-12, t = -o'_z (1 / dp_z),
    u = o'_x + t dp_x, v = o'_y + t dp_y; a hit when u, v >= -1e-6,
    u + v <= 1 + 1e-6 and t_min < t < the running best, so the closest hit
    wins and a t-tie goes to the lowest face id;
  * t_max after the scan: a miss (t = 0, prim = -1) unless the best t is
    below the ray's t_max.  `any_hit` changes nothing, as in the reference.

Which clusters a ray is tested against changes no result: the plain
version, like the reference, tests a cluster for a group of 128 consecutive
rays when the slab test of any of them passes (padding and dead rays
included, no tmax or running best in tfar); the kernel for a warp of 32
rays when the slab test of any of its live rays passes, with tfar capped at
the ray's tmax and running best, and `tested` counts the clusters a ray's
warp tested.

The kernel returns the plain version's (t, prim) bit for bit.  Its tensor
cores' d' only filters the pairs (`pair_filter` is the filter's plain
version): with S_k the sum of the absolute split products of d'_k, that
d' lies within FILTER_C S_k of s times the plain version's float32 d'
(the split, `SPLIT_BOUND`; the tensor cores' sum, `TC_SUM_BOUND`, which
`perf_probe tc_sum` measures the premises of; the plain version's own
roundings), so every pair the plain version accepts with a t below the
running best passes the filter's widened test, and the kernel repeats
the plain version's float32 operations on each pair that passes.

Layouts, with a leading variant axis B:

  dirs  (B, 3, R/128, 128) f32   directions from the shared origin
  tmax  (B, R/128, 128) f32      tmax < 0 marks a dead ray (or padding)
  woop  (B, 12, NC * 128) f32    W0, W1, W2, o' (`pack_triangles_woop`)
  boxes (B, 6, NC) f32           cluster AABBs shifted by -origin
"""

from __future__ import annotations

import ctypes

import torch

from fireflies_tpu_torch._build import Kernel, check_cuda, ptr, stream_of, tested_ptr
from fireflies_tpu_torch.render.cuda.intersect_kernel import (
    LANES,
    RAY_TILE,
    _BIG,
    _EPS_BARY,
    _carry_min,
    live_ray_blocks,
    pack_dirs,
    pack_triangles_woop,
)

Tensor = torch.Tensor

CHUNK = 128  # faces per cluster, the matmul width of the reference
GROUP = LANES  # rays that vote together on a cluster in the plain version
WARP = 32  # rays that vote together on a cluster in the kernel

# The filter's terms, relative to S_k, the absolute sum of d'_k's split
# products: the split products against s W d (three lost lo parts of 2^-22
# and the scaled d_y, d_z rounded once, 2^-24; `tests/test_torch_mxu_split.py`
# holds it); the tensor cores' sum of one k8 step against the products'
# exact sum: at most seven additions that each keep 25 bits below their
# larger operand, truncated, and a final rounding toward zero, 7 x 2^-25 +
# 2^-23 (`perf_probe tc_sum`); and FILTER_C, the bound the kernel's filter
# assumes for all of them and the plain version's own roundings together
# (csrc/intersect_mxu.cu kFilter / 2).
SPLIT_BOUND = 2.0**-20
TC_SUM_BOUND = 7 * 2.0**-25 + 2.0**-23
FILTER_C = 2.0**-18
_REACH = 1.5  # kReach
_WIDE = 0.25  # kWide
KERNEL = Kernel("ff_intersect_mxu_shared", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # dirs tmax woop boxes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out_t out_prim tested-or-null
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B R NC
    ctypes.c_float, ctypes.c_void_p,  # t_min stream
])


def _safe_inv(x: Tensor) -> Tensor:
    tiny = x.abs() < 1e-30
    return torch.where(tiny, torch.where(x < 0.0, -1e30, 1e30), 1.0 / torch.where(tiny, 1.0, x))


def group_votes(dirs_soa: Tensor, boxes: Tensor, t_min: float) -> Tensor:
    """(B, R/128, NC) bool: whether any ray of each group of 128 consecutive
    rays passes the slab test of each cluster (padding and dead rays vote;
    t_min clamps tnear, tfar has no tmax)."""
    b, _, rows, _ = dirs_soa.shape
    out = torch.empty(b, rows, boxes.shape[2], dtype=torch.bool, device=dirs_soa.device)
    for bi in range(b):
        inv = [_safe_inv(dirs_soa[bi, k])[..., None] for k in range(3)]  # (rows, 128, 1)
        t0 = [boxes[bi, k] * inv[k] for k in range(3)]  # (rows, 128, NC)
        t1 = [boxes[bi, 3 + k] * inv[k] for k in range(3)]
        tnear = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                            torch.minimum(t0[1], t1[1])),
                              torch.clamp(torch.minimum(t0[2], t1[2]), min=t_min))
        tfar = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                           torch.maximum(t0[1], t1[1])),
                             torch.maximum(t0[2], t1[2]))
        out[bi] = (tnear <= tfar).any(dim=1)
    return out


def _pair_test(dx: Tensor, dy: Tensor, dz: Tensor, rows: Tensor, t_min: float):
    """The reference's pair test of rays (N, 1) against faces' 12 Woop rows
    (12, F), each operation its own elementwise op in float32:
    (d' (3 tensors (N, F)), tiny, t, u, v, ok)."""
    (w00, w01, w02, w10, w11, w12, w20, w21, w22, opx, opy, opz) = (rows[k, None]
                                                                   for k in range(12))
    dp0 = w00 * dx + w01 * dy + w02 * dz
    dp1 = w10 * dx + w11 * dy + w12 * dz
    dp2 = w20 * dx + w21 * dy + w22 * dz
    tiny = dp2.abs() < 1e-12
    invz = torch.where(tiny, 0.0, 1.0 / torch.where(tiny, 1.0, dp2))
    t = -opz * invz
    u = opx + t * dp0
    v = opy + t * dp1
    ok = ~tiny & (u >= -_EPS_BARY) & (v >= -_EPS_BARY) & (u + v <= 1.0 + _EPS_BARY) & (t > t_min)
    return (dp0, dp1, dp2), tiny, t, u, v, ok


def intersect_mxu_packed_plain(dirs_soa: Tensor, tmax_tiles: Tensor, woop: Tensor, boxes: Tensor,
                               t_min: float, any_hit: bool = False):
    """Plain PyTorch version of X1: the group vote, then the pair test of
    each voted cluster as a broadcast over (live rays, 128 faces), each
    operation its own elementwise op in float32; closest hit by argmin
    (first index on ties), t_max after the scan.
    Returns (t, prim) shaped like `tmax_tiles`; prim = -1 on a miss."""
    del any_hit  # the reference returns the closest hit in both modes
    b = dirs_soa.shape[0]
    r = tmax_tiles[0].numel()
    rays = dirs_soa.reshape(b, 3, r)
    tmax = tmax_tiles.reshape(b, r)
    votes = group_votes(dirs_soa, boxes, t_min)
    out_t = torch.zeros(b, r, dtype=torch.float32, device=rays.device)
    out_p = torch.full((b, r), -1, dtype=torch.int32, device=rays.device)
    for bi, idx in live_ray_blocks(tmax):
        dx, dy, dz = (rays[bi, k, idx, None] for k in range(3))
        voted = votes[bi, idx // GROUP]  # (rays, NC)
        best_t = torch.full_like(dx[:, 0], _BIG)
        best_p = torch.full(best_t.shape, -1, dtype=torch.int32, device=best_t.device)
        for c in range(boxes.shape[2]):
            on = voted[:, c, None]
            if not bool(on.any()):
                continue
            *_, t, _, _, ok = _pair_test(dx, dy, dz, woop[bi, :, c * CHUNK:(c + 1) * CHUNK], t_min)
            best_t, best_p = _carry_min(torch.where(ok & on, t, _BIG), c * CHUNK, best_t, best_p)
        hit = (best_p >= 0) & (best_t < tmax[bi, idx])
        out_t[bi, idx] = torch.where(hit, best_t, 0.0)
        out_p[bi, idx] = torch.where(hit, best_p, -1)
    return out_t.reshape(tmax_tiles.shape), out_p.reshape(tmax_tiles.shape)


def tf32_round(x: Tensor) -> Tensor:
    """`cvt.rna.tf32.f32` in plain PyTorch: float32 `x` rounded to TF32's
    10 stored mantissa bits, to nearest with ties away from zero, so the
    low 13 bits of the result are zero.  Infinities and NaN pass through; a
    finite value beyond the largest TF32 number rounds to infinity."""
    bits = x.contiguous().view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    out = ((mag & ~0x1FFF) | (bits & ~0x7FFFFFFF)).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def split_products(d: Tensor, w: Tensor):
    """The kernel's split of rays d (N, 3) and faces' W rows w (9, F), both
    float32: s (N,) float32, the ray's scale (hi(d_x) / d_x, 1 where
    hi(d_x) = 0), and M, S (3, N, F) float64: for each component of d', the
    exact sum of the eight products the kernel's k8 step multiplies and the
    sum of their absolute values.  M_k approximates s d'_k."""
    dx = d[:, 0]
    hx = tf32_round(dx)
    s = torch.where(hx != 0, hx / torch.where(dx != 0, dx, 1.0), torch.ones_like(dx))
    sy, sz = s * d[:, 1], s * d[:, 2]
    hy, hz = tf32_round(sy), tf32_round(sz)
    ly, lz = tf32_round(sy - hy), tf32_round(sz - hz)
    a = torch.stack([hx, hy, hz, ly, lz, hx, hy, hz]).double()  # (8, N), the K slots
    wh = tf32_round(w)
    wl = tf32_round(w - wh)
    m, s_abs = [], []
    for k in range(3):
        h, lo = wh[3 * k:3 * k + 3], wl[3 * k:3 * k + 3]
        bk = torch.cat([h, h[1:], lo]).double()  # (8, F)
        total = torch.zeros(a.shape[1], bk.shape[1], dtype=torch.float64, device=a.device)
        total_abs = torch.zeros_like(total)
        for j in range(8):
            prod = a[j, :, None] * bk[j, None, :]  # exact
            total += prod
            total_abs += prod.abs()
        m.append(total)
        s_abs.append(total_abs)
    return s, torch.stack(m), torch.stack(s_abs)


def pair_filter(d: Tensor, rows: Tensor, t_min: float, dp: Tensor) -> Tensor:
    """The kernel's filter in plain PyTorch: for rays d (N, 3) against
    faces' 12 Woop rows (12, F), given the d' the tensor cores return, dp
    (3, N, F) float32 scaled by each ray's s (`split_products`), whether
    each pair goes on to the exact test (no running best: every pair that
    passes X1's test widened by the filter's width e, or whose e exceeds
    1/4; t > 0 stands for t > t_min when t_min >= 0).  Each operation is
    one float32 op, as in the kernel."""
    dx = d[:, 0]
    hx = tf32_round(dx)
    s = torch.where(hx != 0, hx / torch.where(dx != 0, dx, 1.0), torch.ones_like(dx))
    sd = torch.stack([hx, s * d[:, 1], s * d[:, 2]], 1)
    dmax = sd.abs().amax(1)[:, None]
    n = [rows[3 * k:3 * k + 3].abs().sum(0) for k in range(3)]
    o = rows[9:].abs()
    h = torch.maximum(n[2], torch.maximum(o[2] * n[0] + _REACH * (2.0 + o[0]) * n[2],
                                          o[2] * n[1] + _REACH * (2.0 + o[1]) * n[2]))
    rz = 1.0 / dp[2]
    t = -rows[11] * rz
    e = dmax * (2.0 * FILTER_C * h) * rz.abs()
    u = rows[9] + t * dp[0]
    v = rows[10] + t * dp[1]
    lo = -_EPS_BARY - e
    floor = 0.0 if t_min >= 0.0 else -_BIG
    near = (u >= lo) & (v >= lo) & (u + v <= 2.0 * e + (1.0 + _EPS_BARY)) & (t > floor)
    return near | (e > _WIDE)


def intersect_mxu_packed(dirs_soa: Tensor, tmax_tiles: Tensor, woop: Tensor, boxes: Tensor,
                         t_min: float, any_hit: bool = False, tested: Tensor | None = None):
    """X1 on packed inputs.  CPU tensors take the plain version; CUDA tensors
    launch `csrc/intersect_mxu.cu` (d' as split-TF32 mma.sync tiles that
    filter the pairs, the plain version's test on those that pass, 128 rays
    a block, grid (R/128, B)) or raise.  `tested` (see
    `_build.tested_ptr`) receives the kernel's per-ray count of clusters
    its warp tested."""
    if dirs_soa.device.type == "cpu":
        if tested is not None:
            raise ValueError("tested: only the CUDA kernel counts tested clusters")
        return intersect_mxu_packed_plain(dirs_soa, tmax_tiles, woop, boxes, t_min, any_hit)
    dev = dirs_soa.device
    b, _, rows, _ = dirs_soa.shape
    r = rows * LANES
    nc = boxes.shape[2]
    if r % RAY_TILE or woop.shape[2] != nc * CHUNK:
        raise ValueError(f"bad packing: R={r}, Tpad={woop.shape[2]}, NC={nc}, chunk={CHUNK}")
    check_cuda("dirs_soa", dirs_soa, torch.float32, (b, 3, rows, LANES), dev)
    check_cuda("tmax_tiles", tmax_tiles, torch.float32, (b, rows, LANES), dev)
    check_cuda("woop", woop, torch.float32, (b, 12, nc * CHUNK), dev)
    check_cuda("boxes", boxes, torch.float32, (b, 6, nc), dev)
    KERNEL.record(dirs_soa=dirs_soa, tmax_tiles=tmax_tiles, woop=woop, boxes=boxes, t_min=t_min,
                  any_hit=any_hit)
    out_t = torch.empty(b, rows, LANES, dtype=torch.float32, device=dev)
    out_p = torch.empty(b, rows, LANES, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(ptr(dirs_soa), ptr(tmax_tiles), ptr(woop), ptr(boxes), ptr(out_t),
                      ptr(out_p), tested_ptr(tested, tmax_tiles.shape, dev), b, r, nc,
                      float(t_min), stream_of(dev))
    return out_t, out_p


def intersect_mxu_shared(origin: Tensor, d: Tensor, vertices: Tensor, faces: Tensor,
                         t_min: float = 1e-4, t_max=1e30, any_hit: bool = False):
    """Shared-origin closest hit through X1; counterpart of the reference's
    `intersect_mxu_shared`.  One scene: origin (3,), d (N, 3), vertices
    (V, 3), t_max a float or (N,); or a batch with a leading variant axis:
    origin (B, 3), d (B, N, 3), vertices (B, V, 3), t_max a float or
    (B, N).  faces (F, 3).  Returns (t, prim int32), each (N,) or (B, N).
    Traversal is detached by construction."""
    one = origin.dim() == 1
    if one:
        origin, d, vertices = origin[None], d[None], vertices[None]
    woop, boxes = pack_triangles_woop(vertices.detach(), faces, origin.detach(), chunk=CHUNK)
    dirs_soa, tmax_tiles, n = pack_dirs(d.detach(), torch.as_tensor(t_max).detach())
    t, prim = intersect_mxu_packed(dirs_soa, tmax_tiles, woop, boxes, t_min, any_hit)
    t, prim = t.reshape(d.shape[0], -1)[:, :n], prim.reshape(d.shape[0], -1)[:, :n]
    return (t[0], prim[0]) if one else (t, prim)
