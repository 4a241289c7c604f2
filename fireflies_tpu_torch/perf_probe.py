"""Kernel-level timings and measured roofs of the port on one NVIDIA GPU.

    python -m fireflies_tpu_torch.perf_probe <probe or all> [out.json]

Counterpart of tools/perf_probe.py (`probe_hitfrac`, `probe_kernel`,
`probe_roofline`; its `probe_step` needs the projector-texture route, which
is not ported).  The probes are hitfrac, kernel, roofline, sass, votes,
launches and tc_sum.  Each measurement prints one JSON line; with `out.json` they are
also written there.  The card's name and power limit come first.

Timing: CUDA events around `n` calls after one warm-up call (`cuda_ms`),
the calls' mean.  A call is what a user pays for it: packing, tile lists
and kernel.  Every probe uses one variant of the vocalfold scene and
512x512 jittered camera rays; bounce rays start at the camera rays' hits
(the culled route's) with directions drawn uniformly on the sphere.

- hitfrac: share of camera rays that hit, and of 2048-ray tiles with a hit.
- kernel: every intersection kernel's call on the same rays at vocalfold
  resolutions 24, 75 and 160 (1440, 11538 and 51488 faces): B6
  (`resident`), B1 at 64 and 16 faces a cluster (`culled64`, `culled16`),
  B7s (`streamed`), B2 (`stream_culled`), B3 at 64, 32 and 128
  (`general_bounce[_cN]`), B5 (`general_culled64`), B7g
  (`general_streamed`) and B4 (`general_stream_culled`), and for the culled
  ones the tile-list build alone (`lists_ms`).  The reference runs B6 and
  the culled resident kernels only up to 20000 faces, which its SMEM
  holds; the port runs every kernel at every size.
- roofline: the measured roofs, then per-pass accounting.  The roofs: the
  rate of unfused FP32 operations (X2, `csrc/vpu_probe.cu`, 64
  rounds of a 12-operation product tree on 2048 x 1024 floats), the device
  memory rate (`x + 1.0` over 256 MiB), a 4M-row gather, and the kernel roof:
  B3 on a synthetic workload where nothing is skipped (4096 faces parallel
  to 262144 rays, every cluster's slab open to every ray), whose `tested`
  output must be every cluster for every ray.  Per pass, at resolutions 24
  and 75: the tests the tile lists enqueue (`listed_tests_per_ray`, all
  faces without lists), the tests the kernel reports it made
  (`tested_per_ray`), and the listed rate over the kernel roof
  (`x_kernel_roof_if_no_earlyout`; above 1 it measures what the slab vote
  and the running best skip).
- sass: what the compiler made of every kernel: registers and spills
  (the `-Xptxas -v` report of the build) and the instructions of its inner
  loop by class (`cuobjdump -sass` on the built library, whose listing is
  written beside it as `<library>.sass`), per tested face for the Woop and
  Moller-Trumbore kernels (for X1 per pair a thread filters, a pair marked
  by its width's compare with 1/4: its tensor-core products as `hmma`, its
  reciprocals as `mufu`; the out-of-line exact test is not in the loop).
- votes: the launches of `VOTE_LAUNCHES`, each the first of its kernel and
  mode in one forward batch of 16 variants at 512x512 (the bounce launches
  of B4, B7g, B3 and B5, the camera and first shadow launches of B1 on main
  and of B2 on reference, B1's camera launch on mid, the camera launches of
  B6 on main_unculled and B7s on reference_unculled): the fewest pairs a
  slab vote over each ray alone, each 32-ray warp and each 256-ray block
  would open, beside the pairs the kernel reports it tested, and the lanes
  tasks of 32 compacted entries would take.
- launches: every launch of every intersection kernel in one forward
  batch of the shape chip_smoke.py reports it on (16 variants, 512x512):
  its time, live rays, the pairs it tested and the pairs its inputs need
  (`least_pairs`), without the plain versions chip_smoke.py replays; then
  X1's four launches of chip_smoke.py's mxu phase (`mxu_scenes`,
  `mxu_drive`) with its bounds (`mxu_bounds`).  It reaches X1 only through
  `intersect_mxu_shared` and `intersect_mxu_packed`, so a copy of this file
  in an older checkout times that checkout's X1 on the same inputs.

- tc_sum: how the tensor cores add the eight products of a TF32 m16n8k8
  step (`csrc/tc_probe.cu`, the instruction X1 forms d' with), from
  designed products: whether the products are exact; for two cancelling
  products 4 and -4 and a third 2^(2-k) in every placement of the three
  slots, the largest k the sum keeps (the window below the larger
  operand); how 1 + 2^-24 + 2^-25 and its negation round; then the largest
  error of 20000 random sums in units of 2^-23 S (S the sum of the
  products' magnitudes) beside `intersect_mxu.TC_SUM_BOUND`, the bound X1's
  filter assumes.

`all` runs hitfrac, kernel and roofline.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter

import torch

from fireflies_tpu_torch import main_path
from fireflies_tpu_torch._build import Kernel, check_cuda, ptr, stream_of
from fireflies_tpu_torch.render.cuda import intersect_culled as ic
from fireflies_tpu_torch.render.cuda import intersect_general_culled as igc
from fireflies_tpu_torch.render.cuda import intersect_kernel as ik
from fireflies_tpu_torch.render.cuda import intersect_stream as ist
from fireflies_tpu_torch.render.intersect import closest_hit
from fireflies_tpu_torch.render.rays import camera_rays_tiled

Tensor = torch.Tensor

# X2: rounds of the product tree, its operations a round, the probed shape.
VPU_ROUNDS = 64
VPU_OPS_PER_ROUND = 12
VPU_SHAPE = (2048, 1024)
VPU_KERNEL = Kernel("ff_vpu_probe", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p])
TC_KERNEL = Kernel("ff_tc_probe", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p])

# Operations per tested (ray, triangle) pair, by kernel: the least the card
# must issue for the pair test of csrc/, counted from its source with every
# multiply whose product feeds only an add fused with that add (one FMA),
# and each other multiply, add, subtraction, negation, compare and the sign
# select one operation; the selects that keep the best hit, shared loads and
# slab tests not counted.
#   Shared-origin Woop (B1, B2, B6, B7s), 32: d' = W d 9 (a multiply and two
#   FMAs a row), the sign of d'_z 2 (compare, select), dn 1, tn = -o'_z sgn
#   2, u_n = o'_x dn + tn d'_x and v_n 4 (a multiply and an FMA each), the
#   products -eps dn, (1 + eps) dn, t_min dn, tmax dn, tn bdn, btn dn 6,
#   u_n + v_n 1, and 7 compares (dn > 1e-12, u_n, v_n, the sum, t_min, tmax,
#   the best hit).  Unfused: 40.
#   General Woop (B4, B7g), 41: the shared test plus o'_k = W_k . o - (W v0)_k,
#   three FMAs a row.  Unfused: 58.
#   Rational Moller-Trumbore (B3, B5), 48: P = d x e2 and Q = T x e1 6 each
#   (a multiply and an FMA a component), T = o - v0 3, det 3 and the dots
#   of un, vn, tn 3 each (a multiply and two FMAs), their sign products 3,
#   the sign 2, dn 1, eb 1 and -eb 1, dn + eb 1, un + vn 1, the products
#   t_min dn, tmax dn, tn bdn, btn dn 4, and 7 compares.  Unfused: 62.
#   X1 (intersect_mxu_shared), 15 on the FP32 pipe, its filter: t~ =
#   -o'_z (1 / d'_z) 1, the width e = D H |1 / d'_z| 2, u = o'_x + t~ d'_x
#   and v 2 (one FMA each), the widened bounds -1e-6 - e and 1 + 1e-6 + 2e
#   2, u + v 1, t~ (1 - e) 1, and 6 compares (u, v, the sum, t~ > 0, the
#   best hit, e against 1/4); absolute values and negations are
#   operand modifiers.  The reciprocal is one instruction of the
#   special-function unit (`MXU_SFU_PER_PAIR`), d' = W d runs on the tensor
#   cores (`MXU_MACS_PER_PAIR`), and the exact test of the few pairs the
#   filter passes on is not counted.  With d' on the FP32 pipe (9: a
#   multiply and two FMAs a row) the count was 22
#   (`MXU_OPS_PER_PAIR_FP32`), 30 unfused.
OPS_PER_PAIR = {"intersect_shared_culled": 32, "intersect_stream_culled": 32,
                "intersect_stream_general_culled": 41, "intersect_general": 48,
                "intersect_general_culled": 48, "intersect_shared": 32, "intersect_stream": 32,
                "intersect_stream_general": 41, "intersect_mxu_shared": 15}
MXU_OPS_PER_PAIR_FP32 = 22
MXU_SFU_PER_PAIR = 1
# X1's tensor-core work: three m16n8k8 TF32 products a 16-ray x 8-face tile
# (d'_x, d'_y, d'_z), 3 x 16 x 8 x 8 multiply-adds over 128 pairs.
MXU_MACS_PER_PAIR = 24
# X1's split, on the FP32 pipe: each W entry of a staged face (9) into hi
# and lo (cvt, subtract, cvt), once per block that stages the cluster; each
# ray's scale hi(d_x) / d_x, s d_y and s d_z, and the hi and lo of the
# scaled d_y and d_z, once per ray.
MXU_SPLIT_OPS_PER_FACE = 27
MXU_SPLIT_OPS_PER_RAY = 10
MXU_BLOCK_RAYS = 128  # rays a block of X1 (csrc/intersect_mxu.cu kThreads)
CHUNK_MXU = 128  # faces a cluster of X1 (kChunk)
# H100 SXM FP32 outside the tensor cores: 67e12 FLOP/s counts a fused
# multiply-add as two floating-point operations, so the card issues 33.5e12
# FP32 operations a second with an FMA as one operation, the unit of
# OPS_PER_PAIR and of X2's unfused count.
PEAK_FP32_OPS = 67e12 / 2
# H100 SXM dense TF32 on the tensor cores: 495e12 FLOP/s, a multiply-add two.
PEAK_TF32_MACS = 495e12 / 2
# Reciprocals on the special-function units: 16 results a clock an SM
# against 128 FP32 operations (CUDA C++ Programming Guide, throughput of
# the arithmetic instructions, compute capability 9.0), at the clock that
# gives PEAK_FP32_OPS.
PEAK_SFU_OPS = PEAK_FP32_OPS * 16 / 128
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def vpu_rounds_plain(x: Tensor) -> Tensor:
    """Plain PyTorch version of X2: 64 rounds of the product tree, each
    operation its own elementwise op in float32."""
    for _ in range(VPU_ROUNDS):
        t1 = x * 0.501 + 0.499
        t2 = x * 0.502 + 0.498
        t3 = x * 0.497 + 0.503
        t4 = x * 0.5 + 0.5
        x = (t1 * t2 + t3 * t4) * 0.5
    return x


def vpu_rounds(x: Tensor) -> Tensor:
    """X2, the FP32 throughput probe: CPU tensors take the plain version, CUDA
    tensors launch `csrc/vpu_probe.cu` (one thread per element) or raise.
    Returns a new tensor shaped like the contiguous float32 `x`."""
    if x.device.type == "cpu":
        return vpu_rounds_plain(x)
    check_cuda("x", x, torch.float32, tuple(x.shape), x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        VPU_KERNEL.launch(ptr(x), ptr(out), x.numel(), stream_of(x.device))
    return out


def vpu_ops(x: Tensor) -> float:
    """Float operations of one X2 call on `x`."""
    return float(x.numel()) * VPU_ROUNDS * VPU_OPS_PER_ROUND


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of `fn()` over `repeats` calls after one warm-up
    call, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def _emit(name: str, **kw) -> dict:
    """Print one measurement as a JSON line and return it."""
    record = {"probe": name, **kw}
    print(json.dumps(record), flush=True)
    return record


# ---------------------------------------------------------------------------
# Workloads and accounting (plain tensor code; the CPU tests run it)
# ---------------------------------------------------------------------------


def scene(resolution: int, device):
    """One randomized vocalfold variant (seed 0) at `resolution`."""
    bridge, randomize, beams = main_path.build(device, resolution=resolution)
    return main_path.scene_batch(bridge, randomize, beams, main_path.generators([0], device))


def probe_rays(rs, width: int, height: int):
    """(o, d, camera origin (B, 3), bounce origins p, bounce directions dr):
    jittered camera rays (seed 1) in tile-major order, and bounce rays from
    their hits (misses step 1 along the ray) in directions uniform on the
    sphere (seed 2)."""
    dev = rs.camera.to_world.device
    o, d, _ = camera_rays_tiled(rs.camera, width, height,
                                gens=main_path.generators([1], dev))
    cam = rs.camera.to_world[:, :3, 3]
    hit = closest_hit(o, d, rs.geometry, shared_origin=cam)
    p = o + d * torch.where(hit.valid, hit.t, 1.0)[..., None]
    dr = torch.randn(d.shape, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    return o, d, cam, p, dr / dr.norm(dim=-1, keepdim=True)


def listed_tests(rays_soa: Tensor, tmax_tiles: Tensor, boxes: Tensor, chunk: int) -> float:
    """Ray-triangle tests the tile lists enqueue: `chunk` faces x 2048 rays
    per listed (tile, cluster), shared-origin lists for (B, 3, ...)
    directions, general lists for (B, 6, ...) rays.  An upper bound of what
    a culled kernel tests (its slab vote and running best skip more)."""
    lists_fn = ic.tile_cluster_lists if rays_soa.shape[1] == 3 else ic.tile_cluster_lists_general
    _, counts = lists_fn(rays_soa, boxes, t_min=1e-4, tmax_tiles=tmax_tiles)
    return float(counts.sum()) * chunk * ik.RAY_TILE


def roof_workload(n_faces: int, n_rays: int, device, seed: int = 0):
    """The kernel roof's synthetic workload (tools/perf_probe.py): slivers
    parallel to the z axis packed in a 0.2 x 0.2 x 1 box on the -z axis,
    and rays from the origin within 1e-3 of -z.  Every cluster's box holds
    every ray's path and the slivers are nearly edge-on to the rays, so
    well under 1% of the rays hit one and every block's slab vote passes
    for every cluster: a B3 launch tests every (ray, face) pair.
    Returns (o, d (1, n_rays, 3), vertices (1, 3 n_faces, 3), faces)."""
    g = torch.Generator().manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64)

    c = uniform(-0.1, 0.1, n_faces, 3)
    c[:, 2] = uniform(-5.5, -4.5, n_faces)
    e2 = uniform(-0.01, 0.01, n_faces, 3)
    e2[:, 2] = 0.0
    verts = torch.cat([c, c + torch.tensor([0.0, 0.0, 0.02], dtype=torch.float64), c + e2])
    faces = torch.arange(3 * n_faces).reshape(3, n_faces).T.contiguous()
    d = torch.cat([uniform(-1e-3, 1e-3, n_rays, 2), -torch.ones(n_rays, 1, dtype=torch.float64)],
                  dim=1)
    d = d / d.norm(dim=-1, keepdim=True)
    as_dev = lambda a: a.to(device=device, dtype=torch.float32)[None]  # noqa: E731
    return as_dev(torch.zeros_like(d)), as_dev(d), as_dev(verts), faces.to(device)


# ---------------------------------------------------------------------------
# Probes
# ---------------------------------------------------------------------------


def probe_hitfrac(device, size: int = 512) -> list[dict]:
    out = []
    for resolution in (24, 160):
        rs = scene(resolution, device)
        o, d, _ = camera_rays_tiled(rs.camera, size, size,
                                    gens=main_path.generators([1], device))
        hit = closest_hit(o, d, rs.geometry, shared_origin=rs.camera.to_world[:, :3, 3]).valid
        tiles = hit.reshape(-1, ik.RAY_TILE)
        out.append(_emit(f"hitfrac_r{resolution}", hit_frac=float(hit.float().mean()),
                         tiles_active=float(tiles.any(dim=1).float().mean())))
    return out


def _kernel_variants(verts, faces, cam, d, p, dr):
    """(name, kernel, call, tile-list build or None) on one scene's rays."""
    dirs, tm, _ = ik.pack_dirs(d, 1e30)
    rays, tm_g, _ = ik.pack_rays(p, dr, 1e30)

    def shared_lists(boxes):
        return lambda: ic.tile_cluster_lists(dirs, boxes, t_min=1e-4, tmax_tiles=tm)

    def general_lists(boxes):
        return lambda: ic.tile_cluster_lists_general(rays, boxes, t_min=1e-4, tmax_tiles=tm_g)

    out = [
        ("resident", "B6", lambda: ik.intersect_cuda_shared(cam, d, verts, faces), None),
    ]
    for chunk in (64, 16):
        boxes = ik.pack_triangles_woop(verts, faces, cam, chunk=chunk)[1]
        out.append((f"culled{chunk}", "B1", lambda c=chunk: ic.intersect_cuda_shared_culled(
            cam, d, verts, faces, chunk=c), shared_lists(boxes)))
    out += [
        ("streamed", "B7s", lambda: ist.intersect_cuda_streamed(cam, d, verts, faces), None),
        ("stream_culled", "B2", lambda: ist.intersect_cuda_streamed_culled(cam, d, verts, faces),
         shared_lists(ist.pack_woop_streamed(verts, faces, cam)[1])),
    ]
    for chunk in (64, 32, 128):
        name = "general_bounce" + ("" if chunk == ik.CHUNK else f"_c{chunk}")
        out.append((name, "B3", lambda c=chunk: ik.intersect_cuda(p, dr, verts, faces, chunk=c),
                    None))
    out += [
        ("general_culled64", "B5", lambda: igc.intersect_cuda_general_culled(p, dr, verts, faces),
         general_lists(ik.pack_triangles(verts, faces, chunk=igc.CHUNK)[1])),
        ("general_streamed", "B7g",
         lambda: ist.intersect_cuda_streamed_general(p, dr, verts, faces), None),
        ("general_stream_culled", "B4",
         lambda: ist.intersect_cuda_streamed_general_culled(p, dr, verts, faces),
         general_lists(ist.pack_woop_streamed(verts, faces, None)[1])),
    ]
    return out


def probe_kernel(device, size: int = 512, n_iter: int = 10) -> list[dict]:
    out = []
    for resolution in (24, 75, 160):
        rs = scene(resolution, device)
        verts, faces = rs.geometry.vertices, rs.geometry.faces
        n_faces = int(faces.shape[0])
        _, d, cam, p, dr = probe_rays(rs, size, size)
        n_rays = d.shape[1]
        for name, kernel, call, lists in _kernel_variants(verts, faces, cam, d, p, dr):
            ms = cuda_ms(call, n_iter)
            extra = {}
            if lists is not None:
                extra["lists_ms"] = cuda_ms(lists, n_iter)
                extra["lists_share"] = extra["lists_ms"] / ms
            out.append(_emit(f"kernel_r{resolution}_{name}", kernel=kernel, faces=n_faces,
                             rays=n_rays, ms=ms, mray_s=n_rays / ms / 1e3, **extra))
    return out


def _tested(call, tmax_tiles: Tensor) -> float:
    """Clusters that `call(tested)` reports its blocks tested, summed over
    rays."""
    tested = torch.empty_like(tmax_tiles, dtype=torch.int32)
    call(tested)
    return float(tested.double().sum())


def vpu_input(device) -> Tensor:
    """X2's input: VPU_SHAPE floats uniform in [0, 1) (seed 0), where the
    rounds stay in [0, 1] (x = 1 is their fixed point; above it they
    diverge)."""
    g = torch.Generator().manual_seed(0)
    return torch.rand(VPU_SHAPE, generator=g).to(device)


def vpu_roof(device, n_iter: int = 20) -> dict:
    """X2's time, its plain version's, its bound and the measured rate of
    unfused FP32 operations; raises unless the two versions agree bit for
    bit."""
    x = vpu_input(device)
    ms = cuda_ms(lambda: vpu_rounds(x), n_iter)
    plain_ms = cuda_ms(lambda: vpu_rounds_plain(x), 2)
    if not torch.equal(vpu_rounds(x), vpu_rounds_plain(x)):
        raise AssertionError("X2 differs from its plain version")
    ops = vpu_ops(x)
    return _emit("roofline_vpu_roof", ms=ms, plain_ms=plain_ms, gops_s=ops / ms / 1e6,
                 of_peak=ops / ms * 1e3 / PEAK_FP32_OPS,
                 bound_ms=ops / PEAK_FP32_OPS * 1e3, ops=ops)


def hbm_roof(device, n_iter: int = 20) -> dict:
    """Device memory rate of `x + 1.0` over 256 MiB (read and write)."""
    n = 64 * 1024 * 1024
    y = torch.ones(n, device=device)
    ms = cuda_ms(lambda: y + 1.0, n_iter)
    return _emit("roofline_hbm_roof", gbytes_s=8.0 * n / ms / 1e6, ms=ms)


def gather_roof(device, n_iter: int = 5) -> dict:
    """Rows a second of a 4M-row, 32-byte-row gather whose next indices
    depend on the rows it read."""
    n_rows, width = 4 * 1024 * 1024, 8
    table = torch.arange(n_rows * width, dtype=torch.float32, device=device).reshape(n_rows, width)
    state = {"idx": torch.randint(0, n_rows, (n_rows,), device=device,
                                  generator=torch.Generator(device=device).manual_seed(0))}

    def gather_op():
        g = table[state["idx"]]
        state["idx"] = (state["idx"] + g[:, 0].long()) % n_rows

    ms = cuda_ms(gather_op, n_iter)
    return _emit("roofline_gather_roof", mrows_s=n_rows / ms / 1e3, ms=ms,
                 eff_gbytes_s=n_rows * width * 4 / ms / 1e6)


def kernel_roof(device, n_iter: int = 5) -> dict:
    """B3's rate of ray-triangle tests where nothing is skipped (see
    `roof_workload`: 4096 faces x 262144 rays); raises unless the kernel
    reports every cluster tested for every ray."""
    n_faces, n_rays = 4096, 256 * 1024
    o, d, verts, faces = roof_workload(n_faces, n_rays, device)
    tri, boxes = ik.pack_triangles(verts, faces)
    rays, tm, _ = ik.pack_rays(o, d, 1e30)
    ms = cuda_ms(lambda: ik.intersect_packed(rays, tm, tri, boxes, 1e-4), n_iter)
    tested = torch.empty_like(tm, dtype=torch.int32)
    ik.intersect_packed(rays, tm, tri, boxes, 1e-4, tested=tested)
    tested_pairs = float(tested.double().sum()) * ik.CHUNK
    tests = float(n_rays) * n_faces
    if tested_pairs != tests:
        raise AssertionError(f"kernel roof: {tested_pairs} pairs tested of {tests}")
    rate = tests / ms * 1e3
    return _emit("roofline_kernel_roof", kernel="B3", ms=ms, gtests_s=rate / 1e9,
                 tested_pairs=tested_pairs, listed_pairs=tests,
                 eff_gops_s=rate * OPS_PER_PAIR["intersect_general"] / 1e9,
                 bound_ms=tests * OPS_PER_PAIR["intersect_general"] / PEAK_FP32_OPS * 1e3)


def probe_roofline(device, size: int = 512, n_iter: int = 20) -> list[dict]:
    out = [vpu_roof(device, n_iter), hbm_roof(device, n_iter), gather_roof(device),
           kernel_roof(device)]
    roof = out[-1]["gtests_s"] * 1e9

    # --- per-pass accounting ----------------------------------------------
    for resolution in (24, 75):
        rs = scene(resolution, device)
        verts, faces = rs.geometry.vertices, rs.geometry.faces
        n_faces = int(faces.shape[0])
        _, d, cam, p, dr = probe_rays(rs, size, size)
        n_rays = d.shape[1]
        dirs, tm, _ = ik.pack_dirs(d, 1e30)
        rays, tm_g, _ = ik.pack_rays(p, dr, 1e30)
        passes = []
        woop, boxes = ik.pack_triangles_woop(verts, faces, cam, chunk=16)
        passes.append(("primary_culled16", listed_tests(dirs, tm, boxes, 16), 16,
                       lambda: ic.intersect_cuda_shared_culled(cam, d, verts, faces, chunk=16),
                       lambda t, w=woop, b=boxes: ic.intersect_culled_packed(
                           dirs, tm, w, b, 1e-4, chunk=16, tested=t)))
        woop, boxes = ik.pack_triangles_woop(verts, faces, cam)
        passes.append(("primary_unculled", float(tm.numel()) * woop.shape[2], ik.CHUNK,
                       lambda: ik.intersect_cuda_shared(cam, d, verts, faces),
                       lambda t, w=woop, b=boxes: ik.intersect_shared_packed(
                           dirs, tm, w, b, 1e-4, tested=t)))
        for tile_cull in (True, False):
            # The dispatcher's bounce route: B3 at 1440 faces either way;
            # B4 (culled) or B7g (unculled) at 11538.
            streamed = n_faces > 8192
            if streamed:
                table, boxes = ist.pack_woop_streamed(verts, faces, None)
                chunk = ist.STREAM_CHUNK
                packed = (ist.intersect_stream_general_culled_packed if tile_cull
                          else ist.intersect_stream_general_packed)
            else:
                table, boxes = ik.pack_triangles(verts, faces)
                chunk = ik.CHUNK
                packed = ik.intersect_packed
            listed = (listed_tests(rays, tm_g, boxes, chunk) if tile_cull and streamed
                      else float(tm_g.numel()) * table.shape[2])
            passes.append((f"bounce_general{'' if tile_cull else '_unculled'}", listed, chunk,
                           lambda tc=tile_cull: closest_hit(p, dr, rs.geometry, tile_cull=tc),
                           lambda t, f=packed, w=table, b=boxes: f(rays, tm_g, w, b, 1e-4,
                                                                   tested=t)))
        for pass_name, listed, chunk, call, counted in passes:
            ms = cuda_ms(call, n_iter)
            tested = _tested(counted, tm) * chunk
            out.append(_emit(f"roofline_r{resolution}_{pass_name}", faces=n_faces, ms=ms,
                             mray_s=n_rays / ms / 1e3, listed_tests_per_ray=listed / n_rays,
                             tested_per_ray=tested / n_rays,
                             x_kernel_roof_if_no_earlyout=listed / ms * 1e3 / roof))
    return out


# ---------------------------------------------------------------------------
# What the compiler made of the kernels (`sass`) and how wide a vote opens
# clusters (`votes`)
# ---------------------------------------------------------------------------

# SASS opcode (the text before its first '.') -> the class it is counted in;
# a predicated MOV counts as a select.
_SASS_CLASSES = {
    "FFMA": "ffma", "FMUL": "fmul", "FADD": "fadd", "FSETP": "fsetp", "FSEL": "select",
    "SEL": "select", "FMNMX": "fminmax", "PLOP3": "plop3", "LDS": "lds", "LDG": "ldg",
    "LDGSTS": "ldg", "LDC": "ldc", "ULDC": "ldc", "MOV": "mov", "HMMA": "hmma", "MUFU": "mufu",
    **dict.fromkeys(("IADD3", "IMAD", "LOP3", "ISETP", "SHF", "LEA", "IABS", "IMNMX", "SGXT",
                     "PRMT", "POPC", "FLO", "VIADD", "VIMNMX", "UIADD3", "UIMAD", "ULOP3",
                     "USHF", "ULEA", "UISETP", "UMOV", "S2R", "S2UR", "CS2R"), "integer"),
    **dict.fromkeys(("BRA", "BAR", "BSSY", "BSYNC", "WARPSYNC", "VOTE", "VOTEU", "EXIT", "NOP",
                     "DEPBAR", "LDGDEPBAR", "YIELD"), "control"),
}
_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_LABEL = re.compile(r"^\s*\.(L_x_\d+):")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
# One compare per tested face, with an immediate as SASS prints it (decimal
# or its bits): float32(1e-12), the floor of |d'_z| in every Woop pair test,
# or float32(1e-9), the floor of |det| (kEpsDet) in every Moller-Trumbore one.
_PAIR_MARK = re.compile(r"9\.99999996004197\d*e-13|0x2b8cbccc|9\.999999717180\d*e-10|0x3089705f",
                        re.IGNORECASE)
# X1's filter compares each pair's width with 1/4 (kWide); its 1e-12 compare
# is in the out-of-line exact test.
_X1_MARK = re.compile(r"(?<![\d.])0\.25(?![\d])")


def sass_functions(text: str) -> dict[str, list[tuple]]:
    """`cuobjdump -sass` output -> {mangled name: [(address, predicate,
    opcode, operands, branch target address or None)]}."""
    funcs = {}
    parts = _SASS_FUNCTION.split(text)
    for name, body in zip(parts[1::2], parts[2::2]):
        labels, pending, ins = {}, [], []
        for line in body.splitlines():
            m = _SASS_LABEL.match(line)
            if m:
                pending.append(m.group(1))
                continue
            m = _SASS_LINE.search(line)
            if m:
                addr = int(m.group(1), 16)
                labels.update(dict.fromkeys(pending, addr))
                pending = []
                ins.append((addr, (m.group(2) or "").strip(), m.group(3), m.group(4).strip()))
        resolved = []
        for addr, pred, op, args in ins:
            target = None
            if op.split(".")[0] == "BRA":
                m = re.search(r"\(\.(L_x_\d+)\)", args)
                hexa = re.search(r"\b0x([0-9a-f]+)\b", args)
                target = labels.get(m.group(1)) if m else int(hexa.group(1), 16) if hexa else None
            resolved.append((addr, pred, op, args, target))
        funcs[name] = resolved
    return funcs


def sass_class(pred: str, op: str) -> str:
    base = op.split(".")[0]
    if base == "MOV" and pred:
        return "select"
    return _SASS_CLASSES.get(base, "other")


def _is_lds128(op: str) -> bool:
    return op.startswith("LDS") and ".128" in op


def _pair_marks(body: list[tuple], mark: re.Pattern = _PAIR_MARK) -> int:
    return sum(1 for _, _, op, args, _ in body
               if op.startswith("FSETP") and mark.search(args))


def inner_loop_counts(ins: list[tuple], mark: re.Pattern = _PAIR_MARK) -> dict:
    """Instructions of a function's innermost loop over pair tests (of the
    back edges, branches to an address at or before their own, the
    shortest span that holds a pair test's compare, `_PAIR_MARK`, whatever
    the width of its shared loads; where no loop holds one, the shortest
    span with a 16-byte shared load), counted by class, and per tested face
    where the loop holds pair tests (`faces`, its marked compares).  Empty
    when no such loop exists."""
    spans = [[x for x in ins if target <= x[0] <= addr] for addr, *_, target in ins
             if target is not None and target <= addr]
    spans = ([body for body in spans if _pair_marks(body, mark)]
             or [body for body in spans if any(_is_lds128(x[2]) for x in body)])
    if not spans:
        return {}
    best = min(spans, key=len)
    classes = dict(Counter(sass_class(pred, op) for _, pred, op, _, _ in best))
    faces = _pair_marks(best, mark)
    out = {"loop_instructions": len(best), "loop_faces": faces,
           "loop_lds128": sum(1 for x in best if _is_lds128(x[2])), "loop_classes": classes}
    if faces:
        out["per_face"] = {c: n / faces for c, n in classes.items()}
        out["per_face_total"] = len(best) / faces
    return out


def ptxas_resources(log: str) -> dict[str, dict]:
    """The `-Xptxas -v` report -> {mangled name: registers, spill bytes}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            cur.update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def probe_sass(device) -> list[dict]:
    """Registers and spills of every kernel (`-Xptxas -v`) and the
    instruction classes of its inner loop (`cuobjdump -sass` on the built
    library; the whole listing is written beside it as `<library>.sass`)."""
    del device  # the library is built for the card; nothing runs on it
    from fireflies_tpu_torch import _build  # noqa: PLC0415
    from fireflies_tpu_torch.profile_main import KERNEL_NAMES  # noqa: PLC0415

    _build.load_library()
    so = _build.library_path()
    resources = ptxas_resources(so.with_suffix(".log").read_text())
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True,
                          timeout=600).stdout
    so.with_suffix(".sass").write_text(text)
    out = []
    for name, ins in sorted(sass_functions(text).items()):
        label = next((k for k, keys in KERNEL_NAMES.items() if any(x in name for x in keys)), name)
        # A kernel built for several cluster sizes: its last int template argument.
        chunk = re.findall(r"Li(\d+)E", name)
        suffix = f"_c{chunk[-1]}" if chunk else ""
        out.append(_emit(f"sass_{label.split()[0]}{suffix}", function=name, kernel=label,
                         instructions=len(ins), **resources.get(name, {}),
                         **inner_loop_counts(ins, _X1_MARK if label.startswith("X1") else _PAIR_MARK)))
    return out


def slab_open(o: Tensor, d: Tensor, box: Tensor, t_min: float, tfar_ray: Tensor) -> Tensor:
    """(rays, NC) bool: the kernels' slab test of each ray (o, d (N, 3))
    against each cluster box (6, NC) in float32, as csrc/ forms it (without
    the general streamed kernels' 1e-5 box padding), with tfar capped at
    `tfar_ray` (N,)."""
    tiny = d.abs() < 1e-30
    inv = torch.where(tiny, torch.where(d < 0, -1e30, 1e30), 1.0 / torch.where(tiny, 1.0, d))
    t0 = (box[:3].T[None] - o[:, None]) * inv[:, None]
    t1 = (box[3:].T[None] - o[:, None]) * inv[:, None]
    tnear = torch.minimum(t0, t1).amax(-1).clamp(min=t_min)
    tfar = torch.minimum(torch.maximum(t0, t1).amin(-1), tfar_ray[:, None])
    return tnear <= tfar


def vote_widths(rec: dict, t: Tensor, prim: Tensor, widths=(1, 32, 256),
                ray_chunk: int = 65536, batch: int = 1) -> dict:
    """Clusters a launch would test, summed over its live rays, if a vote
    over each group of `widths` consecutive rays (1: each ray alone, 32: a
    warp, 256: a block) opened a cluster for the group: a listed cluster (a
    tile list's, or every cluster without lists) opens when the slab test of
    some ray of the group passes with tfar capped at min(tmax, the ray's
    final t).  The running best never falls below the final t, so these are
    the fewest clusters each width could open.  Under the key "lanes", the
    lanes that tasks of 32 listed (ray, cluster) entries take at width 1
    (B3, B4, B5 and B7g): per 256-ray block and `batch` clusters staged at
    once (consecutive on the tile's list, or in index order without lists;
    B4 and B7g stage one), the opening pairs rounded up to a multiple of 32.  `rec` holds a streamed or resident
    launch's packed inputs (`Kernel.record`), `t` and `prim` its outputs."""
    rays_soa = rec["rays_soa"] if "rays_soa" in rec else rec["dirs_soa"]
    tmax_tiles, boxes = rec["tmax_tiles"], rec["boxes"]
    b, n_comp = rays_soa.shape[:2]
    r = tmax_tiles[0].numel()
    rays = rays_soa.reshape(b, n_comp, r)
    tmax = tmax_tiles.reshape(b, r)
    nc = boxes.shape[2]
    if "lists" in rec:
        listed = ic.listed_mask(rec["lists"], rec["counts"])
    else:
        listed = torch.ones(b, r // ik.RAY_TILE, nc, dtype=torch.bool, device=tmax.device)
    tfar_ray = torch.where(prim.reshape(b, r) >= 0, torch.minimum(tmax, t.reshape(b, r)), tmax)
    totals = dict.fromkeys((*widths, "lanes"), 0.0)
    for bi in range(b):
        for s in range(0, r, ray_chunk):
            d = rays[bi, n_comp - 3:, s:s + ray_chunk].T
            o = rays[bi, :3, s:s + ray_chunk].T if n_comp == 6 else torch.zeros_like(d)
            opened = slab_open(o, d, boxes[bi], rec["t_min"], tfar_ray[bi, s:s + ray_chunk])
            n = d.shape[0]
            opened &= listed[bi][torch.arange(s, s + n, device=d.device) // ik.RAY_TILE]
            live = tmax[bi, s:s + n] >= 0
            for w in widths:
                groups = opened.reshape(n // w, w, nc).any(dim=1).sum(dim=1)
                totals[w] += float((groups * live.reshape(n // w, w).sum(dim=1)).double().sum())
            per_block = (opened & live[:, None]).reshape(n // 256, 256, nc).sum(dim=1)
            if "lists" in rec and batch > 1:  # a batch holds consecutive listed clusters
                tiles = torch.arange(s, s + n, 256, device=d.device) // ik.RAY_TILE
                per_block = per_block.gather(1, rec["lists"][bi][tiles].long())
            pad = -nc % batch
            per_batch = torch.nn.functional.pad(per_block, (0, pad)).reshape(
                n // 256, -1, batch).sum(dim=2)
            totals["lanes"] += float(((per_batch + 31) // 32 * 32).double().sum())
    return totals


def faces_per_cluster(rec: dict) -> int:
    """Faces a cluster of a recorded launch's triangle table holds."""
    table = rec.get("woop16", rec.get("woop", rec.get("tri")))
    return table.shape[2] // rec["boxes"].shape[2]


def least_pairs(rec: dict, t: Tensor, prim: Tensor) -> float:
    """The pairs a launch needs whatever implements it: each live ray
    against the faces of every listed cluster its own slab test opens, with
    tfar capped at its final t (`vote_widths` at width 1)."""
    return vote_widths(rec, t, prim, widths=(1,))[1] * faces_per_cluster(rec)


def mxu_bounds(rec: dict, pairs: float, least: float, nbytes: float, tested: Tensor) -> dict:
    """X1's bounds for one launch with recorded inputs `rec`, `pairs` tested
    and `least` needed pairs, `nbytes` moved and the kernel's `tested`
    counts: each the largest of the FP32 pipe's operations (OPS_PER_PAIR
    and the split: a face's once per block that stages its cluster, at
    least the clusters of the block's busiest warp, or once per variant for
    the least, and a live ray's once), the special-function units'
    reciprocals, the tensor cores' multiply-adds and, for the tested pairs,
    the bytes; beside them, as `*_fp32_dp`, the bounds with d' on the FP32
    pipe (MXU_OPS_PER_PAIR_FP32, the count before d' ran on the tensor cores)."""
    name = "intersect_mxu_shared"
    tmax = rec["tmax_tiles"]
    b = tmax.shape[0]
    live = tmax.reshape(b, -1) >= 0
    staged = float(tested.reshape(b, -1, MXU_BLOCK_RAYS).amax(-1).double().sum()) * CHUNK_MXU
    faces = rec["woop"].shape[2]
    rays_ops = float(live.sum()) * MXU_SPLIT_OPS_PER_RAY

    def pipes(n_pairs: float, staged_faces: float) -> dict:
        fp32 = n_pairs * OPS_PER_PAIR[name] + staged_faces * MXU_SPLIT_OPS_PER_FACE + rays_ops
        return {"fp32": fp32 / PEAK_FP32_OPS * 1e3,
                "sfu": n_pairs * MXU_SFU_PER_PAIR / PEAK_SFU_OPS * 1e3,
                "tensor": n_pairs * MXU_MACS_PER_PAIR / PEAK_TF32_MACS * 1e3}

    mem_ms = nbytes / PEAK_BYTES * 1e3
    ms = pipes(pairs, staged)
    least_ms = pipes(least, b * faces)
    pipe = max(ms, key=ms.get)
    old = MXU_OPS_PER_PAIR_FP32 / PEAK_FP32_OPS * 1e3
    bound = max(mem_ms, ms[pipe])
    return {"bound_ms": bound, "bound_by": "bytes" if bound == mem_ms else "operations",
            "bound_pipe": pipe, "fp32_ms": ms["fp32"], "sfu_ms": ms["sfu"],
            "tensor_ms": ms["tensor"], "bytes_ms": mem_ms,
            "least_bound_ms": max(least_ms.values()),
            "bound_ms_fp32_dp": max(mem_ms, pairs * old), "least_bound_ms_fp32_dp": least * old}


# The shapes whose camera rays X1 is driven on (chip_smoke.py's mxu phase).
MXU_SHAPES = ("main", "reference")


def mxu_scenes(device, size: int = 512, batch: int = 16) -> list[tuple]:
    """X1's inputs: for each shape of MXU_SHAPES, `batch` randomized
    variants (seeds 0 ..) and their jittered camera rays at size x size, as
    the paths cast them: (shape, camera origins (B, 3), d (B, N, 3),
    vertices, faces)."""
    seeds = list(range(batch))
    out = []
    for tag in MXU_SHAPES:
        bridge, randomize, beams = main_path.build(device, resolution=main_path.SHAPES[tag][0])
        rs = main_path.scene_batch(bridge, randomize, beams, main_path.generators(seeds, device))
        _, d, _ = camera_rays_tiled(rs.camera, size, size,
                                    gens=main_path.generators(seeds, device))
        out.append((tag, rs.camera.to_world[:, :3, 3].contiguous(), d, rs.geometry.vertices,
                    rs.geometry.faces))
    return out


def mxu_drive(scenes: list[tuple]) -> tuple[list[tuple], list[dict]]:
    """X1 through its entry point on each scene of `mxu_scenes`, once with
    t_max = 1e30 and once with a per-ray t_max of each variant's median hit
    distance times 0.9-1.1 (seed 3): per scene (shape, faces, t, prim, the
    per-ray t_max, its (t, prim)), and the launches' inputs
    (`Kernel.recorded`), two a scene."""
    from fireflies_tpu_torch.experiments import intersect_mxu as mx  # noqa: PLC0415

    mx.KERNEL.recorded = []
    outs = []
    with torch.no_grad():
        for tag, cam, d, verts, faces in scenes:
            t, prim = mx.intersect_mxu_shared(cam, d, verts, faces)
            u = torch.rand(d.shape[:2], device=d.device,
                           generator=torch.Generator(device=d.device).manual_seed(3))
            median = torch.where(prim >= 0, t, torch.nan).nanmedian(dim=1, keepdim=True).values
            t_max = median * (0.9 + 0.2 * u)
            outs.append((tag, faces.shape[0], t, prim, t_max,
                         mx.intersect_mxu_shared(cam, d, verts, faces, t_max=t_max)))
    recorded, mx.KERNEL.recorded = mx.KERNEL.recorded, None
    return outs, recorded


# Faces B3 and B5 stage at once (kBatchFaces of csrc/intersect_general.cuh):
# their tasks' lanes are counted over such batches.
RESIDENT_BATCH_FACES = 256
STAGED_KERNELS = ("intersect_general", "intersect_general_culled")
# The launches `votes` reads: (shape, kernel name, mode), each the first
# launch of that kernel and mode in one forward batch of the shape.
VOTE_LAUNCHES = (
    ("reference", "intersect_stream_general_culled", "closest"),  # B4, bounce
    ("reference", "intersect_stream_culled", "closest"),  # B2, camera
    ("reference", "intersect_stream_culled", "any"),  # B2, first shadow
    ("reference_unculled", "intersect_stream_general", "closest"),  # B7g, bounce
    ("reference_unculled", "intersect_stream", "closest"),  # B7s, camera
    ("main", "intersect_general", "closest"),  # B3, bounce
    ("main", "intersect_shared_culled", "closest"),  # B1, camera
    ("main", "intersect_shared_culled", "any"),  # B1, first shadow
    ("mid", "intersect_shared_culled", "closest"),  # B1, camera at 5288 faces
    ("mid", "intersect_general_culled", "closest"),  # B5, bounce
    ("main_unculled", "intersect_shared", "closest"),  # B6, camera
)
# Each intersection kernel's wrapper on packed inputs, by kernel name.
PACKED = {"intersect_shared_culled": ic.intersect_culled_packed,
          "intersect_general": ik.intersect_packed,
          "intersect_stream_culled": ist.intersect_stream_culled_packed,
          "intersect_stream_general_culled": ist.intersect_stream_general_culled_packed,
          "intersect_general_culled": igc.intersect_general_culled_packed,
          "intersect_shared": ik.intersect_shared_packed,
          "intersect_stream": ist.intersect_stream_packed,
          "intersect_stream_general": ist.intersect_stream_general_packed}


def _record_launches(shape: str, device, size: int, batch: int) -> dict[str, list[dict]]:
    """The inputs of every kernel launch in one forward batch of `shape`
    (`Kernel.record`), by kernel name."""
    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415

    bridge, randomize, beams, cfg = main_path.build_shape(shape, device, size)
    for kernel in KERNELS.values():
        kernel.recorded = []
    with torch.no_grad():
        main_path.render_batch(bridge, randomize, beams, list(range(batch)), cfg)
    out = {}
    for name, kernel in KERNELS.items():
        out[name], kernel.recorded = kernel.recorded, None
    return out


def probe_votes(device, size: int = 512, batch: int = 16) -> list[dict]:
    """The launches of `VOTE_LAUNCHES`, recorded from one forward batch of
    each shape: the pairs a vote over 1, 32 and 256 rays would open at least
    (`vote_widths`), beside the pairs the kernel reports it tested."""
    out, recorded = [], {}
    for shape, name, mode in VOTE_LAUNCHES:
        if shape not in recorded:
            recorded = {shape: _record_launches(shape, device, size, batch)}
        rec = next(x for x in recorded[shape][name] if x["any_hit"] == (mode == "any"))
        tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
        t, prim = PACKED[name](**rec, tested=tested)[:2]
        faces = faces_per_cluster(rec)
        staged = RESIDENT_BATCH_FACES // faces if name in STAGED_KERNELS else 1
        pairs = {w: n * faces for w, n in vote_widths(rec, t, prim, batch=staged).items()}
        live = int((rec["tmax_tiles"] >= 0).sum())
        out.append(_emit(f"votes_{shape}_{name}_{mode}", kernel=name, live_rays=live,
                         clusters=rec["boxes"].shape[2], faces_per_cluster=faces,
                         ray_pairs=pairs[1], warp_pairs=pairs[32], block_pairs=pairs[256],
                         kernel_tested_pairs=float(tested.double().sum()) * faces,
                         warp_over_block=pairs[32] / pairs[256],
                         ray_over_block=pairs[1] / pairs[256],
                         task_lane_pairs=pairs["lanes"], lane_use=pairs[1] / pairs["lanes"]))
    return out


def probe_launches(device, size: int = 512, batch: int = 16) -> list[dict]:
    """Every launch of every intersection kernel in one forward batch of the
    first shape of `main_path.SHAPES` that runs it (the path chip_smoke.py
    reports it on), without the plain versions: its time, and the pairs it
    tested beside the pairs its inputs need (`least_pairs`); then X1's
    launches on the mxu phase's inputs (`_mxu_launches`)."""
    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415

    out, seen = [], set()
    for shape in main_path.SHAPES:
        recorded = _record_launches(shape, device, size, batch)
        for name in KERNELS:
            if name in seen or not recorded[name]:
                continue
            seen.add(name)
            fn = PACKED[name]
            for i, rec in enumerate(recorded[name]):
                ms = cuda_ms(lambda fn=fn, rec=rec: fn(**rec), 20)
                tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
                t, prim = fn(**rec, tested=tested)[:2]
                pairs = float(tested.double().sum()) * faces_per_cluster(rec)
                least = least_pairs(rec, t, prim)
                ops = OPS_PER_PAIR[name] / PEAK_FP32_OPS * 1e3
                mode = "any" if rec["any_hit"] else "closest"
                out.append(_emit(f"launch_{shape}_{name}_{mode}#{i}", kernel=name, ms=ms,
                                 live_rays=int((rec["tmax_tiles"] >= 0).sum()),
                                 tested_pairs=pairs, least_pairs=least, bound_ms=pairs * ops,
                                 least_bound_ms=least * ops))
        del recorded
    out += _mxu_launches(device, size, batch)
    return out


def _mxu_launches(device, size: int, batch: int) -> list[dict]:
    """X1's launches on the inputs of chip_smoke.py's mxu phase
    (`mxu_scenes`, `mxu_drive`): time, tested and least pairs, bounds."""
    from fireflies_tpu_torch.experiments import intersect_mxu as mx  # noqa: PLC0415

    _, recorded = mxu_drive(mxu_scenes(device, size, batch))
    out = []
    for i, rec in enumerate(recorded):
        shape, cut = MXU_SHAPES[i // 2], ("1e30", "per_ray")[i % 2]
        ms = cuda_ms(lambda rec=rec: mx.intersect_mxu_packed(**rec), 20)
        tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
        t, prim = mx.intersect_mxu_packed(**rec, tested=tested)
        pairs = float(tested.double().sum()) * faces_per_cluster(rec)
        least = least_pairs(rec, t, prim)
        nbytes = sum(x.numel() * x.element_size() for x in rec.values()
                     if isinstance(x, Tensor)) + 2 * t.numel() * 4
        out.append(_emit(f"launch_mxu_{shape}_{cut}", kernel="intersect_mxu_shared", ms=ms,
                         live_rays=int((rec["tmax_tiles"] >= 0).sum()), tested_pairs=pairs,
                         least_pairs=least, **mxu_bounds(rec, pairs, least, nbytes, tested)))
    return out


def tc_sums(products: Tensor, device) -> Tensor:
    """Each row of `products` (n, 8, 2) float64 [slot][a, b], TF32 values,
    as one k8 step of the tensor cores (`csrc/tc_probe.cu`): the float32
    sum of a_k b_k over the eight slots, (n,) float64."""
    n = products.shape[0]
    a = torch.zeros(n, 16, 8, dtype=torch.float32)
    b = torch.zeros(n, 8, 8, dtype=torch.float32)
    a[:, 0, :] = products[:, :, 0].float()
    b[:, :, 0] = products[:, :, 1].float()
    if not (torch.equal(a[:, 0, :].double(), products[:, :, 0])
            and torch.equal(b[:, :, 0].double(), products[:, :, 1])):
        raise ValueError("tc_sums: products must be float32 values")
    a, b = a.to(device), b.to(device)
    d = torch.empty(n, 16, 8, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        TC_KERNEL.launch(ptr(a), ptr(b), ptr(d), n, stream_of(device))
    return d[:, 0, 0].double().cpu()


def _placed(*terms) -> Tensor:
    """One k8 step from (slot, a, b) terms, other slots zero."""
    row = torch.zeros(8, 2, dtype=torch.float64)
    for slot, x, y in terms:
        row[slot] = torch.tensor([x, y], dtype=torch.float64)
    return row


def tc_random(n: int, seed: int = 1) -> Tensor:
    """`n` random k8 steps: eight products of TF32 values (11-bit
    significands, exponents -12 to 0, random signs), (n, 8, 2) float64."""
    g = torch.Generator().manual_seed(seed)

    def tf32_values():
        sig = (1024 + torch.randint(0, 1024, (n, 8), generator=g)).double() / 1024
        return sig * 2.0 ** torch.randint(-12, 1, (n, 8), generator=g).double()

    sign = torch.where(torch.rand(n, 8, generator=g) < 0.5, -1.0, 1.0).double()
    return torch.stack([tf32_values() * sign, tf32_values()], -1)


def probe_tc_sum(device) -> list[dict]:
    from fireflies_tpu_torch.experiments import intersect_mxu as mx  # noqa: PLC0415

    rows = tc_random(2000, seed=0)
    one = torch.zeros_like(rows)
    pick = torch.arange(2000) % 8
    one[torch.arange(2000), pick] = rows[torch.arange(2000), pick]
    exact = bool(torch.equal(tc_sums(one, device), (one[..., 0] * one[..., 1]).sum(1)))
    # the window: 4 - 4 + 2^(2-k) in each ordered placement of the three slots
    places = [(i, j, m) for i in range(8) for j in range(8) for m in range(8)
              if len({i, j, m}) == 3]
    ks = list(range(20, 70))
    steps = torch.stack([_placed((i, 4.0, 1.0), (j, 4.0, -1.0), (m, 2.0 ** (2 - k), 1.0))
                         for i, j, m in places for k in ks])
    kept = (tc_sums(steps, device) == (steps[..., 0] * steps[..., 1]).sum(1)).reshape(
        len(places), len(ks))
    window = [max([k for k, ok in zip(ks, row.tolist()) if ok] or [0]) for row in kept]
    rounding = tc_sums(torch.stack([
        _placed((0, 1.0, 1.0), (1, 2.0**-24, 1.0), (2, 2.0**-25, 1.0)),
        _placed((0, 1.0, -1.0), (1, 2.0**-24, -1.0), (2, 2.0**-25, -1.0))]), device)
    rnd = tc_random(20000)
    prods = rnd[..., 0] * rnd[..., 1]
    err = (tc_sums(rnd, device) - prods.sum(1)).abs() / prods.abs().sum(1)
    return [_emit("tc_sum", products_exact=exact,
                  window_bits_min=min(window), window_bits_max=max(window),
                  placements_kept_past_25=sum(w > 25 for w in window),
                  placements=len(places),
                  one_plus_0p75_ulp=float(rounding[0]), minus_one_plus_0p75_ulp=float(rounding[1]),
                  random_max_err_units_2m23_s=float(err.max()) / 2.0**-23,
                  tc_sum_bound_units_2m23_s=mx.TC_SUM_BOUND / 2.0**-23)]


PROBES = {"hitfrac": probe_hitfrac, "kernel": probe_kernel, "roofline": probe_roofline,
          "sass": probe_sass, "votes": probe_votes, "launches": probe_launches,
          "tc_sum": probe_tc_sum}


def main() -> None:
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    out = sys.argv[2] if len(sys.argv) > 2 else None
    if what not in (*PROBES, "all"):
        raise SystemExit(__doc__.splitlines()[2].strip())
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"# {nvidia_smi()} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t_all = time.perf_counter()
    records = []
    for name, probe in PROBES.items():
        if what == name or (what == "all" and name in ("hitfrac", "kernel", "roofline")):
            records += probe(dev)
    print(f"# total {time.perf_counter() - t_all:.1f} s", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump({r["probe"]: r for r in records}, f, indent=1)


if __name__ == "__main__":
    main()
