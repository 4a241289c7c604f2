"""Kernel-level timings and measured roofs of the port on one NVIDIA GPU.

    python -m fireflies_tpu_torch.perf_probe <probe or all> [out.json]

Counterpart of tools/perf_probe.py (`probe_hitfrac`, `probe_kernel`,
`probe_roofline`; its `probe_step` needs the projector-texture route, which
is not ported).  The probes are hitfrac, kernel, roofline, sass and
votes.  Each measurement prints one JSON line; with `out.json` they are
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
  written beside it as `<library>.sass`), per tested face for the Woop
  kernels.
- votes: the bounce launch of the reference shape (B4) and of
  reference_unculled (B7g), recorded from one forward batch of 16 variants
  at 512x512: the fewest pairs a slab vote over each ray alone, each 32-ray
  warp and each 256-ray block would open, beside the pairs the kernel
  reports it tested.

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
#   X1 (intersect_mxu_shared), 22: d' = W d 9, |d'_z| and its compare 2,
#   the reciprocal 1, t = -o'_z (1 / d'_z) 2, u = o'_x + t d'_x and v 2
#   (one FMA each), u + v 1 and 5 compares.  Unfused: 30.
OPS_PER_PAIR = {"intersect_shared_culled": 32, "intersect_stream_culled": 32,
                "intersect_stream_general_culled": 41, "intersect_general": 48,
                "intersect_general_culled": 48, "intersect_shared": 32, "intersect_stream": 32,
                "intersect_stream_general": 41, "intersect_mxu_shared": 22}
# H100 SXM FP32 outside the tensor cores: 67e12 FLOP/s counts a fused
# multiply-add as two floating-point operations, so the card issues 33.5e12
# FP32 operations a second with an FMA as one operation, the unit of
# OPS_PER_PAIR and of X2's unfused count.
PEAK_FP32_OPS = 67e12 / 2
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
    "LDGSTS": "ldg", "LDC": "ldc", "ULDC": "ldc", "MOV": "mov",
    **dict.fromkeys(("IADD3", "IMAD", "LOP3", "ISETP", "SHF", "LEA", "IABS", "IMNMX", "SGXT",
                     "PRMT", "POPC", "FLO", "VIADD", "VIMNMX", "UIADD3", "UIMAD", "ULOP3",
                     "USHF", "ULEA", "UISETP", "UMOV", "S2R", "S2UR", "CS2R"), "integer"),
    **dict.fromkeys(("BRA", "BAR", "BSSY", "BSYNC", "WARPSYNC", "VOTE", "VOTEU", "EXIT", "NOP",
                     "DEPBAR", "LDGDEPBAR", "YIELD"), "control"),
}
_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_LABEL = re.compile(r"^\s*\.(L_x_\d+):")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
# float32(1e-12), the floor of |d'_z| that every Woop pair test compares
# with, as SASS prints the immediate (decimal or its bits): one such compare
# per tested face.
_PAIR_MARK = re.compile(r"9\.99999996004197\d*e-13|0x2b8cbccc", re.IGNORECASE)


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


def inner_loop_counts(ins: list[tuple]) -> dict:
    """Instructions of a function's innermost loop that holds 16-byte shared
    loads (of the back edges, branches to an address at or before their
    own, the shortest span with an LDS.128), counted by class, and per
    tested face where the loop holds Woop pair tests (`faces`, its compares
    against float32(1e-12)).  Empty when no such loop exists."""
    spans = [[x for x in ins if target <= x[0] <= addr] for addr, *_, target in ins
             if target is not None and target <= addr]
    spans = [body for body in spans if any(_is_lds128(x[2]) for x in body)]
    if not spans:
        return {}
    best = min(spans, key=len)
    classes = dict(Counter(sass_class(pred, op) for _, pred, op, _, _ in best))
    faces = sum(1 for _, _, op, args, _ in best
                if op.startswith("FSETP") and _PAIR_MARK.search(args))
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
        out.append(_emit(f"sass_{label.split()[0]}", function=name, kernel=label,
                         instructions=len(ins), **resources.get(name, {}),
                         **inner_loop_counts(ins)))
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
                ray_chunk: int = 65536) -> dict[int, float]:
    """Clusters a launch would test, summed over its live rays, if a vote
    over each group of `widths` consecutive rays (1: each ray alone, 32: a
    warp, 256: a block) opened a cluster for the group: a listed cluster (a
    tile list's, or every cluster without lists) opens when the slab test of
    some ray of the group passes with tfar capped at min(tmax, the ray's
    final t).  The running best never falls below the final t, so these are
    the fewest clusters each width could open.  `rec` holds a streamed or
    resident launch's packed inputs (`Kernel.record`), `t` and `prim` its
    outputs."""
    rays_soa, tmax_tiles, boxes = rec["rays_soa"], rec["tmax_tiles"], rec["boxes"]
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
    totals = dict.fromkeys(widths, 0.0)
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
    return totals


# The general streamed kernels' bounce launches: (shape, kernel name, wrapper).
_BOUNCE = (("reference", "intersect_stream_general_culled",
            ist.intersect_stream_general_culled_packed),
           ("reference_unculled", "intersect_stream_general",
            ist.intersect_stream_general_packed))


def _bounce_launch(shape: str, name: str, device, size: int, batch: int) -> dict:
    """The inputs of kernel `name`'s first closest-hit launch in one forward
    batch of `shape` (`Kernel.record`)."""
    from fireflies_tpu_torch.render.cuda import KERNELS  # noqa: PLC0415

    resolution, shape_cfg = main_path.SHAPES[shape]
    cfg = main_path.bench_config(size=size, **shape_cfg)
    bridge, randomize, beams = main_path.build(device, resolution=resolution)
    kernel = KERNELS[name]
    kernel.recorded = []
    with torch.no_grad():
        main_path.render_batch(bridge, randomize, beams, list(range(batch)), cfg)
    recorded, kernel.recorded = kernel.recorded, None
    return next(x for x in recorded if not x["any_hit"])


def probe_votes(device, size: int = 512, batch: int = 16) -> list[dict]:
    """The bounce launch of the reference shape (B4) and of
    reference_unculled (B7g), recorded from one forward batch: the pairs a
    vote over 1, 32 and 256 rays would open at least (`vote_widths`),
    beside the pairs the kernel reports it tested."""
    out = []
    for shape, name, wrapper in _BOUNCE:
        rec = _bounce_launch(shape, name, device, size, batch)
        tested = torch.empty_like(rec["tmax_tiles"], dtype=torch.int32)
        t, prim = wrapper(**rec, tested=tested)[:2]
        faces = rec["woop16"].shape[2] // rec["boxes"].shape[2]
        pairs = {w: n * faces for w, n in vote_widths(rec, t, prim).items()}
        live = int((rec["tmax_tiles"] >= 0).sum())
        out.append(_emit(f"votes_{shape}", kernel=name, live_rays=live,
                         clusters=rec["boxes"].shape[2], ray_pairs=pairs[1], warp_pairs=pairs[32],
                         block_pairs=pairs[256],
                         kernel_tested_pairs=float(tested.double().sum()) * faces,
                         warp_over_block=pairs[32] / pairs[256],
                         ray_over_block=pairs[1] / pairs[256]))
    return out


PROBES = {"hitfrac": probe_hitfrac, "kernel": probe_kernel, "roofline": probe_roofline,
          "sass": probe_sass, "votes": probe_votes}


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
