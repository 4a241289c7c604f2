"""Kernel-level timings and measured roofs of the port on one NVIDIA GPU.

    python -m fireflies_tpu_torch.perf_probe hitfrac|kernel|roofline|all [out.json]

Counterpart of tools/perf_probe.py (`probe_hitfrac`, `probe_kernel`,
`probe_roofline`; its `probe_step` needs the projector-texture route, which
is not ported).  Each measurement prints one JSON line; with `out.json` they
are also written there.  The card's name and power limit come first.

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

Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time

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

# Float operations per tested (ray, triangle) pair, by kernel, counted from
# the pair tests in csrc/ (multiplies, adds, subtractions, negations and
# compares; the selects that keep the best hit not counted): the
# shared-origin Woop test (B1, B2, B6, B7s), the general Woop test with o'
# formed per pair (B4, B7g), the rational Moller-Trumbore test (B3, B5), and
# X1's Woop test with one division (15 for d' = W d, |d'_z| and its compare,
# the reciprocal, -o'_z and its product, 4 for u and v, the sum u + v and 5
# compares).
OPS_PER_PAIR = {"intersect_shared_culled": 40, "intersect_stream_culled": 40,
                "intersect_stream_general_culled": 58, "intersect_general": 62,
                "intersect_general_culled": 62, "intersect_shared": 40, "intersect_stream": 40,
                "intersect_stream_general": 58, "intersect_mxu_shared": 30}
# H100 SXM FP32 outside the tensor cores: 67 TFLOP/s counts a fused
# multiply-add as two operations.  The kernels are built with --fmad=false,
# so each multiply, add and compare executes on its own: 33.5e12 a second.
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


def main() -> None:
    what = sys.argv[1] if len(sys.argv) > 1 else "all"
    out = sys.argv[2] if len(sys.argv) > 2 else None
    if what not in ("hitfrac", "kernel", "roofline", "all"):
        raise SystemExit(__doc__.splitlines()[2].strip())
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(f"# {nvidia_smi()} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t_all = time.perf_counter()
    records = []
    for name, probe in (("hitfrac", probe_hitfrac), ("kernel", probe_kernel),
                        ("roofline", probe_roofline)):
        if what in (name, "all"):
            records += probe(dev)
    print(f"# total {time.perf_counter() - t_all:.1f} s", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump({r["probe"]: r for r in records}, f, indent=1)


if __name__ == "__main__":
    main()
