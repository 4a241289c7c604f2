// The shared body of the two resident general-origin Moller-Trumbore
// kernels for Hopper (sm_90a): intersect_general.cu (B3) walks every
// cluster in index order; intersect_general_culled.cu (B5) walks each
// 2048-ray tile's front-to-back cluster list (kLists).
//
// Bounce rays have their own origins, so each pair is a rational
// Moller-Trumbore test over clusters of kChunk faces (rows v0, e1, e2), an
// AABB slab test per cluster skips it where the ray cannot reach it closer
// than its best hit so far, and the best hit is carried as a rational
// (tn, dn = |det|) so the pair test needs no division.
//
// What bounds it on this card: the instructions the tested ray-triangle
// pairs issue.  Counted with every product that feeds an add fused into it,
// the pair test is 48 operations (62 unfused); the table (36 bytes a face,
// ~53 KB a variant at 1440 faces, 190 KB at B5's 5288) and the lists stay in
// L2, so device memory traffic is the rays in and (t, prim) out.  The
// design:
//   * the fused steps are explicit __fmaf_rn (the build keeps --fmad=false,
//     so nothing else is contracted), in this order, which the plain
//     version rounds alike (render/cuda/intersect_kernel.py, mt_hits_plain
//     with fma32): each component of P = d x e2 as fma(a, b, -(c d)), and
//     det = e1 . P, u = T . P and v = d . Q each as fma(z, z', fma(y, y',
//     x x')).  The chain of t's numerator, Q = T x e1 and e2 . Q, stays
//     unfused: it cancels when a bounce ray starts near a face's plane, so
//     its rounding decides t there, and the port's reference scans, which
//     round each operation on their own, hold the general route's t to 1e-5
//     relative (tests/test_torch_intersect.py).  That leaves 53 operations a
//     pair;
//   * a block of 256 rays stages kBatchFaces faces (kK clusters of its walk)
//     at once, rows v0, e1, e2 of each cluster copied from device memory
//     with cp.async, 16 bytes a thread, into one of two buffers: while the
//     block tests batch i it already copies batch i + 1, and a batch costs
//     two barriers (its copy is visible; its lists are built), not three a
//     cluster.  The table may hold up to 8192 faces (295 KB), so it is never
//     staged whole;
//   * bounce rays are not coherent, so a ray is tested only against the
//     clusters its own slab test opens: for each staged cluster the rays
//     whose test opens it are gathered into a list, and the block's warps
//     share the tasks (32 entries of the batch's lists end to end against
//     kSlice or kListSlice faces) evenly (append_open and run_tasks of
//     ray_tasks.cuh, the machinery of B4 and B7g).  Each box is padded by
//     1e-5 of its extents (kBoxPad): a hit inside the barycentric tolerance
//     may lie just outside it, and no neighbour's vote covers it;
//   * each ray's best hit is a 64-bit key (t bits, face id) in shared memory
//     lowered with atomicMin; where two faces give the same t (or nearly) the
//     kernel may keep another face than the plain version's argmin (see
//     ray_tasks.cuh), which chip_smoke.py counts as a closest mismatch.
// Any-hit: a ray with a hit stops opening clusters, and the block leaves the
// walk at a batch barrier once every live ray was blocked before the
// previous batch's tasks (the keys it reads after the barrier before), then
// drains the copy in flight.  In closest-hit mode a block whose rays are all
// dead leaves at its first barrier.
// Dead rays (tmax < 0) never hit.  `tested`, unless null, gets each live
// ray's number of clusters its own slab test opened (0 for a dead ray), the
// count that the pair-test bound of a launch is taken from.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "ray_tasks.cuh"

namespace ff_general {

using ff_copy::cp_async16;
using ff_copy::cp_async4;
using ff_copy::cp_async_commit;
using ff_copy::cp_async_wait;
using ff_tasks::kBig;
using ff_tasks::kNoHit;
using ff_tasks::kThreads;
using ff_tasks::lane;

constexpr int kRows = 9;            // v0, e1, e2
constexpr int kRayTile = 2048;      // rays a tile list serves
constexpr int kBatchFaces = 256;    // faces staged at once
// Faces of a cluster a task: 32 for B3; 16 for B5, whose tiles list most
// clusters, so a batch holds about a third of the open pairs of B3's, and
// tasks of 16 faces keep the block's 8 warps busy (7.17 against 7.40 ms on
// mid's bounce launch, perf_probe launches, PERF.md).
constexpr int kSlice = 32;
constexpr int kListSlice = 16;
constexpr int kMinBlocks = 3;       // blocks an SM, which bounds the registers to 80
constexpr float kEpsDet = 1e-9f;
constexpr float kEpsBary = 1e-6f;
constexpr float kBoxPad = 1e-5f;

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

// The fused rational Moller-Trumbore test for run_tasks: rows v0, e1, e2 of
// four faces, the ray's origin and tmax (o4) and direction.
struct MollerTrumbore {
  float t_min;
  __device__ __forceinline__ bool operator()(const float4 (&w)[kRows], int q, const float4& o4,
                                             const float4& d4, float btn, float bdn, float& tn,
                                             float& dn) const {
    const float v0x = lane(w[0], q), v0y = lane(w[1], q), v0z = lane(w[2], q);
    const float e1x = lane(w[3], q), e1y = lane(w[4], q), e1z = lane(w[5], q);
    const float e2x = lane(w[6], q), e2y = lane(w[7], q), e2z = lane(w[8], q);
    const float dx = d4.x, dy = d4.y, dz = d4.z;
    const float px = __fmaf_rn(dy, e2z, -(dz * e2y));
    const float py = __fmaf_rn(dz, e2x, -(dx * e2z));
    const float pz = __fmaf_rn(dx, e2y, -(dy * e2x));
    const float det = __fmaf_rn(e1z, pz, __fmaf_rn(e1y, py, e1x * px));
    const float tx = o4.x - v0x, ty = o4.y - v0y, tz = o4.z - v0z;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float sgn = det >= 0.0f ? 1.0f : -1.0f;
    dn = det * sgn;
    const float un = __fmaf_rn(tz, pz, __fmaf_rn(ty, py, tx * px)) * sgn;
    const float vn = __fmaf_rn(dz, qz, __fmaf_rn(dy, qy, dx * qx)) * sgn;
    tn = (e2x * qx + e2y * qy + e2z * qz) * sgn;
    const float eb = kEpsBary * dn;
    return (dn >= kEpsDet) & (un >= -eb) & (vn >= -eb) & (un + vn <= dn + eb) &
           (tn > t_min * dn) & (tn < o4.w * dn) & (tn * bdn < btn * dn);
  }
};

// kLists = true: `lists` holds lists (B, R / 2048, nc) and `counts`
// (B, R / 2048) the listed lengths; false: every cluster in index order, and
// both are unused (null).
template <bool kLists, int kChunk>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
intersect_general_kernel(const float* __restrict__ rays, const float* __restrict__ tmax_in,
                         const float* __restrict__ tri, const float* __restrict__ boxes,
                         const int* __restrict__ lists, const int* __restrict__ counts,
                         float* __restrict__ out_t, int* __restrict__ out_prim,
                         int* __restrict__ tested, int R, int tpad, int nc, float t_min,
                         int any_hit) {
  constexpr int kK = kBatchFaces / kChunk;  // clusters a batch
  constexpr int kVec = kChunk / 4;
  constexpr int kBatchFloats = kK * kRows * kChunk;
  __shared__ __align__(16) float s_tri[2 * kBatchFloats];  // [buffer][cluster][row][face]
  __shared__ float s_box[2][6][kK];
  __shared__ float4 s_o[kThreads];  // origin, tmax
  __shared__ float4 s_d[kThreads];  // direction
  __shared__ unsigned long long s_best[kThreads];
  __shared__ int s_open[kK * kThreads];
  __shared__ int s_n_open[2][kK];
  __shared__ int s_cid[2][kK];  // kLists: the staged clusters' ids
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const int r = blockIdx.x * kThreads + tid;
  const float* ray = rays + (size_t)b * 6 * R;
  const float ox = ray[r], oy = ray[R + r], oz = ray[2 * R + r];
  const float dx = ray[3 * R + r], dy = ray[4 * R + r], dz = ray[5 * R + r];
  const float tmax = tmax_in[(size_t)b * R + r];
  const bool dead = tmax < 0.0f;
  const float* tri_b = tri + (size_t)b * kRows * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const int n_tiles = R / kRayTile;
  const int tile = (blockIdx.x * kThreads) / kRayTile;
  const int* list = kLists ? lists + ((size_t)b * n_tiles + tile) * nc : nullptr;
  const int n_listed = kLists ? __ldg(counts + (size_t)b * n_tiles + tile) : nc;
  auto cluster = [&](int i) { return kLists ? __ldg(list + i) : i; };
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);
  s_o[tid] = make_float4(ox, oy, oz, tmax);
  s_d[tid] = make_float4(dx, dy, dz, 0.0f);
  s_best[tid] = kNoHit;
  if (tid < 2 * kK) s_n_open[tid / kK][tid % kK] = 0;

  // Start copying batch `batch` (the clusters at walk positions kK batch ..)
  // into buffer `buf`.
  auto fill = [&](int batch, int buf) {
    const int ci0 = batch * kK, nb = min(kK, n_listed - ci0);
    float* dst = s_tri + buf * kBatchFloats;
    for (int x = tid; x < nb * kRows * kVec; x += kThreads) {
      const int j = x / (kRows * kVec), rest = x - j * kRows * kVec;
      const int k = rest / kVec, v = rest - k * kVec;
      cp_async16(dst + (j * kRows + k) * kChunk + 4 * v,
                 tri_b + (size_t)k * tpad + (size_t)cluster(ci0 + j) * kChunk + 4 * v);
    }
    if (kLists && tid < nb) s_cid[buf][tid] = cluster(ci0 + tid);
    if (tid < 6 * nb) {
      const int k = tid / nb, j = tid - k * nb;
      cp_async4(&s_box[buf][k][j], box_b + (size_t)k * nc + cluster(ci0 + j));
    }
    cp_async_commit();
  };

  const int n_batches = (n_listed + kK - 1) / kK;
  bool done = dead;  // as of the previous batch
  int n_tested = 0;
  if (n_batches > 0) fill(0, 0);
  for (int i = 0; i < n_batches; ++i) {
    cp_async_wait<0>();
    // After this barrier batch i is staged, the previous batch's tasks are
    // done (so the other buffer, its ids, the lists and the other counters
    // are free).
    if (__syncthreads_and(done)) break;
    const int buf = i & 1;
    if (tid < kK) s_n_open[buf ^ 1][tid] = 0;
    if (i + 1 < n_batches) fill(i + 1, buf ^ 1);

    const unsigned long long best = s_best[tid];
    done = dead || (any_hit && best != kNoHit);
    const float best_t = best == kNoHit ? kBig : __uint_as_float((unsigned)(best >> 32));
    const int ci0 = i * kK, nb = min(kK, n_listed - ci0);
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      bool open = false;
      if (j < nb && !done) {
        float lox = s_box[buf][0][j], loy = s_box[buf][1][j], loz = s_box[buf][2][j];
        float hix = s_box[buf][3][j], hiy = s_box[buf][4][j], hiz = s_box[buf][5][j];
        const float pad = kBoxPad * ((hix - lox) + (hiy - loy) + (hiz - loz));
        lox -= pad;
        loy -= pad;
        loz -= pad;
        hix += pad;
        hiy += pad;
        hiz += pad;
        const float t0x = (lox - ox) * inv_dx, t1x = (hix - ox) * inv_dx;
        const float t0y = (loy - oy) * inv_dy, t1y = (hiy - oy) * inv_dy;
        const float t0z = (loz - oz) * inv_dz, t1z = (hiz - oz) * inv_dz;
        const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                  fmaxf(fminf(t0z, t1z), t_min));
        const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fminf(fmaxf(t0z, t1z), fminf(tmax, best_t)));
        open = tnear <= tfar;
      }
      n_tested += open;
      ff_tasks::append_open(open, tid, lane_id, s_open + j * kThreads, &s_n_open[buf][j]);
    }
    __syncthreads();
    ff_tasks::run_tasks<kK, kChunk, kLists ? kListSlice : kSlice, kRows>(
        s_tri + buf * kBatchFloats, s_open, s_n_open[buf],
        [&](int j) { return (kLists ? s_cid[buf][j] : ci0 + j) * kChunk; }, s_o, s_d, s_best,
        warp, lane_id, MollerTrumbore{t_min});
  }
  cp_async_wait<0>();  // drain the copy an early exit leaves in flight
  __syncthreads();     // the last batch's tasks are done

  const unsigned long long best = s_best[tid];
  const bool hit = best != kNoHit;
  const size_t o = (size_t)b * R + r;
  out_t[o] = hit ? __uint_as_float((unsigned)(best >> 32)) : 0.0f;
  out_prim[o] = hit ? (int)(unsigned)(best & 0xffffffffu) : -1;
  if (tested != nullptr) tested[o] = dead ? 0 : n_tested;
}

// rays (B, 6, R), tmax (B, R), tri (B, 9, tpad) 16-byte aligned, boxes
// (B, 6, nc) and, with kLists, lists (B, R / 2048, nc) and counts
// (B, R / 2048) -> out_t, out_prim and, unless null, tested (B, R).  R must
// be a multiple of 256 (2048 with lists) and tpad == nc * kChunk.
template <bool kLists, int kChunk>
int launch_intersect_general(const float* rays, const float* tmax, const float* tri,
                             const float* boxes, const int* lists, const int* counts,
                             float* out_t, int* out_prim, int* tested, int B, int R, int tpad,
                             int nc, float t_min, int any_hit, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (R % (kLists ? kRayTile : kThreads) != 0 || tpad != nc * kChunk) {
    return (int)cudaErrorInvalidValue;
  }
  if (kLists && (lists == nullptr || counts == nullptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(tri) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const dim3 grid(R / kThreads, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  intersect_general_kernel<kLists, kChunk><<<grid, kThreads, 0, s>>>(
      rays, tmax, tri, boxes, lists, counts, out_t, out_prim, tested, R, tpad, nc, t_min, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace ff_general
