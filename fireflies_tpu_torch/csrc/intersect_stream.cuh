// The shared body of the two streamed general-origin Woop kernels for Hopper
// (sm_90a): intersect_stream_general_culled.cu (B4) walks per-tile cluster
// lists; intersect_stream_general.cu (B7g) walks every cluster in index
// order.  (The streamed shared-origin kernels, B2 and B7s, run on B1's body,
// intersect_shared.cuh.)
//
// A block of 256 rays walks 128-face clusters: with lists (kLists), its
// 2048-ray tile's front-to-back list; without, clusters 0 .. nc - 1.  A
// cluster's rows 0-11 of the packed Woop table (W rows 0-8, W v0 rows 9-11)
// are copied from device memory into one of two shared-memory buffers with
// cp.async, 16 bytes a thread: while the block tests cluster i it already
// copies the next cluster into the other buffer, the card's counterpart of
// the Pallas kernels' DMA double buffer.  In any-hit mode the block leaves
// the walk once every live ray is blocked or dead (__syncthreads_and), and
// waits for the copy still in flight before it exits, since the shared
// memory it targets is handed to the next block.  `tested`, unless null,
// gets each live ray's number of clusters whose faces it was tested against
// (0 for a dead ray), the count that the pair-test bound of a launch is
// taken from.
//
// stream_general_kernel is built for the card's fused multiply-add pipe.
// What bounds it is the instructions the tested pairs issue: the counted
// test is 41 operations with every product that feeds an add fused into it,
// against 58 unfused.  So:
//   * its fused steps are explicit __fmaf_rn in an order written below (the
//     build keeps --fmad=false, so no other operation of any kernel is
//     contracted): o'_k = fma(W_k2, oz, fma(W_k1, oy, fma(W_k0, ox,
//     -(W v0)_k))), d'_k = fma(W_k2, dz, fma(W_k1, dy, W_k0 dx)), and
//     u_n = fma(o'_x, dn, tn d'_x), v_n likewise; the plain version rounds
//     each of these steps once, in the same order;
//   * a ray is tested only against the clusters its own slab test opens:
//     on the reference shape's bounce launch that is 0.43 of the pairs a
//     block's vote opens and 0.73 of a warp's (perf_probe votes).  The rays
//     that open a cluster are gathered into a list, and the block's warps
//     share its tasks (32 listed rays, one a lane, against kSlice faces)
//     evenly, so no warp idles at the cluster's barrier while others test
//     (append_open and run_tasks of ray_tasks.cuh, shared with B3); each
//     box is padded by 1e-5 of its extents (kBoxPad), since a hit inside
//     the barycentric tolerance may lie just outside it;
//   * each ray's closest hit so far is one 64-bit key (t bits, face id) in
//     shared memory lowered with atomicMin (ray_tasks.cuh), so where two
//     faces round to the same t (or nearly) it may keep another face than
//     the plain version's argmin; chip_smoke.py counts such rays as
//     closest mismatches;
//   * no attribute is carried: after the walk a hit ray reads its winner's
//     W2 row and material id (rows 6-8 and 12) from the table in device
//     memory (L2), so row 12 is not copied.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "ray_tasks.cuh"

namespace ff_stream {

using ff_copy::cp_async16;
using ff_copy::cp_async_commit;
using ff_copy::cp_async_wait;

using ff_tasks::kBig;
using ff_tasks::kNoHit;
using ff_tasks::kThreads;
using ff_tasks::lane;

constexpr int kRayTile = 2048;
constexpr int kChunk = 128;     // faces per streamed cluster
constexpr int kWoopRows = 16;   // rows of the packed table in device memory
constexpr int kGeneralRows = 12;  // rows a general kernel reads: W, W v0
constexpr int kMatRow = 12;
constexpr int kVecPerRow = kChunk / 4;
constexpr float kEpsBary = 1e-6f;
constexpr float kBoxPad = 1e-5f;  // the general kernels' box padding, of its extents

// The general kernels' design: at least 3 blocks an SM (which bounds the
// registers to 80) and 32 faces of a cluster a task.
constexpr int kGeneralMinBlocks = 3;
constexpr int kSlice = 32;

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

// Start copying cluster c's first kRows rows of one variant's table into
// `buf`; every thread commits one group, so cp_async_wait<N> counts clusters.
template <int kRows>
__device__ __forceinline__ void copy_cluster(float* buf, const float* woop_b, int tpad, int c) {
  for (int i = threadIdx.x; i < kRows * kVecPerRow; i += kThreads) {
    const int k = i / kVecPerRow, q = i - k * kVecPerRow;
    cp_async16(buf + k * kChunk + 4 * q, woop_b + (size_t)k * tpad + (size_t)c * kChunk + 4 * q);
  }
  cp_async_commit();
}

// The general Woop pair test of B4 and B7g for run_tasks: rows W0, W1, W2
// and W v0 of four faces, the ray's origin and tmax (o4) and direction.
struct WoopGeneral {
  float t_min;
  __device__ __forceinline__ bool operator()(const float4 (&w)[kGeneralRows], int q,
                                             const float4& o4, const float4& d4, float btn,
                                             float bdn, float& tn, float& dn) const {
    const float w00 = lane(w[0], q), w01 = lane(w[1], q), w02 = lane(w[2], q);
    const float w10 = lane(w[3], q), w11 = lane(w[4], q), w12 = lane(w[5], q);
    const float w20 = lane(w[6], q), w21 = lane(w[7], q), w22 = lane(w[8], q);
    const float opx =
        __fmaf_rn(w02, o4.z, __fmaf_rn(w01, o4.y, __fmaf_rn(w00, o4.x, -lane(w[9], q))));
    const float opy =
        __fmaf_rn(w12, o4.z, __fmaf_rn(w11, o4.y, __fmaf_rn(w10, o4.x, -lane(w[10], q))));
    const float opz =
        __fmaf_rn(w22, o4.z, __fmaf_rn(w21, o4.y, __fmaf_rn(w20, o4.x, -lane(w[11], q))));
    const float dpx = __fmaf_rn(w02, d4.z, __fmaf_rn(w01, d4.y, w00 * d4.x));
    const float dpy = __fmaf_rn(w12, d4.z, __fmaf_rn(w11, d4.y, w10 * d4.x));
    const float dpz = __fmaf_rn(w22, d4.z, __fmaf_rn(w21, d4.y, w20 * d4.x));
    const float sgn = dpz >= 0.0f ? 1.0f : -1.0f;
    dn = dpz * sgn;
    tn = -opz * sgn;
    const float u_n = __fmaf_rn(opx, dn, tn * dpx);
    const float v_n = __fmaf_rn(opy, dn, tn * dpy);
    return (dn > 1e-12f) & (u_n >= -kEpsBary * dn) & (v_n >= -kEpsBary * dn) &
           (u_n + v_n <= (1.0f + kEpsBary) * dn) & (tn > t_min * dn) & (tn < o4.w * dn) &
           (tn * bdn < btn * dn);
  }
};

// The general-origin kernels (B4, B7g): rays (B, 6, R) origins then
// directions, woop rows 9-11 = W v0, boxes in world space.  kLists = false:
// lists and counts are unused (null).  out_nx .. out_mat may be null (no
// attributes), and so may tested.
template <bool kLists>
__global__ void __launch_bounds__(kThreads, kGeneralMinBlocks)
stream_general_kernel(const float* __restrict__ rays, const float* __restrict__ tmax_in,
                      const float* __restrict__ woop, const float* __restrict__ boxes,
                      const int* __restrict__ lists, const int* __restrict__ counts,
                      float* __restrict__ out_t, int* __restrict__ out_prim,
                      float* __restrict__ out_nx, float* __restrict__ out_ny,
                      float* __restrict__ out_nz, int* __restrict__ out_mat,
                      int* __restrict__ tested, int R, int tpad, int nc, float t_min,
                      int any_hit) {
  constexpr int kRows = kGeneralRows;
  constexpr int kBufFloats = kRows * kChunk;
  __shared__ __align__(16) float s_w[2 * kBufFloats];
  __shared__ float4 s_o[kThreads];  // origin, tmax
  __shared__ float4 s_d[kThreads];  // direction
  __shared__ unsigned long long s_best[kThreads];
  __shared__ int s_open[kThreads];
  __shared__ int s_n_open;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const int r = blockIdx.x * kThreads + tid;
  const int n_tiles = R / kRayTile;
  const int tile = (blockIdx.x * kThreads) / kRayTile;
  const float* ray = rays + (size_t)b * 6 * R;
  const float ox = ray[r], oy = ray[R + r], oz = ray[2 * R + r];
  const float dx = ray[3 * R + r], dy = ray[4 * R + r], dz = ray[5 * R + r];
  const float tmax = tmax_in[(size_t)b * R + r];
  const bool dead = tmax < 0.0f;
  const float* woop_b = woop + (size_t)b * kWoopRows * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const int* list = kLists ? lists + ((size_t)b * n_tiles + tile) * nc : nullptr;
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);
  auto cluster = [&](int ci) { return kLists ? __ldg(list + ci) : ci; };
  s_o[tid] = make_float4(ox, oy, oz, tmax);
  s_d[tid] = make_float4(dx, dy, dz, 0.0f);
  s_best[tid] = kNoHit;
  if (tid == 0) s_n_open = 0;

  int n_tested = 0;
  int n_listed = kLists ? __ldg(counts + (size_t)b * n_tiles + tile) : nc;
  if (!any_hit && __syncthreads_and(dead)) n_listed = 0;
  if (n_listed > 0) copy_cluster<kRows>(s_w, woop_b, tpad, cluster(0));
  for (int ci = 0; ci < n_listed; ++ci) {
    // s_best[tid] was last lowered before the previous barrier.
    if (any_hit && __syncthreads_and(s_best[tid] != kNoHit || dead)) break;
    const int c = cluster(ci);
    const float* cur = s_w + (ci & 1) * kBufFloats;
    if (ci + 1 < n_listed) {
      copy_cluster<kRows>(s_w + ((ci + 1) & 1) * kBufFloats, woop_b, tpad, cluster(ci + 1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const unsigned long long best = s_best[tid];
    const float best_t = best == kNoHit ? kBig : __uint_as_float((unsigned)(best >> 32));
    float lox = __ldg(box_b + 0 * nc + c), loy = __ldg(box_b + 1 * nc + c);
    float loz = __ldg(box_b + 2 * nc + c), hix = __ldg(box_b + 3 * nc + c);
    float hiy = __ldg(box_b + 4 * nc + c), hiz = __ldg(box_b + 5 * nc + c);
    const float pad = kBoxPad * ((hix - lox) + (hiy - loy) + (hiz - loz));
    lox -= pad;
    loy -= pad;
    loz -= pad;
    hix += pad;
    hiy += pad;
    hiz += pad;
    const float t0x = (lox - ox) * inv_dx;
    const float t1x = (hix - ox) * inv_dx;
    const float t0y = (loy - oy) * inv_dy;
    const float t1y = (hiy - oy) * inv_dy;
    const float t0z = (loz - oz) * inv_dz;
    const float t1z = (hiz - oz) * inv_dz;
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), t_min));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), fminf(tmax, best_t)));
    const bool open = tnear <= tfar;
    n_tested += open;
    ff_tasks::append_open(open, tid, lane_id, s_open, &s_n_open);
    __syncthreads();
    ff_tasks::run_tasks<1, kChunk, kSlice, kRows>(
        cur, s_open, &s_n_open, [&](int) { return c * kChunk; }, s_o, s_d, s_best, warp, lane_id,
        WoopGeneral{t_min});
    __syncthreads();
    if (tid == 0) s_n_open = 0;  // read by every thread before the barrier above
  }
  cp_async_wait<0>();  // drain the copy an early exit leaves in flight

  const unsigned long long best = s_best[tid];
  const bool hit = best != kNoHit;
  const int bp = hit ? (int)(unsigned)(best & 0xffffffffu) : -1;
  const size_t o = (size_t)b * R + r;
  out_t[o] = hit ? __uint_as_float((unsigned)(best >> 32)) : 0.0f;
  out_prim[o] = bp;
  if (out_nx != nullptr) {  // the winner's W2 row and material, once per ray
    out_nx[o] = hit ? __ldg(woop_b + 6 * (size_t)tpad + bp) : 0.0f;
    out_ny[o] = hit ? __ldg(woop_b + 7 * (size_t)tpad + bp) : 0.0f;
    out_nz[o] = hit ? __ldg(woop_b + 8 * (size_t)tpad + bp) : 1.0f;
    out_mat[o] = hit ? (int)__ldg(woop_b + kMatRow * (size_t)tpad + bp) : 0;
  }
  if (tested != nullptr) tested[o] = dead ? 0 : n_tested;
}

// rays (B, 6, R), tmax (B, R), woop (B, 16, tpad), boxes (B, 6, nc) and,
// with kLists, lists (B, R / 2048, nc), counts (B, R / 2048) -> out_t,
// out_prim and, unless null, out_nx/ny/nz/mat and tested (B, R).  R must be a
// multiple of 2048, tpad == nc * 128, and woop 16-byte aligned.
template <bool kLists>
int launch_stream_general(const float* rays, const float* tmax, const float* woop,
                          const float* boxes, const int* lists, const int* counts, float* out_t,
                          int* out_prim, float* out_nx, float* out_ny, float* out_nz,
                          int* out_mat, int* tested, int B, int R, int tpad, int nc, float t_min,
                          int any_hit, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (R % kRayTile != 0 || tpad != nc * kChunk) return (int)cudaErrorInvalidValue;
  if (kLists && (lists == nullptr || counts == nullptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(woop) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const bool attrs = out_nx != nullptr;
  if (attrs && (out_ny == nullptr || out_nz == nullptr || out_mat == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(R / kThreads, B);
  stream_general_kernel<kLists><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, tmax, woop, boxes, lists, counts, out_t, out_prim, out_nx, out_ny, out_nz, out_mat,
      tested, R, tpad, nc, t_min, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace ff_stream
