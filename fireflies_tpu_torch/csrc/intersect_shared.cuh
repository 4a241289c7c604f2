// The shared body of the four shared-origin Woop kernels for Hopper (sm_90a):
// intersect_shared_culled.cu (B1) and intersect_stream_culled.cu (B2) walk
// each 2048-ray tile's front-to-back cluster list; intersect_shared.cu (B6)
// walks every cluster in one front-to-back order shared by all tiles, and
// intersect_stream.cu (B7s) every cluster in index order.  B1 and B6 read a
// table of 12 rows a face (W0, W1, W2, o') in clusters of 16 or 64 faces;
// B2 and B7s the streamed table of 16 rows (row 12 the material id, 13-15
// zero) in clusters of 128 (kTableRows, kChunk).
//
// Every ray of a batch starts at one origin (the camera, or a light for
// reversed shadow rays), so each triangle is pre-mapped by its Woop affine
// transform: o' = W (o - v0) is a per-triangle constant and a pair costs
// d' = W d plus a division-free in-triangle test, with the best hit carried
// as a rational (tn, dn = |d'_z|).
//
// What bounds it on this card: the instructions the tested pairs issue.
// Counted with every product that feeds an add fused into it, the pair test
// is 32 operations (40 unfused); the Woop table (48 or 64 bytes a face: 393
// KB at B1's 8192 faces at most, 0.75 MB at B2's 11538) stays in L2, so
// device memory traffic is the directions in and the outputs out.  The
// design:
//   * B1's, B2's and B7s's fused steps are explicit __fmaf_rn (kFused; the
//     build keeps --fmad=false): d'_k = fma(W_k2, dz, fma(W_k1, dy,
//     W_k0 dx)) and u_n = fma(o'_x, dn, tn d'_x), v_n likewise, the order
//     their plain versions round alike (render/cuda/intersect_kernel.py,
//     woop_hits_plain with fused=True).  B6 rounds every operation on its
//     own, the same steps unfused: its parity with the reference's kernel
//     is held to 1e-6 relative in t (tests/test_torch_unculled.py), which
//     one fused rounding of a cancelling d'_z can exceed;
//   * a block of 256 rays stages kBatchFaces faces at once (kK clusters of
//     its walk), rows 0-11 of each copied from device memory with cp.async,
//     16 bytes a thread, with their boxes, into one of two buffers: while
//     the block tests batch i it already copies batch i + 1, and a batch
//     costs one barrier, not three a cluster.  A face's rows are read as
//     16-byte shared loads of four faces each;
//   * camera and shadow rays are coherent, so each warp votes on each staged
//     cluster's slab test (__any_sync) against its rays' running best and
//     skips it together.  The boxes are not padded, unlike the general
//     kernels' (where a ray decides alone): the shared origin can lie on a
//     box's face, and a padded box then opens for rays that leave it, which
//     cost B6 22% more tested pairs on main_unculled's camera launch
//     (perf_probe launches, PERF.md).  In any-hit mode a
//     blocked ray stops voting and a warp stops testing once all of its rays
//     are blocked or dead (__all_sync); the block leaves the walk at the
//     next batch barrier where every warp has stopped, and drains the copy
//     it started.  In closest-hit mode a block whose rays are all dead
//     leaves at once;
//   * no attribute is carried through the walk: where asked (B2), a hit ray
//     reads its winner's W2 row and material id (rows 6-8 and 12) from the
//     table in device memory (L2) after it, so row 12 is never staged; a
//     miss gets (0, 0, 1) and material 0.
// Dead rays (tmax < 0) never hit.  `tested`, unless null, gets each live
// ray's number of clusters its warp tested (0 for a dead ray), the count
// that the pair-test bound of a launch is taken from.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace ff_shared {

using ff_copy::cp_async16;
using ff_copy::cp_async4;
using ff_copy::cp_async_commit;
using ff_copy::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;
constexpr int kRows = 12;          // rows staged: W0, W1, W2, o'
constexpr int kStreamRows = 16;    // rows a face of the streamed table (B2, B7s)
constexpr int kStreamChunk = 128;  // faces a cluster of the streamed table
constexpr int kMatRow = 12;        // the streamed table's material id
constexpr int kBatchFaces = 256;   // faces staged at once
// Blocks an SM: 3 bounds the registers to 80 (B1, B6); 4 to 64 for the
// streamed table's 128-face clusters (B2, B7s), whose spills stay outside the
// pair loop and whose launches took 0.5-2.4% less time than at 3 (perf_probe
// launches, PERF.md).
constexpr int kMinBlocks = 3;
constexpr int kStreamMinBlocks = 4;
constexpr float kBig = 3.0e38f;
constexpr float kEpsBary = 1e-6f;

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// kTableRows: rows a face of `woop` (12, or kStreamRows).  kLists = true:
// `walk` holds lists (B, R / 2048, nc) and `counts` (B, R / 2048) the listed
// lengths.  kLists = false: `walk` holds one order (B, nc) of every cluster,
// or is null for index order, and `counts` is unused (null).  kFused:
// a * b + c steps as one fused multiply-add, else rounded twice.  out_nx ..
// out_mat, unless null, get the winner's attributes (kStreamRows only).
template <int kTableRows, bool kLists, bool kFused, int kChunk>
__global__ void __launch_bounds__(kThreads,
                                  kTableRows == kStreamRows ? kStreamMinBlocks : kMinBlocks)
intersect_shared_kernel(const float* __restrict__ dirs, const float* __restrict__ tmax_in,
                        const float* __restrict__ woop, const float* __restrict__ boxes,
                        const int* __restrict__ walk, const int* __restrict__ counts,
                        float* __restrict__ out_t, int* __restrict__ out_prim,
                        float* __restrict__ out_nx, float* __restrict__ out_ny,
                        float* __restrict__ out_nz, int* __restrict__ out_mat,
                        int* __restrict__ tested, int R, int tpad, int nc, float t_min,
                        int any_hit) {
  constexpr int kK = kBatchFaces / kChunk;  // clusters a batch
  constexpr int kVec = kChunk / 4;
  constexpr int kBatchFloats = kK * kRows * kChunk;
  // Four faces a step; at most 64 faces a loop body, so 128-face clusters
  // keep the code size of 64-face ones.
  constexpr int kUnroll = kVec < 16 ? kVec : 16;
  __shared__ __align__(16) float s_w[2 * kBatchFloats];  // [buffer][cluster][row][face]
  __shared__ float s_box[2][6][kK];
  __shared__ int s_cid[2][kK];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = blockIdx.x * kThreads + tid;
  const int n_tiles = R / kRayTile;
  const int tile = (blockIdx.x * kThreads) / kRayTile;
  const float* dir = dirs + (size_t)b * 3 * R;
  const float dx = dir[r], dy = dir[R + r], dz = dir[2 * R + r];
  const float tmax = tmax_in[(size_t)b * R + r];
  const bool dead = tmax < 0.0f;
  const float* w_b = woop + (size_t)b * kTableRows * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const int* list = kLists            ? walk + ((size_t)b * n_tiles + tile) * nc
                    : walk != nullptr ? walk + (size_t)b * nc
                                      : nullptr;
  const int n_listed = kLists ? __ldg(counts + (size_t)b * n_tiles + tile) : nc;
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);
  // A walk position's cluster.  Lists are never null, and a null test on
  // them cost B1 7 registers and 1.5% of its time.
  auto cluster = [&](int i) { return kLists || list != nullptr ? __ldg(list + i) : i; };
  auto mad = [](float a, float x, float c) { return kFused ? __fmaf_rn(a, x, c) : a * x + c; };

  // Start copying the clusters at walk positions kK batch .. into buffer
  // `buf`: their ids, boxes and Woop rows.
  auto fill = [&](int batch, int buf) {
    const int ci0 = batch * kK, nb = min(kK, n_listed - ci0);
    float* dst = s_w + buf * kBatchFloats;
    for (int x = tid; x < nb * kRows * kVec; x += kThreads) {
      const int j = x / (kRows * kVec), rest = x - j * kRows * kVec;
      const int k = rest / kVec, v = rest - k * kVec;
      const int c = cluster(ci0 + j);
      cp_async16(dst + (j * kRows + k) * kChunk + 4 * v,
                 w_b + (size_t)k * tpad + (size_t)c * kChunk + 4 * v);
    }
    if (tid < nb) s_cid[buf][tid] = cluster(ci0 + tid);
    if (tid < 6 * nb) {
      const int k = tid / nb, j = tid - k * nb;
      cp_async4(&s_box[buf][k][j], box_b + (size_t)k * nc + cluster(ci0 + j));
    }
    cp_async_commit();
  };

  float btn = kBig, bdn = 1.0f;
  int bp = -1, n_tested = 0;
  bool warp_done = __all_sync(0xffffffffu, dead);
  const int n_batches = (n_listed + kK - 1) / kK;
  if (n_batches > 0) fill(0, 0);
  for (int i = 0; i < n_batches; ++i) {
    cp_async_wait<0>();
    // After this barrier batch i is staged and every warp is done with the
    // other buffer.
    if (__syncthreads_and(warp_done)) break;
    const int buf = i & 1;
    if (i + 1 < n_batches) fill(i + 1, buf ^ 1);
    if (warp_done) continue;
    const int nb = min(kK, n_listed - i * kK);
    for (int j = 0; j < nb; ++j) {
      const int c = s_cid[buf][j];
      const float t0x = s_box[buf][0][j] * inv_dx, t1x = s_box[buf][3][j] * inv_dx;
      const float t0y = s_box[buf][1][j] * inv_dy, t1y = s_box[buf][4][j] * inv_dy;
      const float t0z = s_box[buf][2][j] * inv_dz, t1z = s_box[buf][5][j] * inv_dz;
      const float best_t = btn / bdn;
      const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fmaxf(fminf(t0z, t1z), t_min));
      const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fminf(fmaxf(t0z, t1z), fminf(tmax, best_t)));
      const bool open = tnear <= tfar && !(any_hit && bp >= 0);
      if (!__any_sync(0xffffffffu, open)) continue;
      ++n_tested;

      const float* rows = s_w + buf * kBatchFloats + j * kRows * kChunk;
#pragma unroll (kUnroll)
      for (int j0 = 0; j0 < kChunk; j0 += 4) {
        float4 w[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          w[k] = *reinterpret_cast<const float4*>(rows + k * kChunk + j0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float w00 = lane(w[0], q), w01 = lane(w[1], q), w02 = lane(w[2], q);
          const float w10 = lane(w[3], q), w11 = lane(w[4], q), w12 = lane(w[5], q);
          const float w20 = lane(w[6], q), w21 = lane(w[7], q), w22 = lane(w[8], q);
          const float opx = lane(w[9], q), opy = lane(w[10], q), opz = lane(w[11], q);
          const float dpx = mad(w02, dz, mad(w01, dy, w00 * dx));
          const float dpy = mad(w12, dz, mad(w11, dy, w10 * dx));
          const float dpz = mad(w22, dz, mad(w21, dy, w20 * dx));
          const float sgn = dpz >= 0.0f ? 1.0f : -1.0f;
          const float dn = dpz * sgn;
          const float tn = -opz * sgn;
          const float u_n = mad(opx, dn, tn * dpx);
          const float v_n = mad(opy, dn, tn * dpy);
          const bool ok = dn > 1e-12f && u_n >= -kEpsBary * dn && v_n >= -kEpsBary * dn &&
                          u_n + v_n <= (1.0f + kEpsBary) * dn && tn > t_min * dn &&
                          tn < tmax * dn && tn * bdn < btn * dn;
          if (ok) {
            btn = tn;
            bdn = dn;
            bp = c * kChunk + j0 + q;
          }
        }
      }
      if (any_hit && __all_sync(0xffffffffu, bp >= 0 || dead)) {
        warp_done = true;
        break;
      }
    }
  }
  cp_async_wait<0>();  // drain the copy an early exit leaves in flight

  const size_t o = (size_t)b * R + r;
  const bool hit = bp >= 0;
  out_t[o] = hit ? btn / bdn : 0.0f;
  out_prim[o] = bp;
  if constexpr (kTableRows > kMatRow) {
    if (out_nx != nullptr) {  // the winner's W2 row and material, once per ray
      out_nx[o] = hit ? __ldg(w_b + 6 * (size_t)tpad + bp) : 0.0f;
      out_ny[o] = hit ? __ldg(w_b + 7 * (size_t)tpad + bp) : 0.0f;
      out_nz[o] = hit ? __ldg(w_b + 8 * (size_t)tpad + bp) : 1.0f;
      out_mat[o] = hit ? (int)__ldg(w_b + kMatRow * (size_t)tpad + bp) : 0;
    }
  }
  if (tested != nullptr) tested[o] = dead ? 0 : n_tested;
}

template <int kTableRows, bool kLists, bool kFused, int kChunk>
int launch_chunk(const float* dirs, const float* tmax, const float* woop, const float* boxes,
                 const int* walk, const int* counts, float* out_t, int* out_prim, float* out_nx,
                 float* out_ny, float* out_nz, int* out_mat, int* tested, int B, int R, int tpad,
                 int nc, float t_min, int any_hit, cudaStream_t stream) {
  const dim3 grid(R / kThreads, B);
  intersect_shared_kernel<kTableRows, kLists, kFused, kChunk><<<grid, kThreads, 0, stream>>>(
      dirs, tmax, woop, boxes, walk, counts, out_t, out_prim, out_nx, out_ny, out_nz, out_mat,
      tested, R, tpad, nc, t_min, any_hit);
  return (int)cudaGetLastError();
}

// dirs (B, 3, R), tmax (B, R), woop (B, kTableRows, tpad) 16-byte aligned,
// boxes (B, 6, nc) shifted to the shared origin, walk and counts as for the
// kernel -> out_t, out_prim and, unless null, out_nx/ny/nz/mat (all four,
// kStreamRows only) and tested (B, R).  R must be a multiple of 2048, chunk
// 16 (B1's) or 64 (B6's) faces with 12 rows and kStreamChunk with
// kStreamRows, and tpad == nc * chunk.
template <int kTableRows, bool kLists, bool kFused>
int launch_intersect_shared(const float* dirs, const float* tmax, const float* woop,
                            const float* boxes, const int* walk, const int* counts, float* out_t,
                            int* out_prim, float* out_nx, float* out_ny, float* out_nz,
                            int* out_mat, int* tested, int B, int R, int tpad, int nc, int chunk,
                            float t_min, int any_hit, void* stream) {
  static_assert(kTableRows == kRows || kTableRows == kStreamRows, "a table of 12 or 16 rows");
  if (B <= 0 || R <= 0) return 0;
  if (R % kRayTile != 0 || tpad != nc * chunk) return (int)cudaErrorInvalidValue;
  if (kLists && (walk == nullptr || counts == nullptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(woop) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const bool attrs = out_nx != nullptr;
  if (attrs && (kTableRows != kStreamRows || out_ny == nullptr || out_nz == nullptr ||
                out_mat == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kTableRows == kStreamRows) {
    if (chunk == kStreamChunk) {
      return launch_chunk<kTableRows, kLists, kFused, kStreamChunk>(
          dirs, tmax, woop, boxes, walk, counts, out_t, out_prim, out_nx, out_ny, out_nz,
          out_mat, tested, B, R, tpad, nc, t_min, any_hit, s);
    }
  } else {
    switch (chunk) {
      case 16:
        return launch_chunk<kTableRows, kLists, kFused, 16>(
            dirs, tmax, woop, boxes, walk, counts, out_t, out_prim, nullptr, nullptr, nullptr,
            nullptr, tested, B, R, tpad, nc, t_min, any_hit, s);
      case 64:
        return launch_chunk<kTableRows, kLists, kFused, 64>(
            dirs, tmax, woop, boxes, walk, counts, out_t, out_prim, nullptr, nullptr, nullptr,
            nullptr, tested, B, R, tpad, nc, t_min, any_hit, s);
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ff_shared
