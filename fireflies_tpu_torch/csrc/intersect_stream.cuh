// The shared body of the four streamed Woop kernels for Hopper (sm_90a):
// intersect_stream_culled.cu (B2) and intersect_stream_general_culled.cu
// (B4) walk per-tile cluster lists; intersect_stream.cu (B7s) and
// intersect_stream_general.cu (B7g) walk every cluster in index order.
//
// A block of 256 rays walks 128-face clusters: with lists (kLists), its
// 2048-ray tile's front-to-back list; without, clusters 0 .. nc - 1.  A
// cluster's rows of the packed Woop table (W rows 0-8, o' or W v0 rows 9-11,
// and for the shared-origin kernels the material id in row 12) are copied
// from device memory into one of two shared-memory buffers with cp.async, 16
// bytes a thread: while the block tests cluster i it already copies the next
// cluster into the other buffer, the card's counterpart of the Pallas
// kernels' DMA double buffer.  Each cluster's slab test decides whether its
// faces are tested, and a pruned cluster skips its arithmetic but not its
// copy.  In any-hit mode the block leaves the walk once every live ray is
// blocked or dead (__syncthreads_and), and waits for the copy still in
// flight before it exits, since the shared memory it targets is handed to
// the next block.  `tested`, unless null, gets each live ray's number of
// clusters whose faces it was tested against (0 for a dead ray), the count
// that the pair-test bound of a launch is taken from.
//
// stream_kernel, the shared-origin kernels (B2, B7s): each thread tests its
// ray against every face of a cluster that the block's vote
// (__syncthreads_or) opens, and carries the best hit's normal and material.
//
// stream_general_kernel, the general-origin kernels (B4, B7g), is built for
// the card's fused multiply-add pipe.  What bounds it is the instructions
// the tested pairs issue: the counted test is 41 operations with every
// product that feeds an add fused into it, against 58 unfused.  So:
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
//     evenly, so no warp idles at the cluster's barrier while others test;
//     each box is padded by 1e-5 of its extents (kBoxPad), since a hit
//     inside the barycentric tolerance may lie just outside it;
//   * a task carries its best of kSlice faces as the rational (tn, dn),
//     replaced only when tn bdn < btn dn (each product rounded), and
//     divides once; each ray's closest hit so far is one 64-bit key in
//     shared memory, the bits of t above the face id, lowered with
//     atomicMin, so across slices and clusters the smallest t wins, ties to
//     the lowest face id.  Inside a slice the rational compare decides, so
//     where two faces round to the same t (or nearly) it may keep another
//     face than the plain version's argmin, which takes the lowest id among
//     equal t; chip_smoke.py counts such rays as closest mismatches;
//   * no attribute is carried: after the walk a hit ray reads its winner's
//     W2 row and material id (rows 6-8 and 12) from the table in device
//     memory (L2), so row 12 is not copied.

#pragma once

#include <cuda_runtime.h>

namespace ff_stream {

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;
constexpr int kChunk = 128;     // faces per streamed cluster
constexpr int kWoopRows = 16;   // rows of the packed table in device memory
constexpr int kCopyRows = 13;   // rows a shared-origin kernel reads: W, o', material
constexpr int kGeneralRows = 12;  // rows a general kernel reads: W, W v0
constexpr int kMatRow = 12;
constexpr int kVecPerRow = kChunk / 4;
constexpr float kBig = 3.0e38f;
constexpr float kEpsBary = 1e-6f;
constexpr float kBoxPad = 1e-5f;  // the general kernels' box padding, of its extents
constexpr unsigned long long kNoHit = ~0ull;

// The general kernels' design: at least 3 blocks an SM (which bounds the
// registers to 80) and 32 faces of a cluster a task.
constexpr int kGeneralMinBlocks = 3;
constexpr int kSlice = 32;

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// The shared-origin kernels (B2, B7s): rays (B, 3, R) directions from a
// shared origin, woop rows 9-11 = o' = W (o - v0), boxes origin-shifted.
// kLists = false: lists and counts are unused (null).  out_nx .. out_mat may
// be null (no attributes), and so may tested.
template <bool kLists>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ rays, const float* __restrict__ tmax_in,
              const float* __restrict__ woop, const float* __restrict__ boxes,
              const int* __restrict__ lists, const int* __restrict__ counts,
              float* __restrict__ out_t, int* __restrict__ out_prim,
              float* __restrict__ out_nx, float* __restrict__ out_ny,
              float* __restrict__ out_nz, int* __restrict__ out_mat,
              int* __restrict__ tested, int R, int tpad, int nc, float t_min, int any_hit) {
  constexpr int kBufFloats = kCopyRows * kChunk;
  __shared__ __align__(16) float s_w[2 * kBufFloats];
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int n_tiles = R / kRayTile;
  const int tile = (blockIdx.x * kThreads) / kRayTile;
  const float* dir = rays + (size_t)b * 3 * R;
  const float ox = 0.0f, oy = 0.0f, oz = 0.0f;  // boxes and o' are origin-relative
  const float dx = dir[r], dy = dir[R + r], dz = dir[2 * R + r];
  const float tmax = tmax_in[(size_t)b * R + r];
  const bool dead = tmax < 0.0f;
  const float* woop_b = woop + (size_t)b * kWoopRows * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const int* list = kLists ? lists + ((size_t)b * n_tiles + tile) * nc : nullptr;
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy), inv_dz = safe_inv(dz);
  auto cluster = [&](int ci) { return kLists ? __ldg(list + ci) : ci; };

  float btn = kBig, bdn = 1.0f, bnx = 0.0f, bny = 0.0f, bnz = 1.0f, bmat = 0.0f;
  int bp = -1, n_tested = 0;
  int n_listed = kLists ? __ldg(counts + (size_t)b * n_tiles + tile) : nc;
  if (!any_hit && __syncthreads_and(dead)) n_listed = 0;
  if (n_listed > 0) copy_cluster<kCopyRows>(s_w, woop_b, tpad, cluster(0));
  for (int ci = 0; ci < n_listed; ++ci) {
    if (any_hit && __syncthreads_and(bp >= 0 || dead)) break;
    const int c = cluster(ci);
    const float* cur = s_w + (ci & 1) * kBufFloats;
    if (ci + 1 < n_listed) {
      // The other buffer was last read before the previous barrier.
      copy_cluster<kCopyRows>(s_w + ((ci + 1) & 1) * kBufFloats, woop_b, tpad,
                              cluster(ci + 1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float best_t = btn / bdn;
    const float t0x = (__ldg(box_b + 0 * nc + c) - ox) * inv_dx;
    const float t1x = (__ldg(box_b + 3 * nc + c) - ox) * inv_dx;
    const float t0y = (__ldg(box_b + 1 * nc + c) - oy) * inv_dy;
    const float t1y = (__ldg(box_b + 4 * nc + c) - oy) * inv_dy;
    const float t0z = (__ldg(box_b + 2 * nc + c) - oz) * inv_dz;
    const float t1z = (__ldg(box_b + 5 * nc + c) - oz) * inv_dz;
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), t_min));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), fminf(tmax, best_t)));
    if (!__syncthreads_or(tnear <= tfar)) continue;
    ++n_tested;

    for (int j0 = 0; j0 < kChunk; j0 += 4) {
      float4 w[kCopyRows];
#pragma unroll
      for (int k = 0; k < kCopyRows; ++k) {
        w[k] = *reinterpret_cast<const float4*>(cur + k * kChunk + j0);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w00 = lane(w[0], q), w01 = lane(w[1], q), w02 = lane(w[2], q);
        const float w10 = lane(w[3], q), w11 = lane(w[4], q), w12 = lane(w[5], q);
        const float w20 = lane(w[6], q), w21 = lane(w[7], q), w22 = lane(w[8], q);
        const float opx = lane(w[9], q), opy = lane(w[10], q), opz = lane(w[11], q);
        const float dpx = w00 * dx + w01 * dy + w02 * dz;
        const float dpy = w10 * dx + w11 * dy + w12 * dz;
        const float dpz = w20 * dx + w21 * dy + w22 * dz;
        const float sgn = dpz >= 0.0f ? 1.0f : -1.0f;
        const float dn = dpz * sgn;
        const float tn = -opz * sgn;
        const float u_n = opx * dn + tn * dpx;
        const float v_n = opy * dn + tn * dpy;
        const bool ok = dn > 1e-12f && u_n >= -kEpsBary * dn && v_n >= -kEpsBary * dn &&
                        u_n + v_n <= (1.0f + kEpsBary) * dn && tn > t_min * dn &&
                        tn < tmax * dn && tn * bdn < btn * dn;
        if (ok) {
          btn = tn;
          bdn = dn;
          bp = c * kChunk + j0 + q;
          bnx = w20;
          bny = w21;
          bnz = w22;
          bmat = lane(w[12], q);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // drain the copy an early exit leaves in flight

  const size_t o = (size_t)b * R + r;
  out_t[o] = bp >= 0 ? btn / bdn : 0.0f;
  out_prim[o] = bp;
  if (out_nx != nullptr) {
    out_nx[o] = bnx;
    out_ny[o] = bny;
    out_nz[o] = bnz;
    out_mat[o] = (int)bmat;
  }
  if (tested != nullptr) tested[o] = dead ? 0 : n_tested;
}

// The general-origin kernels (B4, B7g): rays (B, 6, R) origins then
// directions, woop rows 9-11 = W v0, boxes in world space; otherwise as
// stream_kernel.
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
  constexpr int kWarps = kThreads / 32;
  constexpr int kSlices = kChunk / kSlice;
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
    const unsigned ballot = __ballot_sync(0xffffffffu, open);
    int base = 0;
    if (lane_id == 0 && ballot != 0) base = atomicAdd(&s_n_open, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (open) s_open[base + __popc(ballot & ((1u << lane_id) - 1u))] = tid;
    __syncthreads();

    // Task g * kSlices + s: rays 32 g .. 32 g + 31 of the list, one a lane,
    // against faces s kSlice .. (s + 1) kSlice - 1 of the cluster.
    const int n_open = s_n_open;
    const int n_tasks = ((n_open + 31) >> 5) * kSlices;
    for (int task = warp; task < n_tasks; task += kWarps) {
      const int g = task / kSlices, slice = task - g * kSlices;
      const int k = (g << 5) + lane_id;
      if (k >= n_open) continue;
      const int i = s_open[k];
      const float4 o4 = s_o[i], d4 = s_d[i];
      float btn = kBig, bdn = 1.0f;
      int bj = -1;
      for (int j0 = slice * kSlice; j0 < (slice + 1) * kSlice; j0 += 4) {
        float4 w[kRows];
#pragma unroll
        for (int kk = 0; kk < kRows; ++kk) {
          w[kk] = *reinterpret_cast<const float4*>(cur + kk * kChunk + j0);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float w00 = lane(w[0], q), w01 = lane(w[1], q), w02 = lane(w[2], q);
          const float w10 = lane(w[3], q), w11 = lane(w[4], q), w12 = lane(w[5], q);
          const float w20 = lane(w[6], q), w21 = lane(w[7], q), w22 = lane(w[8], q);
          const float opx = __fmaf_rn(w02, o4.z, __fmaf_rn(w01, o4.y, __fmaf_rn(w00, o4.x,
                                                                             -lane(w[9], q))));
          const float opy = __fmaf_rn(w12, o4.z, __fmaf_rn(w11, o4.y, __fmaf_rn(w10, o4.x,
                                                                             -lane(w[10], q))));
          const float opz = __fmaf_rn(w22, o4.z, __fmaf_rn(w21, o4.y, __fmaf_rn(w20, o4.x,
                                                                             -lane(w[11], q))));
          const float dpx = __fmaf_rn(w02, d4.z, __fmaf_rn(w01, d4.y, w00 * d4.x));
          const float dpy = __fmaf_rn(w12, d4.z, __fmaf_rn(w11, d4.y, w10 * d4.x));
          const float dpz = __fmaf_rn(w22, d4.z, __fmaf_rn(w21, d4.y, w20 * d4.x));
          const float sgn = dpz >= 0.0f ? 1.0f : -1.0f;
          const float dn = dpz * sgn;
          const float tn = -opz * sgn;
          const float u_n = __fmaf_rn(opx, dn, tn * dpx);
          const float v_n = __fmaf_rn(opy, dn, tn * dpy);
          const bool ok = dn > 1e-12f && u_n >= -kEpsBary * dn && v_n >= -kEpsBary * dn &&
                          u_n + v_n <= (1.0f + kEpsBary) * dn && tn > t_min * dn &&
                          tn < o4.w * dn && tn * bdn < btn * dn;
          if (ok) {
            btn = tn;
            bdn = dn;
            bj = j0 + q;
          }
        }
      }
      if (bj >= 0) {
        const float t = btn / bdn;
        atomicMin(&s_best[i], ((unsigned long long)__float_as_uint(t) << 32) |
                                  (unsigned)(c * kChunk + bj));
      }
    }
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

// rays (B, 3 or 6, R), tmax (B, R), woop (B, 16, tpad), boxes (B, 6, nc) and,
// with kLists, lists (B, R / 2048, nc), counts (B, R / 2048) -> out_t,
// out_prim and, unless null, out_nx/ny/nz/mat and tested (B, R).  R must be a
// multiple of 2048, tpad == nc * 128, and woop 16-byte aligned.
template <bool kGeneral, bool kLists>
int launch_stream(const float* rays, const float* tmax, const float* woop, const float* boxes,
                  const int* lists, const int* counts, float* out_t, int* out_prim, float* out_nx,
                  float* out_ny, float* out_nz, int* out_mat, int* tested, int B, int R, int tpad,
                  int nc, float t_min, int any_hit, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (R % kRayTile != 0 || tpad != nc * kChunk) return (int)cudaErrorInvalidValue;
  if (kLists && (lists == nullptr || counts == nullptr)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(woop) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const bool attrs = out_nx != nullptr;
  if (attrs && (out_ny == nullptr || out_nz == nullptr || out_mat == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(R / kThreads, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kGeneral) {
    stream_general_kernel<kLists><<<grid, kThreads, 0, s>>>(
        rays, tmax, woop, boxes, lists, counts, out_t, out_prim, out_nx, out_ny, out_nz, out_mat,
        tested, R, tpad, nc, t_min, any_hit);
  } else {
    stream_kernel<kLists><<<grid, kThreads, 0, s>>>(
        rays, tmax, woop, boxes, lists, counts, out_t, out_prim, out_nx, out_ny, out_nz, out_mat,
        tested, R, tpad, nc, t_min, any_hit);
  }
  return (int)cudaGetLastError();
}

}  // namespace ff_stream
