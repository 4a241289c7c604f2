// The shared body of the four streamed Woop kernels for Hopper (sm_90a):
// intersect_stream_culled.cu (B2) and intersect_stream_general_culled.cu
// (B4) walk per-tile cluster lists; intersect_stream.cu (B7s) and
// intersect_stream_general.cu (B7g) walk every cluster in index order.
//
// A block walks 128-face clusters: with lists (kLists), its 2048-ray tile's
// front-to-back list; without, clusters 0 .. nc - 1.  A cluster's rows of
// the packed Woop table (W rows 0-8, o' or W v0 rows 9-11, the material id
// in row 12) are copied from device memory into one of two shared-memory
// buffers with cp.async, 16 bytes a thread: while the block tests cluster i
// it already copies the next cluster into the other buffer, the card's
// counterpart of the Pallas kernels' DMA double buffer.  The block votes on
// each cluster's slab test (__syncthreads_or); a pruned cluster skips its
// arithmetic but not its copy.  In any-hit mode the block leaves the walk
// once every live ray is blocked or dead (__syncthreads_and), and waits for
// the copy still in flight before it exits, since the shared memory it
// targets is handed to the next block.  `tested`, unless null, gets each
// live ray's number of clusters whose faces its block tested (0 for a dead
// ray), the count that the pair-test bound of a launch is taken from.

#pragma once

#include <cuda_runtime.h>

namespace ff_stream {

constexpr int kThreads = 256;
constexpr int kRayTile = 2048;
constexpr int kChunk = 128;     // faces per streamed cluster
constexpr int kWoopRows = 16;   // rows of the packed table in device memory
constexpr int kCopyRows = 13;   // rows the kernel reads: W, o' or W v0, material
constexpr int kVecPerRow = kChunk / 4;
constexpr int kBufFloats = kCopyRows * kChunk;
constexpr float kBig = 3.0e38f;
constexpr float kEpsBary = 1e-6f;

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

// Start copying cluster c's rows of one variant's table into `buf`; every
// thread commits one group, so cp_async_wait<N> counts clusters.
__device__ __forceinline__ void copy_cluster(float* buf, const float* woop_b, int tpad, int c) {
  for (int i = threadIdx.x; i < kCopyRows * kVecPerRow; i += kThreads) {
    const int k = i / kVecPerRow, q = i - k * kVecPerRow;
    cp_async16(buf + k * kChunk + 4 * q, woop_b + (size_t)k * tpad + (size_t)c * kChunk + 4 * q);
  }
  cp_async_commit();
}

// kGeneral = false: rays (B, 3, R) directions from a shared origin, woop rows
// 9-11 = o' = W (o - v0), boxes origin-shifted.  kGeneral = true: rays
// (B, 6, R) origins then directions, rows 9-11 = W v0 and o'_k = W_k . o -
// (W v0)_k formed per pair, boxes in world space.  kLists = false: lists and
// counts are unused (null).  out_nx .. out_mat may be null (no attributes),
// and so may tested.
template <bool kGeneral, bool kLists>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ rays, const float* __restrict__ tmax_in,
              const float* __restrict__ woop, const float* __restrict__ boxes,
              const int* __restrict__ lists, const int* __restrict__ counts,
              float* __restrict__ out_t, int* __restrict__ out_prim,
              float* __restrict__ out_nx, float* __restrict__ out_ny,
              float* __restrict__ out_nz, int* __restrict__ out_mat,
              int* __restrict__ tested, int R, int tpad, int nc, float t_min, int any_hit) {
  __shared__ __align__(16) float s_w[2 * kBufFloats];
  constexpr int kComp = kGeneral ? 6 : 3;
  const int b = blockIdx.y;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int n_tiles = R / kRayTile;
  const int tile = (blockIdx.x * kThreads) / kRayTile;
  const float* ray = rays + (size_t)b * kComp * R;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (kGeneral) {
    ox = ray[r];
    oy = ray[R + r];
    oz = ray[2 * R + r];
  }
  const float* dir = ray + (size_t)(kComp - 3) * R;
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
  if (n_listed > 0) copy_cluster(s_w, woop_b, tpad, cluster(0));
  for (int ci = 0; ci < n_listed; ++ci) {
    if (any_hit && __syncthreads_and(bp >= 0 || dead)) break;
    const int c = cluster(ci);
    const float* cur = s_w + (ci & 1) * kBufFloats;
    if (ci + 1 < n_listed) {
      // The other buffer was last read before the previous barrier.
      copy_cluster(s_w + ((ci + 1) & 1) * kBufFloats, woop_b, tpad, cluster(ci + 1));
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
        float opx = lane(w[9], q), opy = lane(w[10], q), opz = lane(w[11], q);
        if (kGeneral) {
          opx = w00 * ox + w01 * oy + w02 * oz - opx;
          opy = w10 * ox + w11 * oy + w12 * oz - opy;
          opz = w20 * ox + w21 * oy + w22 * oz - opz;
        }
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
  stream_kernel<kGeneral, kLists><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, tmax, woop, boxes, lists, counts, out_t, out_prim, out_nx, out_ny, out_nz, out_mat,
      tested, R, tpad, nc, t_min, any_hit);
  return (int)cudaGetLastError();
}

}  // namespace ff_stream
