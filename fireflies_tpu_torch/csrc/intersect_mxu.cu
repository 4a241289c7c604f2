// X1: shared-origin Woop closest hit of the reference's matrix-unit
// experiment, for Hopper (sm_90a), with d' = W d on the tensor cores.
//
// Replaces experiments/intersect_mxu.py::intersect_mxu_shared (Pallas body
// `_kernel_mxu`), which the reference keeps beside the renderer, unwired.  On
// the TPU a block of 128 rays x 128 faces forms d' = W d as three K=8
// matmuls on the matrix unit at Precision.HIGHEST (bf16 passes, about float32
// quality).  Here a warp forms it as mma.sync m16n8k8 TF32 tiles (M = 16
// rays, N = 8 faces, K = 8 product slots), in split-TF32 form, the card's
// counterpart of HIGHEST; a single TF32 pass (about three decimal digits)
// would break the rule that geometry stays at float32 quality.  The tensor
// cores' d' filters the pairs; the few that may be hits closer than the
// running best are tested again exactly as the plain version tests them, so
// the kernel returns the plain version's (t, prim) bit for bit.
//
// Split-TF32 products.  hi = cvt.rna.tf32.f32(x) and lo = cvt.rna(x - hi)
// keep 22 of x's 24 bits: |x - hi - lo| <= 2^-22 |x|.  d'_k = sum_i W_ki d_i
// is formed as sum_i (W_hi d_hi + W_hi d_lo + W_lo d_hi): nine products, one
// more than a k8 step holds.  So each ray is first scaled by s = hi(d_x) / d_x
// (1 +- 2^-11; 1 where hi(d_x) = 0): its x component is then a TF32 number,
// d_x's lo part is zero, and the eight remaining products fill one k8 step
// per component:
//     A (rays)  = [dh_x, dh_y, dh_z, dl_y, dl_z, dh_x, dh_y, dh_z]
//     B (faces) = [Wh_x, Wh_y, Wh_z, Wh_y, Wh_z, Wl_x, Wl_y, Wl_z]
// The filter walks in the scaled parameter t~ = t / s (u and v do not
// depend on it).  Three mma.sync a 16 x 8 tile, 24 multiply-adds a pair.
//
// The filter.  With S_k = sum_i |W_ki s d_i|, the tensor cores' d'_k lies
// within c S_k, c = 2^-18, of s times the plain version's float32 d'_k:
//   * the split's products differ from s W d by at most 2^-20 S_k (three lo
//     parts lost, 2^-22 each, and the scaled d_y, d_z rounded);
//   * the tensor cores multiply exactly and add the eight products keeping
//     25 bits below the larger operand of each addition, truncated, then
//     round the sum toward zero (`perf_probe tc_sum` finds this with
//     designed inputs): under 7 x 2^-25 S_k + 2^-23 S_k = 2^-21.5 S_k;
//   * the plain version's three products and two sums, each rounded once:
//     under 3 x 2^-24 S_k.
// Their sum, 1.55 x 2^-20 S_k, leaves a factor 2.6 to c.  S_k is at most
// N_k D, N_k = sum_i |W_ki| (per face), D = max_i |s d_i| (per ray).  To
// first order that moves t by at most eta = c N_z D / |d'_z| relatively, and
// u by at most c D / |d'_z| (|o'_z| N_x + |u - o'_x| N_z), where |u| <= 1 +
// 1e-6 wherever the plain version accepts.  So each face carries
//     H = max(N_z, |o'_z| N_x + 1.5 (2 + |o'_x|) N_z, the same for v)
// (1.5 covers the first-order terms' growth up to e = 1/4 and the
// roundings after d'), and a pair's filter width is e = 2 c D H / |d'_z|.
// A pair goes to the exact test when e > 1/4 (grazing, or d'_z near 0), or
// when its t~, u and v from the tensor cores pass X1's test with every bound
// widened by e: u, v >= -1e-6 - e, u + v <= 1 + 1e-6 + 2e, t~ > 0 (for
// t_min >= 0; t~ has t's sign while e < 1) and t~ (1 - e) < the running
// best / s.  Any pair the plain version accepts with a t below the running
// best passes.  Each thread marks the pairs of a cluster that pass, then
// tests them in the order of its faces, so that a warp runs the exact
// test as often as its busiest lane needs it, not once a pair.  The exact test
// reads the unscaled direction and the face's packed rows and repeats the
// plain version's float32 operations (--fmad=false: none fused; 1 / d'_z an
// IEEE division).  A rejected pair the filter sends on is rejected again, so
// the filter's width changes the time, never the result.
//
// What decides which faces a ray is tested against (results aside):
//   * a block is 128 consecutive rays, four warps of 32; a warp owns two
//     16-ray M tiles and tests a staged cluster when the slab test of any
//     of its live rays passes (__any_sync) with tfar capped at the ray's
//     t_max and running best; dead rays (tmax < 0) and padding do not vote.
//     Each lane votes for one ray, the one whose result it writes;
//   * clusters of 128 faces in index order, only those on the block's list:
//     the clusters some warp's vote opens with tfar capped at t_max alone,
//     found once at the start, one bit a cluster in dynamic shared memory.
//     Each warp copies the rows of its four N tiles of the next listed
//     cluster with cp.async while the block tests the current one, then
//     each lane writes its own fragments, split (hi, lo), into the double
//     buffer in the order the lanes read them, and its face's packed rows
//     and H: one barrier a cluster.  A lane reads its B fragments of the
//     three components as a 16- and an 8-byte load, and each B fragment
//     serves both of the warp's M tiles;
//   * each thread holds d'_x, d'_y, d'_z of four pairs after the three mma
//     (rays g and g+8, faces 2t and 2t+1 of the N tile, g = lane / 4,
//     t = lane % 4), filters them and keeps a running (t, face) per ray
//     from the exact test; ties go to the lowest face, within a thread by
//     visiting order and across the quad by (t, face) in a __shfl_xor_sync
//     reduction at the end;
//   * t_max after the scan: a miss (t = 0, prim = -1) unless the best t is
//     below it.  Any-hit is the same walk (the reference returns the closest
//     hit in both modes), so the C entry point does not take the flag.
// Degenerate and padding faces have all-zero rows: never a hit (padding
// faces' e and t~ are NaN, so the filter passes none of them on).
// `tested`, unless null, gets each live ray's number of clusters its warp
// tested (0 for a dead ray), the count the pair-test bound is taken from.
//
// What bounds it on this card: the FP32 pipe, 15 operations a tested pair
// for the filter (t~, e and its factor, u, v, the widened bounds, u + v,
// the widened t~ and six compares), with the reciprocal on the
// special-function units and 24 TF32 multiply-adds a pair on the tensor
// cores beside it; the exact test adds about 30 operations to the few pairs
// it takes.  The Woop table stays in L2; device memory traffic is the
// directions in and (t, prim) out.

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

using ff_copy::cp_async16;
using ff_copy::cp_async4;
using ff_copy::cp_async_commit;
using ff_copy::cp_async_wait;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // rays a block
constexpr int kMinBlocks = 5;          // blocks an SM: at most 102 registers
constexpr int kChunk = 128;            // faces a cluster
constexpr int kTiles = kChunk / 8;     // N tiles a cluster
constexpr int kRows = 12;              // W0, W1, W2, o'
constexpr int kFacesWarp = kChunk / kWarps;          // faces a warp stages: four N tiles
constexpr int kCopies = kRows * kFacesWarp / 4 / 32;  // 16-byte copies a lane
constexpr float kBig = 3.0e38f;
constexpr float kEpsBary = 1e-6f;
// The filter (see the header): c = 2^-18 bounds |d'_k - s d'_k(plain)| / S_k
// with a factor 2.6 to spare, kFilter = 2 c; kReach = 1.5 covers the
// first-order t error's growth up to e = kWide, beyond which the filter
// sends the pair to the exact test whatever it reads.
constexpr float kFilter = 2.0f * 0x1p-18f;
constexpr float kReach = 1.5f;
constexpr float kWide = 0.25f;

static_assert(kRows * kFacesWarp == 4 * 32 * kCopies, "whole 16-byte copies");

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// d = a b for one 16 x 8 tile, K = 8, FP32 accumulators starting at 0.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ float safe_inv(float x) {
  if (fabsf(x) < 1e-30f) return x < 0.0f ? -1e30f : 1e30f;
  return 1.0f / x;
}

// One cluster in the order the lanes read it: per N tile, each lane's B
// fragments {b0, b1} of d'_x and d'_y (b4) and of d'_z (b2), and per lane
// quad t the o' of faces 2t and 2t+1 {o'x, o'x, o'y, o'y} (o4), {o'z, o'z}
// (o2); and the cluster's box.
struct Stage {
  float4 b4[kTiles][32];
  float2 b2[kTiles][32];
  float4 o4[kTiles][4];
  float2 o2[kTiles][4];
  float h[kTiles][8];      // each face's filter width H (see the header)
  float w[kChunk][9];      // each face's W rows as packed, for the exact test
  float box[6];
};

// X1's test of one pair in the plain version's float32 operations
// (--fmad=false: none fused; 1 / d'_z an IEEE division): the pair's t, or
// kBig unless it is a hit beyond t_min.  Kept out of line: the filter
// sends it few pairs, and the walk's loop stays short.
__device__ __noinline__ float exact_t(const float* w, float dx, float dy, float dz, float opx,
                                      float opy, float opz, float t_min) {
  const float dp0 = w[0] * dx + w[1] * dy + w[2] * dz;
  const float dp1 = w[3] * dx + w[4] * dy + w[5] * dz;
  const float dp2 = w[6] * dx + w[7] * dy + w[8] * dz;
  if (fabsf(dp2) < 1e-12f) return kBig;
  const float t = -opz * (1.0f / dp2);
  const float u = opx + t * dp0;
  const float v = opy + t * dp1;
  const bool hit = u >= -kEpsBary && v >= -kEpsBary && u + v <= 1.0f + kEpsBary && t > t_min;
  return hit ? t : kBig;
}

// The first cluster after c on the block's list (`mask`, `words` words of
// one bit a cluster), or nc past its end.
__device__ __forceinline__ int next_listed(const unsigned* mask, int words, int nc, int c) {
  int w = (c + 1) >> 5;
  if (w >= words) return nc;
  unsigned bits = mask[w] & (0xffffffffu << ((c + 1) & 31));
  while (bits == 0u && ++w < words) bits = mask[w];
  return bits != 0u ? 32 * w + __ffs(bits) - 1 : nc;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
intersect_mxu_kernel(const float* __restrict__ dirs, const float* __restrict__ tmax_in,
                     const float* __restrict__ woop, const float* __restrict__ boxes,
                     float* __restrict__ out_t, int* __restrict__ out_prim,
                     int* __restrict__ tested, int R, int nc, float t_min) {
  // Each warp copies the rows of its own four N tiles: [warp][row][32 faces].
  __shared__ __align__(16) float s_raw[kWarps][kRows][kFacesWarp];
  __shared__ float s_box_raw[6];
  __shared__ Stage s_stage[2];
  extern __shared__ unsigned s_mask[];  // (nc + 31) / 32 words
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int warp_ray0 = blockIdx.x * kThreads + warp * 32;
  const size_t tpad = (size_t)nc * kChunk;
  const float* dir = dirs + (size_t)b * 3 * R;
  const float* w_b = woop + (size_t)b * kRows * tpad;
  const float* box_b = boxes + (size_t)b * 6 * nc;
  const int words = (nc + 31) >> 5;

  // The four rays of this lane's accumulator rows: slot q = 2 m + h is row
  // g + 8 h of M tile m, ray 16 m + 8 h + g of the warp.  Lane (g, t) votes
  // for and writes slot t.  Each ray is scaled so that its x component is a
  // TF32 number, then split; the A fragments take the lane's two K slots, t
  // and t + 4 (see the header).
  uint32_t a_frag[2][4];
  float tmin_s[4], inv_s[4], dmax[4];
  float v_s = 1.0f, v_tmax = -1.0f, v_inv[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = warp_ray0 + 16 * (q >> 1) + 8 * (q & 1) + g;
    const float dx = dir[r], dy = dir[R + r], dz = dir[2 * R + r];
    const uint32_t hx = tf32(dx);
    const float sx = __uint_as_float(hx);
    const float s = sx != 0.0f ? sx / dx : 1.0f;
    const float sy = s * dy, sz = s * dz;
    const uint32_t hy = tf32(sy), hz = tf32(sz);
    const uint32_t ly = tf32(sy - __uint_as_float(hy)), lz = tf32(sz - __uint_as_float(hz));
    // K slots: [dh_x, dh_y, dh_z, dl_y, dl_z, dh_x, dh_y, dh_z]
    const uint32_t k_t = tq == 0 ? hx : tq == 1 ? hy : tq == 2 ? hz : ly;
    const uint32_t k_t4 = tq == 0 ? lz : tq == 1 ? hx : tq == 2 ? hy : hz;
    a_frag[q >> 1][q & 1] = k_t;         // a0 / a1: rows g / g + 8, slot t
    a_frag[q >> 1][2 + (q & 1)] = k_t4;  // a2 / a3: slot t + 4
    tmin_s[q] = t_min / s;
    inv_s[q] = 1.0f / s;
    dmax[q] = fmaxf(fabsf(sx), fmaxf(fabsf(sy), fabsf(sz)));
    if (q == tq) {
      v_s = s;
      v_tmax = tmax_in[(size_t)b * R + r];
      v_inv[0] = safe_inv(sx);
      v_inv[1] = safe_inv(sy);
      v_inv[2] = safe_inv(sz);
    }
  }
  const bool v_live = v_tmax >= 0.0f;
  const float t_floor = t_min >= 0.0f ? 0.0f : -kBig;  // the filter's t bound
  // The tile positions 4 m + p (slot q = 2 m + p / 2) whose ray is live:
  // lane (g, t) holds slot t's liveness, so the quad's four lanes give it.
  unsigned live_pos = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (__shfl_sync(0xffffffffu, v_live, (lane & ~3) | q)) live_pos |= 3u << (2 * q);
  }
  const float v_tmax_s = v_tmax / v_s, v_tmin_s = t_min / v_s;
  const bool warp_dead = !__any_sync(0xffffffffu, v_live);
  // The slab test of this lane's ray against a box, tfar capped at `tfar_cap`.
  auto opens = [&](const float* box, float tfar_cap) {
    const float t0x = box[0] * v_inv[0], t1x = box[3] * v_inv[0];
    const float t0y = box[1] * v_inv[1], t1y = box[4] * v_inv[1];
    const float t0z = box[2] * v_inv[2], t1z = box[5] * v_inv[2];
    const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), v_tmin_s));
    const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), tfar_cap));
    return v_live && tnear <= tfar;
  };

  // The block's list: the clusters some warp opens with tfar capped at t_max
  // alone (the walk's votes, with the running best, open no others).
  for (int w = tid; w < words; w += kThreads) s_mask[w] = 0u;
  __syncthreads();
  if (!warp_dead) {
    for (int c = 0; c < nc; ++c) {
      float box[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) box[k] = __ldg(box_b + (size_t)k * nc + c);
      if (__any_sync(0xffffffffu, opens(box, v_tmax_s)) && lane == 0) {
        atomicOr(&s_mask[c >> 5], 1u << (c & 31));
      }
    }
  }

  // Copy cluster c's rows of this warp's faces, and (warp 0) its box.
  auto copy = [&](int c) {
#pragma unroll
    for (int m = 0; m < kCopies; ++m) {
      const int x = lane + 32 * m, k = x / (kFacesWarp / 4), v = x % (kFacesWarp / 4);
      cp_async16(&s_raw[warp][k][4 * v],
                 w_b + (size_t)k * tpad + (size_t)c * kChunk + warp * kFacesWarp + 4 * v);
    }
    if (tid < 6) cp_async4(&s_box_raw[tid], box_b + (size_t)tid * nc + c);
    cp_async_commit();
  };
  // This warp's four N tiles into stage `st`, each lane writing its own
  // fragments: lane (col, tt) of N tile n takes B slots tt (b0) and tt + 4
  // (b1) of face 8 n + col for each component, the hi part of W_i with
  // i = 0, 1, 2, 1 for tt = 0 .. 3 (b0), and of W_2 (tt = 0) or the lo part
  // of W_0, W_1, W_2 (tt = 1, 2, 3; b1); lanes 0-3 write the o' of faces
  // 2 lane and 2 lane + 1.  Lane f also writes face f's W rows as packed
  // and its filter width.
  auto split = [&](Stage& st) {
    cp_async_wait<0>();
    __syncwarp();
    if (tid < 6) st.box[tid] = s_box_raw[tid];
    const float(*raw)[kFacesWarp] = s_raw[warp];
    const int col = lane >> 2, tt = lane & 3;
    const int i0 = tt == 3 ? 1 : tt, i1 = tt == 0 ? 2 : tt - 1;
#pragma unroll
    for (int nn = 0; nn < kFacesWarp / 8; ++nn) {
      const int n = warp * (kFacesWarp / 8) + nn, f = 8 * nn + col;
      float frag[6];
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const uint32_t h0 = tf32(raw[3 * comp + i0][f]);
        const float w1 = raw[3 * comp + i1][f];
        const uint32_t h1 = tf32(w1);
        frag[2 * comp] = __uint_as_float(h0);
        frag[2 * comp + 1] = __uint_as_float(tt == 0 ? h1 : tf32(w1 - __uint_as_float(h1)));
      }
      st.b4[n][lane] = make_float4(frag[0], frag[1], frag[2], frag[3]);
      st.b2[n][lane] = make_float2(frag[4], frag[5]);
      if (lane < 4) {
        const int f0 = 8 * nn + 2 * lane;
        st.o4[n][lane] = make_float4(raw[9][f0], raw[9][f0 + 1], raw[10][f0], raw[10][f0 + 1]);
        st.o2[n][lane] = make_float2(raw[11][f0], raw[11][f0 + 1]);
      }
    }
    float wf[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      wf[k] = raw[k][lane];
      st.w[warp * kFacesWarp + lane][k] = wf[k];
    }
    const float nx = fabsf(wf[0]) + fabsf(wf[1]) + fabsf(wf[2]);
    const float ny = fabsf(wf[3]) + fabsf(wf[4]) + fabsf(wf[5]);
    const float nz = fabsf(wf[6]) + fabsf(wf[7]) + fabsf(wf[8]);
    const float ox = fabsf(raw[9][lane]), oy = fabsf(raw[10][lane]), oz = fabsf(raw[11][lane]);
    const float hu = oz * nx + kReach * (2.0f + ox) * nz;
    const float hv = oz * ny + kReach * (2.0f + oy) * nz;
    st.h[warp * (kFacesWarp / 8) + (lane >> 3)][lane & 7] = kFilter * fmaxf(nz, fmaxf(hu, hv));
    __syncwarp();  // every lane is done with s_raw before the next copy
  };

  float best_t[4] = {kBig, kBig, kBig, kBig};  // exact: the plain version's t
  float best_s[4] = {kBig, kBig, kBig, kBig};  // the same, scaled: best_t / s
  int best_p[4] = {-1, -1, -1, -1};
  int n_tested = 0;
  const bool block_dead = __syncthreads_and(warp_dead);  // the list is complete
  int c = block_dead ? nc : next_listed(s_mask, words, nc, -1);
  int c_next = c < nc ? next_listed(s_mask, words, nc, c) : nc;
  if (c < nc) {
    copy(c);
    split(s_stage[0]);
    if (c_next < nc) copy(c_next);
    __syncthreads();
  }
  for (int i = 0; c < nc; ++i) {
    const Stage& st = s_stage[i & 1];
    // The exact test of the pairs the filter passed on, each thread's in
    // the order of its faces for each ray: bit 8 n + 4 m + p of `cand` is
    // pair p of M tile m in N tile n (ray slot q = 2 m + p / 2, face 8 n +
    // 2 t + p % 2).
    auto confirm = [&](uint64_t cand, int n0) {
      while (cand != 0u) {
        const int k = __ffsll((long long)cand) - 1;
        cand &= cand - 1;
        const int n = n0 + (k >> 3), p = k & 3, q = 2 * ((k >> 2) & 1) + (p >> 1);
        const int f = 8 * n + 2 * tq + (p & 1);
        const float4 oxy = st.o4[n][tq];
        const float2 oz = st.o2[n][tq];
        const int r = warp_ray0 + 16 * (q >> 1) + 8 * (q & 1) + g;
        const float t = exact_t(st.w[f], __ldg(dir + r), __ldg(dir + R + r),
                                __ldg(dir + 2 * R + r), (p & 1) ? oxy.y : oxy.x,
                                (p & 1) ? oxy.w : oxy.z, (p & 1) ? oz.y : oz.x, t_min);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          if (qq == q && t < best_t[qq]) {
            best_t[qq] = t;
            best_s[qq] = t * inv_s[qq];
            best_p[qq] = c * kChunk + f;
          }
        }
      }
    };
    // The vote: each lane's slab test of its own ray, tfar capped at the
    // ray's t_max and its running best (the quad's minimum of its slot).
    float bq[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bq[q] = fminf(best_s[q], __shfl_xor_sync(0xffffffffu, best_s[q], 1));
      bq[q] = fminf(bq[q], __shfl_xor_sync(0xffffffffu, bq[q], 2));
    }
    const float v_best = tq == 0 ? bq[0] : tq == 1 ? bq[1] : tq == 2 ? bq[2] : bq[3];
    if (__any_sync(0xffffffffu, opens(st.box, fminf(v_tmax_s, v_best)))) {
      ++n_tested;
      uint64_t cand_lo = 0u, cand_hi = 0u;  // N tiles 0-7 and 8-15
#pragma unroll 2
      for (int n = 0; n < kTiles; ++n) {
        const float4 bxy = st.b4[n][lane];
        const float2 bz = st.b2[n][lane];
        const float4 oxy = st.o4[n][tq];
        const float2 oz = st.o2[n][tq];
        const float2 hw = reinterpret_cast<const float2*>(st.h[n])[tq];
        unsigned tile = 0u;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float dpx[4], dpy[4], dpz[4];
          mma_tf32(dpx, a_frag[m], __float_as_uint(bxy.x), __float_as_uint(bxy.y));
          mma_tf32(dpy, a_frag[m], __float_as_uint(bxy.z), __float_as_uint(bxy.w));
          mma_tf32(dpz, a_frag[m], __float_as_uint(bz.x), __float_as_uint(bz.y));
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int q = 2 * m + (p >> 1);  // rows g, g, g + 8, g + 8
            const float opx = (p & 1) ? oxy.y : oxy.x;
            const float opy = (p & 1) ? oxy.w : oxy.z;
            const float opz = (p & 1) ? oz.y : oz.x;
            // X1's test on the tensor cores' d', every bound widened by the
            // filter's e (the header; t > 0 for t > t_min >= 0): a pair the
            // plain version accepts with a t below the running best
            // passes, and goes to the exact test; so does every pair where
            // e is too wide to say.
            const float rz = rcp_approx(dpz[p]);
            const float t = -opz * rz;
            const float e = dmax[q] * ((p & 1) ? hw.y : hw.x) * fabsf(rz);
            const float u = __fmaf_rn(t, dpx[p], opx);
            const float v = __fmaf_rn(t, dpy[p], opy);
            const float lo = -kEpsBary - e;
            const bool near = (u >= lo) & (v >= lo) & (u + v <= __fmaf_rn(2.0f, e, 1.0f + kEpsBary)) &
                              (t > t_floor) & (__fmaf_rn(-t, e, t) < best_s[q]);
            tile |= (near | (e > kWide)) ? 1u << (4 * m + p) : 0u;
          }
        }
        const uint64_t bits = (uint64_t)(tile & live_pos) << (8 * (n & 7));
        if (n < 8) {
          cand_lo |= bits;
        } else {
          cand_hi |= bits;
        }
      }
      confirm(cand_lo, 0);
      confirm(cand_hi, 8);
    }
    const int c_after = c_next < nc ? next_listed(s_mask, words, nc, c_next) : nc;
    if (c_next < nc) {
      split(s_stage[(i + 1) & 1]);
      if (c_after < nc) copy(c_after);
    }
    __syncthreads();
    c = c_next;
    c_next = c_after;
  }

  // The quad's closest hit of each slot, a t-tie to the lowest face.
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ot = __shfl_xor_sync(0xffffffffu, best_t[q], off);
      const int op = __shfl_xor_sync(0xffffffffu, best_p[q], off);
      if (ot < best_t[q] || (ot == best_t[q] && (unsigned)op < (unsigned)best_p[q])) {
        best_t[q] = ot;
        best_p[q] = op;
      }
    }
  }
  const float bt = tq == 0 ? best_t[0] : tq == 1 ? best_t[1] : tq == 2 ? best_t[2] : best_t[3];
  const int bp = tq == 0 ? best_p[0] : tq == 1 ? best_p[1] : tq == 2 ? best_p[2] : best_p[3];
  const bool hit = bp >= 0 && bt < v_tmax;
  const size_t o = (size_t)b * R + warp_ray0 + 16 * (tq >> 1) + 8 * (tq & 1) + g;
  out_t[o] = hit ? bt : 0.0f;
  out_prim[o] = hit ? bp : -1;
  if (tested != nullptr) tested[o] = v_live ? n_tested : 0;
}

}  // namespace

// dirs (B, 3, R), tmax (B, R), woop (B, 12, nc * 128) [W0, W1, W2, o'] 16-byte
// aligned and boxes (B, 6, nc) shifted to the shared origin -> out_t,
// out_prim and, unless null, tested (B, R).  R must be a multiple of 128.
extern "C" int ff_intersect_mxu_shared(const float* dirs, const float* tmax, const float* woop,
                                       const float* boxes, float* out_t, int* out_prim,
                                       int* tested, int B, int R, int nc, float t_min,
                                       void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (R % kThreads != 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(woop) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // The block's cluster list; above the default 48 KB a block may hold, the
  // launch asks for more, up to the card's limit.
  const size_t list_bytes = sizeof(unsigned) * (size_t)((nc + 31) / 32);
  static size_t static_bytes = 0;
  if (static_bytes == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, intersect_mxu_kernel);
    if (err != cudaSuccess) return (int)err;
    static_bytes = attr.sharedSizeBytes;
  }
  if (static_bytes + list_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        intersect_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)list_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(R / kThreads, B);
  intersect_mxu_kernel<<<grid, kThreads, list_bytes, static_cast<cudaStream_t>(stream)>>>(
      dirs, tmax, woop, boxes, out_t, out_prim, tested, R, nc, t_min);
  return (int)cudaGetLastError();
}
