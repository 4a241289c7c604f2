// The task machinery of the general-origin kernels that test a ray only
// against the clusters its own slab test opens, for Hopper (sm_90a): the
// streamed general kernels (stream_general_kernel in intersect_stream.cuh,
// B4 and B7g) and the resident Moller-Trumbore kernel (intersect_general.cu,
// B3).  Bounce rays are not coherent, so a vote over a warp or a block opens
// clusters for rays that do not need them; instead:
//   * append_open gathers the block's rays whose slab test opens a staged
//     cluster into that cluster's list (one atomicAdd a warp);
//   * run_tasks splits a batch of staged clusters into tasks of 32 listed
//     (ray, cluster) entries (one a lane) against kSlice faces and lets the
//     block's warps take them in turn, so every warp gets the same share of
//     the open pairs and none idles while others test; the lanes of a task
//     read the same face of one cluster (a broadcast from shared memory), or
//     of two where the task spans the end of one cluster's list;
//   * a task carries its best of kSlice faces as a rational (tn, dn),
//     replaced only when tn bdn < btn dn, and divides once; each ray's
//     closest hit so far is one 64-bit key in shared memory, the bits of t
//     above the face id, lowered with atomicMin, so across slices and
//     clusters the smallest t wins, ties to the lowest face id.  Inside a
//     slice the rational compare decides, so where two faces round to the
//     same t (or nearly) a kernel may keep another face than the plain
//     version's argmin, which takes the lowest id among equal t.
// The pair test is a template argument: a functor that, given kRows float4
// (row k of four consecutive faces), tests lane q's face against a ray and
// returns the rational (tn, dn) of a hit that beats (btn, bdn).  It joins
// its compares with & (no short circuit), so that the test and the update of
// the best hit compile to predicates and selects, not branches.

#pragma once

#include <cuda_runtime.h>

namespace ff_tasks {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 3.0e38f;
constexpr unsigned long long kNoHit = ~0ull;

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Append thread `tid` to `list` when `open`; `count` is the list's length.
// Every lane of the warp calls it.
__device__ __forceinline__ void append_open(bool open, int tid, int lane_id, int* list,
                                            int* count) {
  const unsigned ballot = __ballot_sync(0xffffffffu, open);
  int base = 0;
  if (lane_id == 0 && ballot != 0) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (open) list[base + __popc(ballot & ((1u << lane_id) - 1u))] = tid;
}

// The tasks of a batch of kK staged clusters.  `buf` holds cluster j's
// kRows rows of kChunk faces at buf + (j kRows + k) kChunk; `open` its list
// of threads at open + j kThreads, `n_open[j]` long; `face0(j)` is the id
// of its first face.  s_o and s_d hold each thread's ray (origin and tmax,
// direction); s_best its key.  The caller brackets the call with barriers.
template <int kK, int kChunk, int kSlice, int kRows, class Face0, class Test>
__device__ __forceinline__ void run_tasks(const float* buf, const int* open, const int* n_open,
                                          Face0 face0, const float4* s_o, const float4* s_d,
                                          unsigned long long* s_best, int warp, int lane_id,
                                          const Test& test) {
  constexpr int kSlices = kChunk / kSlice;
  // The batch's lists end to end: entry e of cluster j is e - start[j].  A
  // group of 32 consecutive entries may span two clusters (its lanes then
  // read two faces at once), so only the batch's last group is partly
  // filled, not every cluster's.
  int start[kK + 1];
  start[0] = 0;
#pragma unroll
  for (int j = 0; j < kK; ++j) start[j + 1] = start[j] + n_open[j];
  const int n_tasks = ((start[kK] + 31) >> 5) * kSlices;
  // Task t: entries 32 g .. 32 g + 31, one a lane, against faces
  // s kSlice .. (s + 1) kSlice - 1 of each lane's cluster, with t = g kSlices + s.
  for (int task = warp; task < n_tasks; task += kWarps) {
    const int g = task / kSlices, slice = task - g * kSlices;
    const int e = (g << 5) + lane_id;
    if (e >= start[kK]) continue;
    int j = 0, first = 0;
#pragma unroll
    for (int jj = 1; jj < kK; ++jj) {
      if (e >= start[jj]) {
        j = jj;
        first = start[jj];
      }
    }
    const int i = open[j * kThreads + e - first];
    const float4 o4 = s_o[i], d4 = s_d[i];
    const float* rows = buf + j * kRows * kChunk;
    float btn = kBig, bdn = 1.0f;
    int bj = -1;
    for (int j0 = slice * kSlice; j0 < (slice + 1) * kSlice; j0 += 4) {
      float4 w[kRows];
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        w[kk] = *reinterpret_cast<const float4*>(rows + kk * kChunk + j0);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float tn, dn;
        const bool ok = test(w, q, o4, d4, btn, bdn, tn, dn);
        btn = ok ? tn : btn;  // selects, not branches
        bdn = ok ? dn : bdn;
        bj = ok ? j0 + q : bj;
      }
    }
    if (bj >= 0) {
      const float t = btn / bdn;
      atomicMin(&s_best[i], ((unsigned long long)__float_as_uint(t) << 32) |
                                (unsigned)(face0(j) + bj));
    }
  }
}

}  // namespace ff_tasks
