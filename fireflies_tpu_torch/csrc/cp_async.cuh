// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), for the kernels that stage the next clusters while they
// test the current ones.  Each thread commits its own groups, so
// cp_async_wait<N> lets the N most recent groups of the thread stay in
// flight; a barrier after the wait makes every thread's copies visible.

#pragma once

#include <cuda_runtime.h>

namespace ff_copy {

// 16 bytes; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// One float.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ff_copy
