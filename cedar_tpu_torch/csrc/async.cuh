// Asynchronous copies from device memory into shared memory (Ampere's
// cp.async, LDGSTS, on Hopper too) for the ring kernels (K12-K16, the edge
// kernel) and K1's resident load: each thread issues element copies that
// complete in the background, groups them with commit_async, and waits for
// all but its N
// newest groups with wait_async<N>; a barrier then publishes them to the
// block.  A copy of `in` false writes zero (source size 0) and reads
// nothing.
#pragma once

#include <cuda_runtime.h>

namespace cedar {

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool in) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte elements");
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"((int)sizeof(T)), "r"(in ? (int)sizeof(T) : 0)
               : "memory");
}

// 16 aligned bytes, through L2 only (K1's resident load)
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 16 aligned bytes, through L2 only, zero-filled (reading nothing) when in
// is false (the edge kernel's rows)
__device__ __forceinline__ void copy_async16(void* dst, const void* src,
                                             bool in) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ask L2 for the line holding *p (a read the kernel makes a few steps on)
template <typename T>
__device__ __forceinline__ void prefetch_l2(const T* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

}  // namespace cedar
