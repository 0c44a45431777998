// cp.async helpers shared by the port's CUDA sources (sm_80 and later).
#pragma once

#include <stdint.h>

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes 16 zero bytes and reads
// nothing (SAME padding, rows past M, k past K)
static __device__ __forceinline__ void cp_async16(uint32_t dst,
                                                  const void* src,
                                                  int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  int src_bytes) {
  cp_async16(smem_u32(dst), src, src_bytes);
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
