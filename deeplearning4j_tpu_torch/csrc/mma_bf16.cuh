// bf16 staging helpers for the bf16 flash kernels (through
// csrc/flash_tc.cuh): cp.async 16-byte copies global -> shared, their
// commit groups and waits. (The block-level mma.sync product that once
// lived here went with the bottleneck kernel that used it:
// csrc/fused_bottleneck.cu runs on wgmma, csrc/hopper_bf16.cuh.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !pred (src unread).
__device__ inline void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma_bf16
