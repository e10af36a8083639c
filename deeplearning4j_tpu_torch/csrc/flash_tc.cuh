// Shared pieces of the bf16 tensor-core flash kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the 128-byte-swizzled tile layout that wgmma's
// descriptors read (csrc/hopper_bf16.cuh), cp.async staging into it, the
// packing of f32 accumulators into bf16 register-A fragments, the base-2
// exponential and the reductions over a quad of lanes.
//
// Accumulator layout (m64nN, one warpgroup): lane l of the warpgroup's
// warp w holds rows 16w + l/4 and + 8, columns 8n + 2(l%4), +1, in
// d[4n], d[4n+1] (row 16w + l/4) and d[4n+2], d[4n+3] (row + 8). Two
// neighbouring n8 blocks n = 2t, 2t + 1 of such an accumulator, packed
// to bf16 pairs, are the A-fragment of k16 step t that the register-A
// wgmma takes (hopper_bf16.cuh wgmma_m64n*k16_rs): pack_a does that.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace flash_tc {

using mma_bf16::bf16;
using mma_bf16::cp_async16;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element offset of 16-byte chunk c of row r in a [R][D] bf16 tile kept as
// D/64 column blocks of [R][64]: 128-byte rows whose chunks are XOR-ed
// with the row mod 8, the 128-byte-swizzle layout of wgmma's descriptors
// (and conflict-free for the epilogues' 4- and 16-byte accesses).
template <int R>
__device__ __forceinline__ int sw128(int r, int c) {
  return (c / 8) * R * 64 + r * 64 + (((c % 8) ^ (r & 7)) << 3);
}

// rows r0 .. r0 + R - 1 of src [T, D] into dst by the block's kThreads
// threads, zeros from row T on
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int Tn) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < Tn;
    cp_async16(dst + sw128<R>(r, c),
               ok ? src + (size_t)(r0 + r) * D + c * 8 : src, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The eight n8 blocks of an m64n64 accumulator x as the four register-A
// fragments of a k = 64 product (rounded to bf16, nearest even).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float* x) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    a[n / 2][(n % 2) * 2] = pack_bf16(x[4 * n], x[4 * n + 1]);
    a[n / 2][(n % 2) * 2 + 1] = pack_bf16(x[4 * n + 2], x[4 * n + 3]);
  }
}

// 2^x on the SFU (ex2.approx, relative error ~2^-22; results below 2^-126
// flush to 0, far under what bf16 p or the f32 sum l can hold)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keeps the compiler from moving reads or writes of register-A fragments
// across the asynchronous products' fence and wait (hopper::fence_regs
// for the accumulators).
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[t][i])::"memory");
}

}  // namespace flash_tc
