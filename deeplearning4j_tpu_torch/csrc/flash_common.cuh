// Shared pieces of the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): tile sizes, the element types and their rounding,
// and the staging of [rows, D] tiles of a [B*H, T, D] tensor into shared
// memory as float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16: ty owns 4 rows, tx columns
constexpr int kPad4 = kTile + 4;   // row stride of tiles read as float4
constexpr int kPad1 = kTile + 1;   // row stride of tiles read across rows

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// x rounded through T: the reference's astype(v.dtype) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Stage rows r0 .. r0+kTile-1 of src [T, D] (zeros from row T on) into
// dst as float, transposed: dst[d * stride + r].
template <typename T, int D>
__device__ __forceinline__ void stage_t(float* dst, int stride,
                                        const T* __restrict__ src, int r0,
                                        int Tn) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[d * stride + r] =
        r0 + r < Tn ? to_f<T>(src[(size_t)(r0 + r) * D + d]) : 0.0f;
  }
}

// The same rows kept row-major: dst[r * D + d].
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int Tn) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D;
    dst[e] = r0 + r < Tn ? to_f<T>(src[(size_t)r0 * D + e]) : 0.0f;
  }
}

// The sum over the 16 lanes that share a row (lanes ty*16 .. ty*16+15 of
// a warp hold the row's columns), left in every one of them.
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

}  // namespace flash
