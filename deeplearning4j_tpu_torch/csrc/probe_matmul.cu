// bf16 matrix product with f32 sums on Hopper's tensor cores, sm_90a.
//
// Replaces the Pallas kernel of tools/probe_matmul.py (bench_pallas,
// pallas_call at :62, body `kern` :56):
//
//   a [M, K] bf16, b [K, N] bf16  ->  out [M, N] = bf16(a b), f32 sums.
//
// The TPU kernel walks a grid over blocks of bm rows of a, with b resident
// in VMEM; bm is a blocking knob that does not change the result. Here a
// block of 256 threads owns a 64..256 x 256..64 output tile (the warp
// layout of csrc/mma_bf16.cuh, by N) and streams K in chunks of 32 through
// a two-deep cp.async ring of a and b, multiplying with mma.sync m16n8k16
// (bf16 in, f32 accumulators); the f32 sums are rounded to bf16 once.
//
// What bounds it on this card: 2MKN operations against the bytes of a, b
// and out. At the probe's largest shape (50176, 1024, 256): 26.3 GFLOP,
// 0.027 ms at 989 TFLOP/s, against 129 MB, 0.039 ms at 3.35 TB/s, so
// bytes. mma.sync tops out well below wgmma's rate and a two-stage ring
// hides little latency: a first, simple kernel; wgmma and TMA are later
// work.
//
// M is any size (rows past M are staged as zeros and not written); K and
// N are multiples of 16, which the wrapper checks.

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

struct RowsOf {
  int m0, M;
  __device__ long long operator()(int r) const {
    return m0 + r < M ? m0 + r : -1;
  }
};

__global__ void __launch_bounds__(kThreads)
probe_matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ float4 smem4[];
  const Tile t(N);
  const WarpPos w(t);
  bf16* b_ring = reinterpret_cast<bf16*>(smem4);
  bf16* a_ring = b_ring + b_ring_bytes(t.nb) / sizeof(bf16);
  const int m0 = blockIdx.x * t.mb, n0 = blockIdx.y * t.nb;

  StagedA<RowsOf> asrc{a, K, K, a_ring, RowsOf{m0, M}, {false, false}};
  asrc.valid[0] = m0 + w.row < M;
  asrc.valid[1] = m0 + w.row + 16 < M;

  float acc[2][8][4];
  block_gemm(acc, asrc, b, N, K, n0, N, t, w, b_ring);
  for_each_pair(acc, w, [&](int r, int c, float v0, float v1) {
    if (m0 + r < M && n0 + c < N)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(m0 + r) * N + n0 +
                                         c) = __floats2bfloat162_rn(v0, v1);
  });
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: K or N not a multiple of 16; -3: an empty dimension.
extern "C" int probe_matmul_bf16(const bf16* a, const bf16* b, bf16* out,
                                 int M, int K, int N, void* stream) {
  if (M < 1 || K < 1 || N < 1) return -3;
  if (K % 16 || N % 16) return -1;
  const Tile t(N);
  const int smem = b_ring_bytes(t.nb) + a_ring_bytes(t.mb);
  cudaError_t err = cudaFuncSetAttribute(
      probe_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + t.mb - 1) / t.mb, (N + t.nb - 1) / t.nb);
  probe_matmul_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      a, b, out, M, K, N);
  return cudaGetLastError();
}

extern "C" const char* probe_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
