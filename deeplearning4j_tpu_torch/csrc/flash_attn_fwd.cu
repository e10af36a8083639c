// Flash-attention forward (non-causal, no bias) for Hopper, sm_90a.
//
// Replaces the forward of jax.experimental.pallas.ops.tpu.flash_attention
// (jax 0.9.0: _flash_attention_impl, pallas_call at flash_attention.py:758,
// body _flash_attention_kernel :331), which deeplearning4j_tpu/models/
// bert.py reaches at :34 and :197 with causal=False and sm_scale = 1/sqrt(D):
//
//   q, k, v [B*H, T, D] (f32 or bf16)  ->  o [B*H, T, D] (same type),
//   and for training m, l [B*H, T] f32:
//   s = (q k^T) sm_scale (f32 sums);  m = rowmax s;  l = rowsum exp(s - m)
//   o = (exp(s - m) rounded to v's type) v / l
//
// Two entries per type: flash_attn_fwd_{f32,bf16} with save = 1 writes m
// and l (the training forward), save = 0 only o (inference).
//
// What bounds it on this card. 4*B*H*T^2*D operations against the bytes
// of q, k, v and o: at BERT-base's B=16, H=12, T=512, D=64 that is 12.9
// GFLOP against 50 MB in bf16, 0.013 ms on the bf16 tensor cores (989
// TFLOP/s) and 0.015 ms at 3.35 TB/s. This kernel multiplies on the
// plain f32 pipe (67 TFLOP/s, 0.19 ms), so operations and shared-memory
// reads bound it: a first, simple kernel; wgmma and TMA are later work.
//
// Design. The TPU kernel walks the key blocks in a sequential grid axis,
// carrying the running max, sum and accumulator in VMEM scratch. Here one
// block owns one (b*h, tile of 64 query rows) and loops over 64-key tiles
// itself (blocks run in any order, so nothing carries between them):
// - q's tile stays in shared memory (transposed, as float); each key tile
//   stages k (transposed) and v (row-major) beside it.
// - 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3,
//   score columns tx + 16c (c < 4) and output columns tx + 16c (c < D/16),
//   so its 4 x 4 score tile reads one float4 of q and four words of k per
//   d, and the row max and sum need shuffles among the 16 lanes of a row.
// - Online softmax in f32: m_new = max(m, tile max), alpha = exp(m -
//   m_new), l = rowsum p + alpha l; the accumulator is scaled by alpha and
//   takes p v, with p rounded to v's type first, as the reference rounds p
//   before its p.v product. o is written from the f32 accumulator once, at
//   the end (acc * (1/l)).
// - Key columns from T on are masked to -inf before the max; q, k and v
//   rows from T on are staged as zeros. Any T >= 1; D is 64 or 128.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t fwd_smem_floats() {
  // q_s [D][kPad4], k_s [D][kPad4], v_s [kTile][D], p_s [kTile][kPad4]
  return (size_t)D * kPad4 * 2 + (size_t)kTile * D + (size_t)kTile * kPad4;
}

template <typename T, int D, bool kSave>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int Tn, float scale) {
  constexpr int C = D / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [D][kPad4]
  float* k_s = q_s + D * kPad4;                    // [D][kPad4]
  float* v_s = k_s + D * kPad4;                    // [kTile][D]
  float* p_s = v_s + kTile * D;                    // [kTile][kPad4]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t base = (size_t)blockIdx.x * Tn * D;
  const int q0 = blockIdx.y * kTile;

  stage_t<T, D>(q_s, kPad4, q + base, q0, Tn);

  float m_run[4], l_run[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < Tn; k0 += kTile) {
    __syncthreads();   // the previous tile's readers of k_s, v_s are done
    stage_t<T, D>(k_s, kPad4, k + base, k0, Tn);
    stage<T, D>(v_s, v + base, k0, Tn);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          q_s + d * kPad4 + 4 * ty);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[d * kPad4 + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = k0 + tx + 16 * c < Tn ? s[i][c] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m_run[i], row_max16(mx));
      float ps = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        ps += p;
        p_s[(4 * ty + i) * kPad4 + tx + 16 * c] = round_to<T>(p);
      }
      const float alpha = expf(m_run[i] - m_new);
      l_run[i] = row_sum16(ps) + alpha * l_run[i];
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = v_s[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(4 * ty + i) * kPad4 + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Tn) continue;
    const float inv = 1.0f / l_run[i];
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[base + (size_t)row * D + tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (kSave && tx == 0) {
      m_out[(size_t)blockIdx.x * Tn + row] = m_run[i];
      l_out[(size_t)blockIdx.x * Tn + row] = l_run[i];
    }
  }
}

template <typename T, int D, bool kSave>
int launch(const T* q, const T* k, const T* v, T* o, float* m, float* l,
           int BH, int Tn, float scale, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, D, kSave>;
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (Tn + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, o, m, l, Tn, scale);
  return cudaGetLastError();
}

template <typename T>
int run(const T* q, const T* k, const T* v, T* o, float* m, float* l,
        int BH, int Tn, int D, float scale, int save, cudaStream_t st) {
  if (BH < 1 || Tn < 1) return -3;
  if (D == 64)
    return save ? launch<T, 64, true>(q, k, v, o, m, l, BH, Tn, scale, st)
                : launch<T, 64, false>(q, k, v, o, m, l, BH, Tn, scale, st);
  if (D == 128)
    return save ? launch<T, 128, true>(q, k, v, o, m, l, BH, Tn, scale, st)
                : launch<T, 128, false>(q, k, v, o, m, l, BH, Tn, scale, st);
  return -1;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: a head size other than 64 or 128; -3: an empty dimension.
extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v, float* o, float* m,
                                  float* l, int BH, int Tn, int D,
                                  float scale, int save, void* stream) {
  return run<float>(q, k, v, o, m, l, BH, Tn, D, scale, save,
                    (cudaStream_t)stream);
}

extern "C" int flash_attn_fwd_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o,
                                   float* m, float* l, int BH, int Tn, int D,
                                   float scale, int save, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, m, l, BH, Tn, D, scale, save,
                            (cudaStream_t)stream);
}

extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
