// Flash-attention backward (non-causal, no bias) for Hopper, sm_90a.
//
// Replaces the two backward Pallas kernels of
// jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0), which its
// custom_vjp (_flash_attention_bwd, :254) launches under BertTrainer:
//
// - flash_attn_bwd_dkv_{f32,bf16}: _flash_attention_bwd_dkv (:941,
//   pallas_call :1121, body _flash_attention_dkv_kernel :796), preceded
//   by the di pass the VJP computes in XLA (:273);
// - flash_attn_bwd_dq_{f32,bf16}: _flash_attention_bwd_dq (:1287,
//   pallas_call :1456, body _flash_attention_dq_kernel :1146).
//
//   q, k, v, o, do [B*H, T, D], m, l [B*H, T] f32 (the forward's) ->
//   di = rowsum(o do) (f32);  p = exp(s - m) (1/l), s = (q k^T) sm_scale
//   dv = p^T do;  dp = do v^T;  ds = (dp - di) p sm_scale
//   dk = ds^T q;  dq = ds k
//
// with p and ds rounded to the inputs' type before the products that take
// them, as the reference rounds them (p.T.astype(do.dtype), ds.astype),
// every sum in f32, and dq, dk, dv written in the inputs' type.
//
// What bounds it on this card. 10*B*H*T^2*D operations (the two score
// products again, and dv, dp, dk, dq) against the bytes of q, k, v, o,
// do, dq, dk and dv: at BERT-base's B=16, H=12, T=512, D=64 that is 32.2
// GFLOP against 101 MB in bf16, 0.033 ms on the bf16 tensor cores and
// 0.030 ms at 3.35 TB/s. These kernels multiply on the plain f32 pipe
// (0.48 ms at 67 TFLOP/s), so operations and shared-memory reads bound
// them; wgmma and TMA are later work.
//
// Design. The TPU kernels walk a sequential grid axis, carrying dk, dv or
// dq in VMEM scratch. Here, as there, two kernels: one block owns a tile
// of 64 key rows (dkv) or 64 query rows (dq) of one b*h and loops over
// the other side's tiles itself, so every output element is summed by one
// thread in a fixed order: no atomics, and two runs give the same bits.
// - 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 of the
//   block's tile and columns tx + 16c of the 64 x 64 score tile, and, in
//   the products into dk, dv or dq, columns tx + 16c (c < D/16) of D.
// - The block's own tiles stay in shared memory (transposed, as float, a
//   row stride of 68 so that a thread's four rows are one float4); the
//   other side's tiles are staged transposed with a stride of 65, so that
//   the D-column reads of the second products do not collide in a bank.
// - s and dp share one loop over d; p and ds go through shared memory,
//   rounded to the inputs' type, to the second products.
// - di: one warp per row, before the dkv kernel, into a [B*H, T] f32
//   buffer that the dq kernel reads too.
// - Rows from T on are staged as zeros, their p is set to 0, and no
//   output row from T on is written. Any T >= 1; D is 64 or 128.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_di_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ di, int rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f<T>(o[(size_t)row * D + d]),
               to_f<T>(dout[(size_t)row * D + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[row] = acc;
}

template <int D>
constexpr size_t bwd_smem_floats() {
  // own tiles [D][kPad4] x 2, other side [D][kPad1] x 2, and the dkv
  // kernel's two [kTile][kPad4] p and ds tiles (the dq kernel uses one)
  return (size_t)D * kPad4 * 2 + (size_t)D * kPad1 * 2 +
         (size_t)kTile * kPad4 * 2;
}

// One block: key rows kr0 .. kr0+63 of one b*h; loops over query tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ di, T* __restrict__ dk,
                 T* __restrict__ dv, int Tn, float scale) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);   // [D][kPad4]
  float* v_s = k_s + D * kPad4;                    // [D][kPad4]
  float* q_s = v_s + D * kPad4;                    // [D][kPad1]
  float* do_s = q_s + D * kPad1;                   // [D][kPad1]
  float* p_s = do_s + D * kPad1;                   // [kTile][kPad4]
  float* ds_s = p_s + kTile * kPad4;               // [kTile][kPad4]
  __shared__ float m_s[kTile], li_s[kTile], di_s[kTile];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t base = (size_t)blockIdx.x * Tn * D;
  const size_t rbase = (size_t)blockIdx.x * Tn;
  const int kr0 = blockIdx.y * kTile;

  stage_t<T, D>(k_s, kPad4, k + base, kr0, Tn);
  stage_t<T, D>(v_s, kPad4, v + base, kr0, Tn);

  float acc_k[4][C], acc_v[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  for (int q0 = 0; q0 < Tn; q0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    stage_t<T, D>(q_s, kPad1, q + base, q0, Tn);
    stage_t<T, D>(do_s, kPad1, dout + base, q0, Tn);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool ok = q0 + r < Tn;
      m_s[r] = ok ? m[rbase + q0 + r] : 0.0f;
      li_s[r] = ok ? 1.0f / l[rbase + q0 + r] : 0.0f;
      di_s[r] = ok ? di[rbase + q0 + r] : 0.0f;
    }
    __syncthreads();

    // s[i][c] = k_i . q_c, dp[i][c] = v_i . do_c (key row i, query c)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 ka = *reinterpret_cast<const float4*>(
          k_s + d * kPad4 + 4 * ty);
      const float4 va = *reinterpret_cast<const float4*>(
          v_s + d * kPad4 + 4 * ty);
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
      const float vv[4] = {va.x, va.y, va.z, va.w};
      float qv[4], dov[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        qv[c] = q_s[d * kPad1 + tx + 16 * c];
        dov[c] = do_s[d * kPad1 + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(kv[i], qv[c], s[i][c]);
          dp[i][c] = fmaf(vv[i], dov[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = tx + 16 * c;
        const float p = q0 + qc < Tn
                            ? expf(s[i][c] * scale - m_s[qc]) * li_s[qc]
                            : 0.0f;
        const float ds = (dp[i][c] - di_s[qc]) * p * scale;
        p_s[(4 * ty + i) * kPad4 + qc] = round_to<T>(p);
        ds_s[(4 * ty + i) * kPad4 + qc] = round_to<T>(ds);
      }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dov[C], qv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dov[c] = do_s[(tx + 16 * c) * kPad1 + j];
        qv[c] = q_s[(tx + 16 * c) * kPad1 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(4 * ty + i) * kPad4 + j];
        const float ds = ds_s[(4 * ty + i) * kPad4 + j];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc_v[i][c] = fmaf(p, dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds, qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kr0 + 4 * ty + i;
    if (row >= Tn) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t at = base + (size_t)row * D + tx + 16 * c;
      dk[at] = from_f<T>(acc_k[i][c]);
      dv[at] = from_f<T>(acc_v[i][c]);
    }
  }
}

// One block: query rows qr0 .. qr0+63 of one b*h; loops over key tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ di, T* __restrict__ dq, int Tn,
                float scale) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // [D][kPad4]
  float* do_s = q_s + D * kPad4;                   // [D][kPad4]
  float* k_s = do_s + D * kPad4;                   // [D][kPad1]
  float* v_s = k_s + D * kPad1;                    // [D][kPad1]
  float* ds_s = v_s + D * kPad1;                   // [kTile][kPad4]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t base = (size_t)blockIdx.x * Tn * D;
  const size_t rbase = (size_t)blockIdx.x * Tn;
  const int qr0 = blockIdx.y * kTile;

  stage_t<T, D>(q_s, kPad4, q + base, qr0, Tn);
  stage_t<T, D>(do_s, kPad4, dout + base, qr0, Tn);
  float m_r[4], li_r[4], di_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qr0 + 4 * ty + i;
    const bool ok = row < Tn;
    m_r[i] = ok ? m[rbase + row] : 0.0f;
    li_r[i] = ok ? 1.0f / l[rbase + row] : 0.0f;
    di_r[i] = ok ? di[rbase + row] : 0.0f;
  }

  float acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < Tn; k0 += kTile) {
    __syncthreads();
    stage_t<T, D>(k_s, kPad1, k + base, k0, Tn);
    stage_t<T, D>(v_s, kPad1, v + base, k0, Tn);
    __syncthreads();

    // s[i][c] = q_i . k_c, dp[i][c] = do_i . v_c (query row i, key c)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(
          q_s + d * kPad4 + 4 * ty);
      const float4 da = *reinterpret_cast<const float4*>(
          do_s + d * kPad4 + 4 * ty);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float dov[4] = {da.x, da.y, da.z, da.w};
      float kv[4], vv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = k_s[d * kPad1 + tx + 16 * c];
        vv[c] = v_s[d * kPad1 + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const float p = k0 + kc < Tn
                            ? expf(s[i][c] * scale - m_r[i]) * li_r[i]
                            : 0.0f;
        ds_s[(4 * ty + i) * kPad4 + kc] =
            round_to<T>((dp[i][c] - di_r[i]) * p * scale);
      }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float kv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = k_s[(tx + 16 * c) * kPad1 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(4 * ty + i) * kPad4 + j];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qr0 + 4 * ty + i;
    if (row >= Tn) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dq[base + (size_t)row * D + tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch_dkv(const T* q, const T* k, const T* v, const T* o,
               const T* dout, const float* m, const float* l, float* di,
               T* dk, T* dv, int BH, int Tn, float scale, cudaStream_t st) {
  const int rows = BH * Tn;
  flash_di_kernel<T, D><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                          kThreads, 0, st>>>(o, dout, di, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_smem_floats<D>() * sizeof(float);
  err = (cudaError_t)set_smem(flash_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (Tn + kTile - 1) / kTile);
  flash_dkv_kernel<T, D><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, m, l, di, dk, dv, Tn, scale);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const T* q, const T* k, const T* v, const T* dout,
              const float* m, const float* l, const float* di, T* dq,
              int BH, int Tn, float scale, cudaStream_t st) {
  const size_t smem =
      (bwd_smem_floats<D>() - (size_t)kTile * kPad4) * sizeof(float);
  cudaError_t err = (cudaError_t)set_smem(flash_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (Tn + kTile - 1) / kTile);
  flash_dq_kernel<T, D><<<grid, kThreads, smem, st>>>(q, k, v, dout, m, l,
                                                      di, dq, Tn, scale);
  return cudaGetLastError();
}

template <typename T>
int run_dkv(const T* q, const T* k, const T* v, const T* o, const T* dout,
            const float* m, const float* l, float* di, T* dk, T* dv, int BH,
            int Tn, int D, float scale, cudaStream_t st) {
  if (BH < 1 || Tn < 1) return -3;
  if (D == 64)
    return launch_dkv<T, 64>(q, k, v, o, dout, m, l, di, dk, dv, BH, Tn,
                             scale, st);
  if (D == 128)
    return launch_dkv<T, 128>(q, k, v, o, dout, m, l, di, dk, dv, BH, Tn,
                              scale, st);
  return -1;
}

template <typename T>
int run_dq(const T* q, const T* k, const T* v, const T* dout,
           const float* m, const float* l, const float* di, T* dq, int BH,
           int Tn, int D, float scale, cudaStream_t st) {
  if (BH < 1 || Tn < 1) return -3;
  if (D == 64)
    return launch_dq<T, 64>(q, k, v, dout, m, l, di, dq, BH, Tn, scale, st);
  if (D == 128)
    return launch_dq<T, 128>(q, k, v, dout, m, l, di, dq, BH, Tn, scale,
                             st);
  return -1;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: a head size other than 64 or 128; -3: an empty dimension.
// dkv: the di pass into di [B*H, T], then dk and dv.
extern "C" int flash_attn_bwd_dkv_f32(const float* q, const float* k,
                                      const float* v, const float* o,
                                      const float* dout, const float* m,
                                      const float* l, float* di, float* dk,
                                      float* dv, int BH, int Tn, int D,
                                      float scale, void* stream) {
  return run_dkv<float>(q, k, v, o, dout, m, l, di, dk, dv, BH, Tn, D,
                        scale, (cudaStream_t)stream);
}

extern "C" int flash_attn_bwd_dkv_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* m,
    const float* l, float* di, __nv_bfloat16* dk, __nv_bfloat16* dv, int BH,
    int Tn, int D, float scale, void* stream) {
  return run_dkv<__nv_bfloat16>(q, k, v, o, dout, m, l, di, dk, dv, BH, Tn,
                                D, scale, (cudaStream_t)stream);
}

// dq, from the di the dkv entry wrote.
extern "C" int flash_attn_bwd_dq_f32(const float* q, const float* k,
                                     const float* v, const float* dout,
                                     const float* m, const float* l,
                                     const float* di, float* dq, int BH,
                                     int Tn, int D, float scale,
                                     void* stream) {
  return run_dq<float>(q, k, v, dout, m, l, di, dq, BH, Tn, D, scale,
                       (cudaStream_t)stream);
}

extern "C" int flash_attn_bwd_dq_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* dout, const float* m, const float* l,
    const float* di, __nv_bfloat16* dq, int BH, int Tn, int D, float scale,
    void* stream) {
  return run_dq<__nv_bfloat16>(q, k, v, dout, m, l, di, dq, BH, Tn, D,
                               scale, (cudaStream_t)stream);
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
