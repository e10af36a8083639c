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
// and l (the training forward), save = 0 only o (inference). m and l are
// what csrc/flash_attn_bwd.cu recomputes p = exp(s - m) / l from, so m is
// stored in the natural units of s whatever base the kernel exponentiates
// in. flash_attn_fwd_plan gives a launch's plan without launching.
//
// What bounds it on this card. 4*B*H*T^2*D operations against the bytes
// of q, k, v and o: at BERT-base's B=16, H=12, T=512, D=64 that is 12.9
// GFLOP against 50 MB in bf16, 0.013 ms on the bf16 tensor cores (989
// TFLOP/s) and 0.015 ms at 3.35 TB/s.
//
// bf16: the tensor-core kernel (FlashAttention-2's loop on wgmma). The
// first, SIMT kernel multiplied on the f32 pipe (67 TFLOP/s, 0.19 ms at
// least) and ran at 0.51 ms back to back at BERT's shape. Here:
// - a block of two warpgroups owns 128 query rows of one b*h, 64 rows a
//   warpgroup; each k and v tile it stages feeds both. At BERT's shape
//   (192 heads, T = 512) that makes 768 blocks of 65 KB (D=64).
// - q's tile stays in shared memory as wgmma's A operand; k and v tiles
//   of 64 keys come through a three-stage cp.async ring (rows past T
//   arrive as zeros), in the 128-byte-swizzle layout that wgmma's
//   descriptors read (hopper_bf16.cuh), behind a proxy fence.
// - s = q k^T is wgmma m64n64k16 (bf16 in, f32 sums in registers), k the
//   K-major B operand; the online softmax runs on the accumulator
//   registers, base 2 with the scale folded by log2(e): the row max and
//   sum are shuffles among the 4 lanes of a quad. Key columns from T on
//   are -inf before the max.
// - p never goes through shared memory: two neighbouring n8 blocks of the
//   s accumulator are one A-fragment, so p, rounded to bf16 at the tile's
//   running max, is wgmma's register A operand for o += p v, v the
//   MN-major B operand (transpose-B). l sums the unrounded f32 p, as the
//   reference does.
// - o is written once, acc * (1/l) rounded to bf16, staged through the
//   warp's own rows of q's tile for 16-byte stores; rows from T on are not
//   written.
// Measured on the H100 back to back at 16/12/512/64
// (scripts/flash_matmul_ab.py): 0.0535 ms. The same loop on mma.sync
// (8 warps of 16 rows, k and v read through ldmatrix by every warp) ran
// 0.0667 with a three-stage ring and 8 warps, 0.0725 with two stages and
// 4 warps; SDPA 0.039. What bounds it now, by estimate: each warpgroup
// waits for its products before its softmax and the softmax before its
// next products (FlashAttention-3 overlaps the two across warpgroups);
// the exponentials (50 M, ~0.014 ms on the SFU) are in that chain.
//
// f32: the SIMT kernel, unchanged. The reference computes in float32, and
// a tensor-core f32 product would be TF32. One block owns one (b*h, tile
// of 64 query rows) and loops over 64-key tiles:
// - q's tile stays in shared memory (transposed, as float); each key tile
//   stages k (transposed) and v (row-major) beside it.
// - 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3,
//   score columns tx + 16c (c < 4) and output columns tx + 16c (c < D/16).
// - Online softmax in f32 (natural base), p rounded to v's type before
//   p v, as the reference rounds p before its p.v product.
// Any T >= 1; D is 64 or 128.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "hopper_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

using namespace flash_tc;

constexpr int kWgs = 2;                  // warpgroups of a block
constexpr int kRows = 64 * kWgs;         // query rows of a block
constexpr int kThreadsTc = 128 * kWgs;
constexpr int kKeys = 64;                // keys of a tile
constexpr int kStages = 3;               // k and v tiles in the ring

// q's tile and the ring, 1 KB to align them to 1024 bytes
template <int D>
constexpr int smem_bytes() {
  return (kRows * D + kStages * 2 * kKeys * D) * (int)sizeof(bf16) + 1024;
}

// A warpgroup owns 64 query rows. The m64n64 accumulator of s and the
// m64nD accumulator of o hold, in lane l of the warpgroup's warp w, rows
// 16w + l/4 and + 8 and columns 8n + 2(l%4), +1: s[4n], s[4n+1] and
// s[4n+2], s[4n+3]. Two neighbouring n8 blocks of s are one A-fragment of
// m16n8k16 for the warp's rows, which is what the register-A wgmma takes.
template <int D, bool kSave>
__global__ void __launch_bounds__(kThreadsTc)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             float* __restrict__ m_out, float* __restrict__ l_out, int Tn,
             float scale) {
  using namespace hopper;
  constexpr int ND = D / 8;    // n8 column blocks of o
  extern __shared__ uint8_t smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* kv_s = q_s + kRows * D;   // stages of k, v [kKeys][D]

  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.x * Tn * D;
  const int q0 = blockIdx.y * kRows;
  const int tiles = (Tn + kKeys - 1) / kKeys;
  const float scale2 = scale * kLog2e;

  auto load_kv = [&](int j) {
    bf16* ks = kv_s + (j % kStages) * 2 * kKeys * D;
    load_rows<D, kKeys, kThreadsTc>(ks, k + base, j * kKeys, Tn);
    load_rows<D, kKeys, kThreadsTc>(ks + kKeys * D, v + base, j * kKeys,
                                    Tn);
  };
  load_rows<D, kRows, kThreadsTc>(q_s, q + base, q0, Tn);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load_kv(j);
    cp_async_commit();
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;

  for (int j = 0; j < tiles; ++j) {
    if (j + kStages - 1 < tiles) load_kv(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    fence_proxy_async();   // the tile's cp.async writes, to wgmma's reads
    __syncthreads();
    const bf16* ks = kv_s + (j % kStages) * 2 * kKeys * D;
    const uint32_t k_addr = smem_u32(ks);
    const uint32_t v_addr = smem_u32(ks + kKeys * D);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(
          s,
          wgmma_desc(q_addr + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16,
                     1024),
          wgmma_desc(k_addr + (kk / 4) * kKeys * 128 + (kk % 4) * 32, 16,
                     1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(s);

    const int key0 = j * kKeys + 2 * (lane % 4);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * n + e];
        x = key0 + 8 * n + (e & 1) < Tn ? x * scale2 : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = ex2(m_run[h] - mx[h]);
      m_run[h] = mx[h];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = ex2(s[4 * n] - mx[0]), p1 = ex2(s[4 * n + 1] - mx[0]);
      const float p2 = ex2(s[4 * n + 2] - mx[1]);
      const float p3 = ex2(s[4 * n + 3] - mx[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l_run[h] = alpha[h] * l_run[h] + quad_sum(ps[h]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[4 * n] *= alpha[0];
      acc[4 * n + 1] *= alpha[0];
      acc[4 * n + 2] *= alpha[1];
      acc[4 * n + 3] *= alpha[1];
    }
    fence_regs<D / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {   // keys 16 t .. 16 t + 15
      const uint64_t dv = wgmma_desc(v_addr + t * 2048, kKeys * 128, 1024);
      if constexpr (D == 64)
        wgmma_m64n64k16_rs<1>(acc, pa[t], dv, 1);
      else
        wgmma_m64n128k16_rs<1>(acc, pa[t], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);
    __syncthreads();   // both warpgroups are done with this stage
  }

  const float inv[2] = {1.0f / l_run[0], 1.0f / l_run[1]};
  const int g = warp * 16 + lane / 4;   // rows of the block's 128
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(q_s + sw128<kRows>(g, n) +
                                 2 * (lane % 4)) =
        pack_bf16(acc[4 * n] * inv[0], acc[4 * n + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_s + sw128<kRows>(g + 8, n) +
                                 2 * (lane % 4)) =
        pack_bf16(acc[4 * n + 2] * inv[1], acc[4 * n + 3] * inv[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = warp * 16 + i / ND, c = i % ND;
    if (q0 + r < Tn)
      *reinterpret_cast<uint4*>(o + base + (size_t)(q0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + sw128<kRows>(r, c));
  }
  if (kSave && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + g + 8 * h;
      if (row < Tn) {
        m_out[(size_t)blockIdx.x * Tn + row] = m_run[h] * kLn2;
        l_out[(size_t)blockIdx.x * Tn + row] = l_run[h];
      }
    }
  }
}

}  // namespace tc

// A launch's plan: rows of q a block owns, threads, ring stages, dynamic
// shared bytes and the grid (b*h, query tiles).
struct Plan {
  int rows, threads, stages, smem, grid_x, grid_y;
};

int plan_for(bool tensor_cores, int BH, int Tn, int D, Plan* p) {
  if (BH < 1 || Tn < 1) return -3;
  if (D != 64 && D != 128) return -1;
  if (tensor_cores) {
    *p = {tc::kRows, tc::kThreadsTc, tc::kStages,
          D == 64 ? tc::smem_bytes<64>() : tc::smem_bytes<128>(), BH, 0};
  } else {
    *p = {kTile, kThreads, 1,
          (int)((D == 64 ? fwd_smem_floats<64>() : fwd_smem_floats<128>()) *
                sizeof(float)),
          BH, 0};
  }
  p->grid_y = (Tn + p->rows - 1) / p->rows;
  return 0;
}

template <typename Kernel, typename T>
int launch(Kernel kernel, const Plan& p, const T* q, const T* k, const T* v,
           T* o, float* m, float* l, int Tn, float scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, st>>>(
      q, k, v, o, m, l, Tn, scale);
  return cudaGetLastError();
}

int run_f32(const float* q, const float* k, const float* v, float* o,
            float* m, float* l, int BH, int Tn, int D, float scale, int save,
            cudaStream_t st) {
  Plan p;
  const int rc = plan_for(false, BH, Tn, D, &p);
  if (rc != 0) return rc;
  auto kernel = D == 64 ? (save ? flash_fwd_kernel<float, 64, true>
                                : flash_fwd_kernel<float, 64, false>)
                        : (save ? flash_fwd_kernel<float, 128, true>
                                : flash_fwd_kernel<float, 128, false>);
  return launch(kernel, p, q, k, v, o, m, l, Tn, scale, st);
}

int run_bf16(const tc::bf16* q, const tc::bf16* k, const tc::bf16* v,
             tc::bf16* o, float* m, float* l, int BH, int Tn, int D,
             float scale, int save, cudaStream_t st) {
  Plan p;
  const int rc = plan_for(true, BH, Tn, D, &p);
  if (rc != 0) return rc;
  auto kernel = D == 64 ? (save ? tc::flash_fwd_tc<64, true>
                                : tc::flash_fwd_tc<64, false>)
                        : (save ? tc::flash_fwd_tc<128, true>
                                : tc::flash_fwd_tc<128, false>);
  return launch(kernel, p, q, k, v, o, m, l, Tn, scale, st);
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: a head size other than 64 or 128; -3: an empty dimension.
extern "C" int flash_attn_fwd_f32(const float* q, const float* k,
                                  const float* v, float* o, float* m,
                                  float* l, int BH, int Tn, int D,
                                  float scale, int save, void* stream) {
  return run_f32(q, k, v, o, m, l, BH, Tn, D, scale, save,
                 (cudaStream_t)stream);
}

extern "C" int flash_attn_fwd_bf16(const __nv_bfloat16* q,
                                   const __nv_bfloat16* k,
                                   const __nv_bfloat16* v, __nv_bfloat16* o,
                                   float* m, float* l, int BH, int Tn, int D,
                                   float scale, int save, void* stream) {
  return run_bf16(q, k, v, o, m, l, BH, Tn, D, scale, save,
                  (cudaStream_t)stream);
}

// The plan of a launch of the bf16 (bf16 = 1) or f32 entry, nothing
// launched: out = {rows a block, threads, stages, shared bytes, grid x,
// grid y}. Return codes as the entries'.
extern "C" int flash_attn_fwd_plan(int bf16, int BH, int Tn, int D,
                                   int* out) {
  Plan p;
  const int rc = plan_for(bf16 != 0, BH, Tn, D, &p);
  if (rc != 0) return rc;
  const int vals[6] = {p.rows, p.threads, p.stages, p.smem, p.grid_x,
                       p.grid_y};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
