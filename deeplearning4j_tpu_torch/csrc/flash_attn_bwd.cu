// Flash-attention backward (non-causal, no bias) for Hopper, sm_90a.
//
// Replaces the two backward Pallas kernels of
// jax.experimental.pallas.ops.tpu.flash_attention (jax 0.9.0), which its
// custom_vjp (_flash_attention_bwd, :254) launches under BertTrainer
// (deeplearning4j_tpu/models/bert.py:34, :197, causal=False):
//
// - flash_attn_bwd_dkv_{f32,bf16}: _flash_attention_bwd_dkv (:941,
//   pallas_call :1121, body _flash_attention_dkv_kernel :796), preceded
//   by the di pass the VJP computes in XLA (:273);
// - flash_attn_bwd_dq_{f32,bf16}: _flash_attention_bwd_dq (:1287,
//   pallas_call :1456, body _flash_attention_dq_kernel :1146).
//
//   q, k, v, o, do [B*H, T, D], m, l [B*H, T] f32 (the forward's, m in
//   the natural units of s) ->
//   di = rowsum(o do) (f32);  p = exp(s - m) (1/l), s = (q k^T) sm_scale
//   dv = p^T do;  dp = do v^T;  ds = (dp - di) p sm_scale
//   dk = ds^T q;  dq = ds k
//
// with p and ds rounded to the inputs' type before the products that take
// them, as the reference rounds them (p.T.astype(do.dtype), ds.astype),
// every sum in f32, and dq, dk, dv written once, in the inputs' type.
// flash_attn_bwd_plan gives a launch's plan without launching.
//
// What bounds it on this card. dk and dv need 8 B*H*T^2*D operations (s
// and dp again, then dv and dk) against the bytes of q, k, v, o, do, dk,
// dv and m, l, di; dq needs 6 (s, dp, dq) against q, k, v, do, dq and m,
// l, di. At BERT-base's B=16, H=12, T=512, D=64 in bf16: 25.8 GFLOP and
// 89 MB, 0.0261 ms on the bf16 tensor cores (989 TFLOP/s) against 0.0266
// at 3.35 TB/s, for dk and dv; 19.3 GFLOP and 64 MB, 0.0195 ms
// against 0.0191, for dq. Both sit where the operations and the bytes
// meet, so the products have to run on the tensor cores and every input
// must be read from device memory about once.
//
// Design. The TPU kernels carry dk, dv or dq across a sequential grid
// axis in VMEM scratch; here a block's own loop takes that axis's place.
// Two kernels, as there, and no atomics: FlashAttention-2/3's fused
// backward adds dq across key blocks with f32 atomics, whose order (and
// bits) change from run to run. Every output element is summed by one
// thread in a fixed order, so two runs give the same bits; the price is
// that the dq kernel computes s and dp again (14 rather than 10 B*H*T^2*D
// operations in all).
//
// bf16: the tensor-core kernels, on wgmma (hopper_bf16.cuh; the tile
// layout and fragment packing of flash_tc.cuh, shared with the forward).
// - dkv: a block is one warpgroup and owns 64 key rows of one b*h; its k
//   and v tiles stay in shared memory as wgmma's A operands. q and do
//   tiles of 64 queries come through a three-stage cp.async ring, in the
//   128-byte-swizzle layout; each tile's m log2(e), 1/l and di go into
//   shared memory beside it, converted once for the block (a tile ahead,
//   by 64 of its threads) rather than by every thread that reads them.
//   Per tile: s^T = k q^T and dp^T = v do^T (m64n64k16, q and do the
//   K-major B operands); p^T = 2^(s^T sm_scale log2(e) - m log2(e)) (1/l)
//   on the accumulator registers while dp^T's product runs (the per-query
//   stats belong to the accumulator's columns), then ds^T = p^T (dp^T -
//   di) sm_scale; p^T and ds^T packed to bf16 straight into register-A
//   fragments for dv += p^T do and dk += ds^T q, do and q now the MN-major
//   B operands of the same swizzled bytes (transpose-B). Nothing is
//   transposed in memory, and p and ds never touch shared memory. dk and
//   dv are written once, staged through the block's k and v tiles for
//   16-byte stores.
// - dq: the forward's shape turned to the gradient. Two warpgroups own
//   128 query rows; their q and do tiles stay in shared memory as A
//   operands and their m log2(e), 1/l and di in registers; k and v tiles
//   of 64 keys come through a three-stage cp.async ring. s = q k^T and
//   dp = do v^T (k and v K-major); ds = p (dp - di) sm_scale packed to
//   bf16 into register A; dq += ds k, k MN-major. dq is staged through
//   q's tile for 16-byte stores.
// - Both wait for each tile's products before its arithmetic and the
//   arithmetic before the next products; the SM overlaps the two across
//   blocks. So the registers decide the speed: the dkv kernel holds dk,
//   dv, s^T and dp^T (128 accumulators a thread at D = 64) and is held to
//   168 registers, three one-warpgroup blocks an SM; the dq kernel (122)
//   fits two blocks of two warpgroups.
// - Rows from T on arrive as zeros; their p and ds are 0 (1/l is set to
//   0; keys from T on are masked in dq), and no output row from T on is
//   written.
// - di: one warp per row, before the dkv kernel, into a [B*H, T] f32
//   buffer that the dq kernel reads too.
// Measured on an H100 (80GB HBM3, 700 W) back to back at 16/12/512/64
// (scripts/flash_matmul_ab.py): the dkv entry 0.107 ms (of it the di pass
// 0.014), dq 0.064; the SIMT kernels these replace ran 0.96 and 0.71.
// Two warpgroups a dkv block (216 registers, one block an SM) ran 0.120,
// one warpgroup at two blocks an SM 0.117, and a first version that
// overlapped dv's product with ds but had every thread convert m and l
// (188 registers, two warpgroups) 0.173. Taking each product out in turn
// (a diagnostic, wrong results): without dv's and dk's 0.070, without
// s^T's and dp^T's 0.095, without the loop's loads 0.092, without the
// exponentials 0.105; dv's and dk's with A read from shared memory
// rather than registers 0.076. The register-A form of the second
// products is what costs; issuing the next tile's first products before
// waiting for them (225 registers, serialised by ptxas) ran 0.129.
//
// f32: the SIMT kernels, unchanged. The reference computes in float32,
// and a tensor-core f32 product would be TF32. One block owns a tile of
// 64 key rows (dkv) or 64 query rows (dq) of one b*h and loops over the
// other side's tiles:
// - 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 of the
//   block's tile and columns tx + 16c of the 64 x 64 score tile, and, in
//   the products into dk, dv or dq, columns tx + 16c (c < D/16) of D.
// - The block's own tiles stay in shared memory (transposed, as float, a
//   row stride of 68 so that a thread's four rows are one float4); the
//   other side's tiles are staged transposed with a stride of 65, so that
//   the D-column reads of the second products do not collide in a bank.
// - s and dp share one loop over d; p and ds go through shared memory,
//   rounded to the inputs' type, to the second products.
// Any T >= 1; D is 64 or 128.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_tc.cuh"
#include "hopper_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

using namespace flash_tc;

constexpr int kDkvWgs = 1;      // warpgroups of a dkv block (64 keys each)
constexpr int kDkvStages = 3;   // q and do tiles in the dkv ring
// dkv blocks an SM should hold (ptxas keeps the registers to that): at
// D = 64, three warpgroups an SM overlap one another's products with
// their exponentials; at D = 128 dk and dv alone take 128 registers
constexpr int dkv_blocks(int D) { return D == 64 ? 3 : 1; }
constexpr int kDqWgs = 2;       // warpgroups of a dq block (64 queries each)
constexpr int kDqStages = 3;    // k and v tiles in the dq ring
constexpr int kTileRows = 64;   // rows of a ring tile (queries or keys)

__device__ __forceinline__ bf16* align1024(uint8_t* p) {
  return reinterpret_cast<bf16*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                 ~uintptr_t(1023));
}

// k and v tiles, the ring of q and do tiles and their m, l and di, and
// 1 KB to align the tiles to 1024 bytes
template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * 64 * kDkvWgs * D + kDkvStages * 2 * kTileRows * D) *
             (int)sizeof(bf16) +
         kDkvStages * 3 * kTileRows * (int)sizeof(float) + 1024;
}

// q and do tiles and the ring of k and v tiles
template <int D>
constexpr int dq_smem_bytes() {
  return (2 * 64 * kDqWgs * D + kDqStages * 2 * kTileRows * D) *
             (int)sizeof(bf16) +
         1024;
}

// The K-major descriptor of k16 step kk of the 64 rows at row r0 of an
// [R][D] sw128 tile at shared address addr (rows along M or N, D along K).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int r0, int kk) {
  return hopper::wgmma_desc(
      addr + r0 * 128 + (kk / 4) * R * 128 + (kk % 4) * 32, 16, 1024);
}

// The MN-major descriptor of k16 step t of a [64][D] sw128 tile (its rows
// along K, D along N).
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int t) {
  return hopper::wgmma_desc(addr + t * 2048, kTileRows * 128, 1024);
}

// d (+)= A[64 x 16] B[16 x D], A from registers, B MN-major.
template <int D>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t desc_b) {
  if constexpr (D == 64)
    hopper::wgmma_m64n64k16_rs<1>(d, a, desc_b, 1);
  else
    hopper::wgmma_m64n128k16_rs<1>(d, a, desc_b, 1);
}

// x = A B^T over k = D, x an m64n64 accumulator: A's 64 rows at row r0 of
// an [R][D] tile, B a [64][D] tile, both K-major.
template <int D, int R>
__device__ __forceinline__ void mma_abt(float* x, uint32_t a_addr, int r0,
                                        uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_m64n64k16<0>(x, desc_k<R>(a_addr, r0, kk),
                               desc_k<kTileRows>(b_addr, 0, kk), kk > 0);
}

// Stores rows of the block's accumulator acc (m64nD a warpgroup) in bf16
// into the warp's own rows of the [R][D] sw128 tile at s.
template <int D, int R>
__device__ __forceinline__ void stage_rows(bf16* s, const float* acc,
                                           int warp, int lane) {
  const int g = warp * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(s + sw128<R>(g, n) + 2 * (lane % 4)) =
        pack_bf16(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(s + sw128<R>(g + 8, n) + 2 * (lane % 4)) =
        pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// The warp's 16 rows of the [R][D] sw128 tile at s into out [T, D] from
// row r0, 16 bytes a store; rows from T on are not written.
template <int D, int R>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const bf16* s, int r0, int Tn,
                                           int warp, int lane) {
  constexpr int ND = D / 8;
  for (int i = lane; i < 16 * ND; i += 32) {
    const int r = warp * 16 + i / ND, c = i % ND;
    if (r0 + r < Tn)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(s + sw128<R>(r, c));
  }
}

// One block: key rows k0 .. k0 + kRows - 1 of one b*h; loops over tiles of
// 64 queries. In warpgroup wg, the m64n64 accumulators s^T and dp^T hold
// key rows 64 wg + 16w + l/4 (+8) and query columns 8n + 2(l%4), +1.
template <int D>
__global__ void __launch_bounds__(128 * kDkvWgs, dkv_blocks(D))
flash_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ m, const float* __restrict__ l,
             const float* __restrict__ di, bf16* __restrict__ dk,
             bf16* __restrict__ dv, int Tn, float scale) {
  using namespace hopper;
  constexpr int kRows = 64 * kDkvWgs;
  constexpr int kThreads = 128 * kDkvWgs;
  constexpr int kQ = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  bf16* k_s = align1024(smem_raw);   // [kRows][D]
  bf16* v_s = k_s + kRows * D;       // [kRows][D]
  bf16* ring = v_s + kRows * D;      // stages of q, do [kQ][D]
  float* st_s = reinterpret_cast<float*>(ring + kDkvStages * 2 * kQ * D);

  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.x * Tn * D;
  const size_t rbase = (size_t)blockIdx.x * Tn;
  const int k0 = blockIdx.y * kRows;
  const int tiles = (Tn + kQ - 1) / kQ;
  const float scale2 = scale * kLog2e;

  // tile j's q and do into stage j % stages
  auto load_tile = [&](int j) {
    bf16* qs = ring + (j % kDkvStages) * 2 * kQ * D;
    load_rows<D, kQ, kThreads>(qs, q + base, j * kQ, Tn);
    load_rows<D, kQ, kThreads>(qs + kQ * D, dout + base, j * kQ, Tn);
  };
  // Tile j's stats go into its stage as [3][kQ] floats: m log2(e), 1/l
  // and di, converted once for the block rather than by every thread
  // that reads them; queries from T on get 0, 1/l = 0 (l = inf). Thread
  // i < kQ fetches query i's three a tile ahead of storing them, so the
  // loads' latency hides behind a tile's products.
  float raw[3];
  auto fetch_stats = [&](int j) {
    const int r = j * kQ + threadIdx.x;
    const bool ok = r < Tn;
    raw[0] = ok ? m[rbase + r] : 0.0f;
    raw[1] = ok ? l[rbase + r] : INFINITY;
    raw[2] = ok ? di[rbase + r] : 0.0f;
  };
  auto put_stats = [&](int j) {
    float* ss = st_s + (j % kDkvStages) * 3 * kQ + threadIdx.x;
    ss[0] = raw[0] * kLog2e;
    ss[kQ] = 1.0f / raw[1];
    ss[2 * kQ] = raw[2];
  };
  load_rows<D, kRows, kThreads>(k_s, k + base, k0, Tn);
  load_rows<D, kRows, kThreads>(v_s, v + base, k0, Tn);
#pragma unroll
  for (int j = 0; j < kDkvStages - 1; ++j) {
    if (j < tiles) load_tile(j);
    cp_async_commit();
  }
  const bool stats_thread = threadIdx.x < kQ;
  if (stats_thread) {
    fetch_stats(0);
    put_stats(0);
    if (tiles > 1) fetch_stats(1);
  }

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  const int c0 = 2 * (lane % 4);   // the thread's first query column

  for (int j = 0; j < tiles; ++j) {
    // tile j + 1's stage was last read by tile j + 1 - stages, whose
    // readers passed the barrier at the end of their iteration
    if (stats_thread && j + 1 < tiles) put_stats(j + 1);
    if (stats_thread && j + 2 < tiles) fetch_stats(j + 2);
    if (j + kDkvStages - 1 < tiles) load_tile(j + kDkvStages - 1);
    cp_async_commit();
    cp_async_wait<kDkvStages - 1>();
    fence_proxy_async();   // the tile's cp.async writes, to wgmma's reads
    __syncthreads();
    const bf16* qs = ring + (j % kDkvStages) * 2 * kQ * D;
    const float* ss = st_s + (j % kDkvStages) * 3 * kQ;
    const uint32_t q_addr = smem_u32(qs), do_addr = smem_u32(qs + kQ * D);

    float s[32], dp[32];
    wgmma_fence();
    mma_abt<D, kRows>(s, k_addr, 64 * wg, q_addr);
    wgmma_commit();
    mma_abt<D, kRows>(dp, v_addr, 64 * wg, do_addr);
    wgmma_commit();
    wgmma_wait<1>();   // s^T is in
    fence_regs<32>(s);

    // p^T in place of s^T; queries from T on have 1/l = 0, so p^T = 0
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + c0;
      const float2 m2 = *reinterpret_cast<const float2*>(ss + c);
      const float2 li = *reinterpret_cast<const float2*>(ss + kQ + c);
      s[4 * n] = ex2(s[4 * n] * scale2 - m2.x) * li.x;
      s[4 * n + 1] = ex2(s[4 * n + 1] * scale2 - m2.y) * li.y;
      s[4 * n + 2] = ex2(s[4 * n + 2] * scale2 - m2.x) * li.x;
      s[4 * n + 3] = ex2(s[4 * n + 3] * scale2 - m2.y) * li.y;
    }
    wgmma_wait<0>();   // dp^T is in
    fence_regs<32>(dp);
    // ds^T in place of dp^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dd =
          *reinterpret_cast<const float2*>(ss + 2 * kQ + 8 * n + c0);
      dp[4 * n] = (dp[4 * n] - dd.x) * s[4 * n] * scale;
      dp[4 * n + 1] = (dp[4 * n + 1] - dd.y) * s[4 * n + 1] * scale;
      dp[4 * n + 2] = (dp[4 * n + 2] - dd.x) * s[4 * n + 2] * scale;
      dp[4 * n + 3] = (dp[4 * n + 3] - dd.y) * s[4 * n + 3] * scale;
    }
    // p^T and ds^T as register-A fragments for dv += p^T do, dk += ds^T q
    uint32_t pa[4][4], da[4][4];
    pack_a(pa, s);
    pack_a(da, dp);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_rs<D>(acc_v, pa[t], desc_mn(do_addr, t));
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_rs<D>(acc_k, da[t], desc_mn(q_addr, t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(pa);
    fence_frags(da);
    fence_regs<D / 2>(acc_v);
    fence_regs<D / 2>(acc_k);
    __syncthreads();   // every warpgroup is done with this stage
  }

  // k_s and v_s are free: each warp stages its own rows there
  stage_rows<D, kRows>(k_s, acc_k, warp, lane);
  stage_rows<D, kRows>(v_s, acc_v, warp, lane);
  __syncwarp();
  store_rows<D, kRows>(dk + base, k_s, k0, Tn, warp, lane);
  store_rows<D, kRows>(dv + base, v_s, k0, Tn, warp, lane);
}

// One block: query rows q0 .. q0 + kRows - 1 of one b*h; loops over tiles
// of 64 keys. In warpgroup wg, the m64n64 accumulators s and dp hold query
// rows 64 wg + 16w + l/4 (+8) and key columns 8n + 2(l%4), +1.
template <int D>
__global__ void __launch_bounds__(128 * kDqWgs)
flash_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ m, const float* __restrict__ l,
            const float* __restrict__ di, bf16* __restrict__ dq, int Tn,
            float scale) {
  using namespace hopper;
  constexpr int kRows = 64 * kDqWgs;
  constexpr int kThreads = 128 * kDqWgs;
  constexpr int kK = kTileRows;
  extern __shared__ uint8_t smem_raw[];
  bf16* q_s = align1024(smem_raw);   // [kRows][D]
  bf16* do_s = q_s + kRows * D;      // [kRows][D]
  bf16* ring = do_s + kRows * D;     // stages of k, v [kK][D]

  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)blockIdx.x * Tn * D;
  const size_t rbase = (size_t)blockIdx.x * Tn;
  const int q0 = blockIdx.y * kRows;
  const int tiles = (Tn + kK - 1) / kK;
  const float scale2 = scale * kLog2e;

  auto load_kv = [&](int j) {
    bf16* ks = ring + (j % kDqStages) * 2 * kK * D;
    load_rows<D, kK, kThreads>(ks, k + base, j * kK, Tn);
    load_rows<D, kK, kThreads>(ks + kK * D, v + base, j * kK, Tn);
  };
  load_rows<D, kRows, kThreads>(q_s, q + base, q0, Tn);
  load_rows<D, kRows, kThreads>(do_s, dout + base, q0, Tn);
#pragma unroll
  for (int j = 0; j < kDqStages - 1; ++j) {
    if (j < tiles) load_kv(j);
    cp_async_commit();
  }

  // the rows' m (base 2), 1/l and di; rows from T on get 1/l = 0
  float m2[2], li[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * h;
    const bool ok = row < Tn;
    m2[h] = ok ? m[rbase + row] * kLog2e : 0.0f;
    li[h] = ok ? 1.0f / l[rbase + row] : 0.0f;
    dd[h] = ok ? di[rbase + row] : 0.0f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);

  for (int j = 0; j < tiles; ++j) {
    if (j + kDqStages - 1 < tiles) load_kv(j + kDqStages - 1);
    cp_async_commit();
    cp_async_wait<kDqStages - 1>();
    fence_proxy_async();
    __syncthreads();
    const bf16* ks = ring + (j % kDqStages) * 2 * kK * D;
    const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(ks + kK * D);

    float s[32], dp[32];
    wgmma_fence();
    mma_abt<D, kRows>(s, q_addr, 64 * wg, k_addr);
    wgmma_commit();
    mma_abt<D, kRows>(dp, do_addr, 64 * wg, v_addr);
    wgmma_commit();
    wgmma_wait<1>();   // s is in
    fence_regs<32>(s);

    // p in place of s; keys from T on get p = 0
    const int key0 = j * kK + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * n + e];
        x = key0 + 8 * n + (e & 1) < Tn
                ? ex2(x * scale2 - m2[e / 2]) * li[e / 2]
                : 0.0f;
      }
    wgmma_wait<0>();   // dp is in
    fence_regs<32>(dp);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * n + e] = (dp[4 * n + e] - dd[e / 2]) * s[4 * n + e] * scale;
    uint32_t da[4][4];
    pack_a(da, dp);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_rs<D>(acc, da[t], desc_mn(k_addr, t));
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(da);
    fence_regs<D / 2>(acc);
    __syncthreads();   // both warpgroups are done with this stage
  }

  stage_rows<D, kRows>(q_s, acc, warp, lane);
  __syncwarp();
  store_rows<D, kRows>(dq + base, q_s, q0, Tn, warp, lane);
}

}  // namespace tc

// A launch's plan: rows of its own side a block owns (keys for dkv,
// queries for dq), threads, ring stages, dynamic shared bytes and the
// grid (b*h, tiles of rows).
struct Plan {
  int rows, threads, stages, smem, grid_x, grid_y;
};

constexpr int kDkv = 0, kDq = 1;

int plan_for(bool tensor_cores, int which, int BH, int Tn, int D,
             Plan* p) {
  if (BH < 1 || Tn < 1) return -3;
  if (D != 64 && D != 128) return -1;
  if (which != kDkv && which != kDq) return -2;
  if (tensor_cores && which == kDkv) {
    *p = {64 * tc::kDkvWgs, 128 * tc::kDkvWgs, tc::kDkvStages,
          D == 64 ? tc::dkv_smem_bytes<64>() : tc::dkv_smem_bytes<128>(),
          BH, 0};
  } else if (tensor_cores) {
    *p = {64 * tc::kDqWgs, 128 * tc::kDqWgs, tc::kDqStages,
          D == 64 ? tc::dq_smem_bytes<64>() : tc::dq_smem_bytes<128>(), BH,
          0};
  } else {
    // the dq kernel stages one [kTile][kPad4] tile fewer (no p)
    const size_t floats =
        (D == 64 ? bwd_smem_floats<64>() : bwd_smem_floats<128>()) -
        (which == kDq ? (size_t)kTile * kPad4 : 0);
    *p = {kTile, kThreads, 1, (int)(floats * sizeof(float)), BH, 0};
  }
  p->grid_y = (Tn + p->rows - 1) / p->rows;
  return 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Plan& p, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y), p.threads, p.smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename T>
int launch_di(const T* o, const T* dout, float* di, int BH, int Tn, int D,
              cudaStream_t st) {
  const int rows = BH * Tn;
  const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (D == 64)
    flash_di_kernel<T, 64><<<blocks, kThreads, 0, st>>>(o, dout, di, rows);
  else
    flash_di_kernel<T, 128><<<blocks, kThreads, 0, st>>>(o, dout, di, rows);
  return cudaGetLastError();
}

template <typename T>
int run_dkv(const T* q, const T* k, const T* v, const T* o, const T* dout,
            const float* m, const float* l, float* di, T* dk, T* dv, int BH,
            int Tn, int D, float scale, cudaStream_t st) {
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  Plan p;
  int rc = plan_for(kTc, kDkv, BH, Tn, D, &p);
  if (rc != 0) return rc;
  rc = launch_di(o, dout, di, BH, Tn, D, st);
  if (rc != 0) return rc;
  if constexpr (kTc)
    return launch(D == 64 ? tc::flash_dkv_tc<64> : tc::flash_dkv_tc<128>,
                  p, st, q, k, v, dout, m, l, (const float*)di, dk, dv, Tn,
                  scale);
  else
    return launch(D == 64 ? flash_dkv_kernel<T, 64>
                          : flash_dkv_kernel<T, 128>,
                  p, st, q, k, v, dout, m, l, (const float*)di, dk, dv, Tn,
                  scale);
}

template <typename T>
int run_dq(const T* q, const T* k, const T* v, const T* dout,
           const float* m, const float* l, const float* di, T* dq, int BH,
           int Tn, int D, float scale, cudaStream_t st) {
  constexpr bool kTc = std::is_same<T, __nv_bfloat16>::value;
  Plan p;
  const int rc = plan_for(kTc, kDq, BH, Tn, D, &p);
  if (rc != 0) return rc;
  if constexpr (kTc)
    return launch(D == 64 ? tc::flash_dq_tc<64> : tc::flash_dq_tc<128>, p,
                  st, q, k, v, dout, m, l, di, dq, Tn, scale);
  else
    return launch(D == 64 ? flash_dq_kernel<T, 64>
                          : flash_dq_kernel<T, 128>,
                  p, st, q, k, v, dout, m, l, di, dq, Tn, scale);
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

// The plan of a launch of the bf16 (bf16 = 1) or f32 entry, dkv (which =
// 0) or dq (which = 1), nothing launched: out = {rows a block, threads,
// stages, shared bytes, grid x, grid y}. Return codes as the entries', and
// -2: which is neither 0 nor 1.
extern "C" int flash_attn_bwd_plan(int bf16, int which, int BH, int Tn,
                                   int D, int* out) {
  Plan p;
  const int rc = plan_for(bf16 != 0, which, BH, Tn, D, &p);
  if (rc != 0) return rc;
  const int vals[6] = {p.rows, p.threads, p.stages, p.smem, p.grid_x,
                       p.grid_y};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
