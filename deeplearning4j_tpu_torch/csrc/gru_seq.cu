// GRU (reset-after) recurrence forward for Hopper, sm_90a: two entry
// points that share one kernel body, told apart by the compile-time flag
// kSave.
//
// gru_seq_infer_f32 (kSave = false) replaces
// deeplearning4j_tpu/kernels/gru.py:_fwd_infer_kernel (launched by
// _fwd_call with save_residuals=False):
//
//   xw [T,N,3H] f32 (input projection, input bias folded in),
//   R [H,3H], rb [3H] (recurrent bias), h0 [N,H]  ->  hs [T,N,H], hT [N,H]
//   rz = h_{t-1} R + rb;  r, u = sigmoid(xw_ru + rz_ru)
//   cand = tanh(xw_c + r rz_c);  h = u h_{t-1} + (1 - u) cand
//
// gru_seq_fwd_f32 (kSave = true) replaces _fwd_kernel (launched by
// _fwd_call with save_residuals=True), the training forward: the same
// recurrence, writing the residuals the backward needs instead of hT:
//
//   -> hs [T,N,H], ru [T,N,2H] (post-sigmoid r|u), rz_c [T,N,H]
//      (h R_c + rb_c, before the reset gate), cand [T,N,H]
//
// The whole rb is added inside the kernel, the r and u parts included:
// the candidate part cannot be folded into xw (r multiplies it), and
// adding all three in one place keeps the sums in the reference's order.
//
// What bounds it on this card. Each step is an [N,H]x[H,3H] product plus
// gates, and step t needs every h_{t-1}. At the training shape T=100,
// N=64, H=1024 the products are 2*T*N*H*3H = 40.3 GFLOP of f32 FMA, which
// on the non-tensor f32 pipe (67 TFLOP/s) take 0.60 ms, against 0.05 ms
// for the 0.16 GB of xw, R and hs at 3.35 TB/s: operations bound it. At
// serving batches (N <= 32) the T serial steps do, each one a grid-wide
// barrier plus a chain of H/32 multiply-adds and a warp reduction.
//
// Design (one launch per sequence, as on the TPU, where R stays in VMEM):
// - No SM can hold R (12 MiB at H=1024), so it is split by units across
//   blocks and kept in shared memory for the whole sequence. The LSTM
//   kernel's 32 units per block would need [H, 3*32] = 384 KiB at H=1024,
//   over the 227 KiB a block may opt into. Here a block owns kUnits = 8
//   units (one warp each) with their 3 gate columns: 8*3*H*4 B = 96 KiB of
//   R at H=1024, plus the staged h_{t-1} rows of a row tile (ROWS*H*4 B,
//   64 KiB for 16 rows): 160 KiB, one block per SM. ceil(H/8) = 128 blocks
//   must be co-resident for the cooperative grid: 128 <= 132 SMs. R is
//   stored gate column by gate column ([3*kUnits][H]) so that the 32 lanes
//   of a warp, which split the sum over k (k = lane + 32 i), read 32
//   consecutive words.
// - A lane keeps the 3 gate sums of ROWS rows in registers and reads each
//   R value once for all of them. A reduce-scatter butterfly of warp
//   shuffles then adds the 32 lanes' parts (62 shuffles at 16 rows, where
//   the first version's plain butterfly of all 48 sums took 240), and one
//   lane per row gathers its three sums and applies the gates; it loaded
//   that row's xw values before the sums, to hide their latency. ROWS
//   (1, 2, 4, 8 or 16) is the smallest power of two covering N, at most
//   16; larger N loops over row tiles, and blocks with the same units
//   split the row tiles when the card holds more blocks than unit slices
//   (small H).
// - Each (n, j) cell is written by one thread; h_{t-1} is written by other
//   blocks during this launch, so it is staged through L2 only (cp.async.cg
//   or __ldcg, never a stale L1 line), all of a tile's copies in flight at
//   once (one at a time, as the first version issued them, their L2
//   latency dominated each step). A cooperative grid barrier separates
//   steps.
// The ragged edges in N and H are masked; no shape alignment is needed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;                    // hidden units per block
constexpr int kWarps = kUnits;               // one warp per unit
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 16;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Copy rows n0 .. n0+ROWS-1 of h [N, H] into h_s [ROWS][H] (zeros past N).
// With H % 4 == 0 and h 16-byte aligned, every thread issues its 16-byte
// copies at once with cp.async.cg, which reads through L2 (never a stale
// L1 line: other blocks wrote h during this launch) and keeps all of them
// in flight, so the tile costs about one L2 round trip; otherwise a plain
// __ldcg loop.
template <int ROWS>
__device__ __forceinline__ void stage_rows(float* h_s, const float* h,
                                           int n0, int N, int H) {
  if ((H & 3) == 0 && (reinterpret_cast<size_t>(h) & 15) == 0) {
    const int quads = H >> 2;
    for (int idx = threadIdx.x; idx < ROWS * quads; idx += kThreads) {
      const int q = idx / quads;
      const int c = idx - q * quads;
      float* dst = h_s + (size_t)q * H + 4 * c;
      if (n0 + q < N) {
        const unsigned d =
            static_cast<unsigned>(__cvta_generic_to_shared(dst));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(h + (size_t)(n0 + q) * H + 4 * c));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
  } else {
    for (int idx = threadIdx.x; idx < ROWS * H; idx += kThreads) {
      const int n = n0 + idx / H;
      h_s[idx] = n < N ? __ldcg(h + (size_t)n * H + idx % H) : 0.0f;
    }
  }
}

// kSave: write ru, rz_c and cand for the backward instead of hT.
template <int ROWS, bool kSave>
__global__ void __launch_bounds__(kThreads)
gru_seq_kernel(const float* __restrict__ xw,
               const float* __restrict__ r,
               const float* __restrict__ rb,
               const float* __restrict__ h0,
               float* hs, float* __restrict__ hT,
               float* __restrict__ ru, float* __restrict__ rzc,
               float* __restrict__ cand,
               int T, int N, int H, int unit_tiles, int row_groups) {
  extern __shared__ float smem[];
  float* r_s = smem;                              // [3 * kUnits][H]
  float* h_s = r_s + (size_t)3 * kUnits * H;      // [ROWS][H]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int unit_tile = blockIdx.x % unit_tiles;
  const int group = blockIdx.x / unit_tiles;
  const int j = unit_tile * kUnits + warp;        // this warp's unit
  const bool j_ok = j < H;
  const size_t three_h = 3 * (size_t)H;

  // r_s[(g * kUnits + u) * H + k] = R[k, g*H + unit_tile*kUnits + u]
  for (int idx = threadIdx.x; idx < 3 * kUnits * H; idx += kThreads) {
    const int col = idx / H;
    const int k = idx % H;
    const int g = col / kUnits;
    const int jg = unit_tile * kUnits + col % kUnits;
    r_s[idx] = jg < H ? r[k * three_h + (size_t)g * H + jg] : 0.0f;
  }
  const float* r_r = r_s + (size_t)(0 * kUnits + warp) * H;
  const float* r_u = r_s + (size_t)(1 * kUnits + warp) * H;
  const float* r_c = r_s + (size_t)(2 * kUnits + warp) * H;
  float rb_r = 0.0f, rb_u = 0.0f, rb_c = 0.0f;
  if (j_ok) {
    rb_r = rb[j];
    rb_u = rb[H + j];
    rb_c = rb[2 * H + j];
  }

  cg::grid_group grid = cg::this_grid();
  const int row_tiles = (N + ROWS - 1) / ROWS;
  const size_t nh = (size_t)N * H;

  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : hs + (size_t)(t - 1) * nh;
    const float* xw_t = xw + (size_t)t * N * three_h;
    float* h_out = hs + (size_t)t * nh;

    for (int rt = group; rt < row_tiles; rt += row_groups) {
      const int n0 = rt * ROWS;
      __syncthreads();  // R staged; previous tile's readers of h_s done
      stage_rows<ROWS>(h_s, h_prev, n0, N, H);
      __syncthreads();

      // which lane finishes which row after the reduction (see below);
      // it loads its xw values now, so that they arrive during the sums
      constexpr int C = 4 * ROWS;       // r, u, c and a zero for each row
      constexpr int S = C >= 32 ? 1 : 32 / C;   // lanes per value (C <= 32)
      const int q_own = C == 64 ? lane >> 1 : lane / (4 * S);
      const bool owner = C == 64 ? (lane & 1) == 0 : lane % (4 * S) == 0;
      const int n = n0 + q_own;
      const bool cell_ok = owner && q_own < ROWS && n < N && j_ok;
      float x_r = 0.0f, x_u = 0.0f, x_c = 0.0f;
      if (cell_ok) {
        const float* x = xw_t + (size_t)n * three_h + j;
        x_r = x[0];
        x_u = x[H];
        x_c = x[2 * H];
      }

      float acc[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = 0.0f;
#pragma unroll 4
      for (int k = lane; k < H; k += 32) {
        const float w_r = r_r[k], w_u = r_u[k], w_c = r_c[k];
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
          const float hv = h_s[q * H + k];
          acc[4 * q] = fmaf(hv, w_r, acc[4 * q]);
          acc[4 * q + 1] = fmaf(hv, w_u, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(hv, w_c, acc[4 * q + 2]);
        }
      }
      // Reduce-scatter over the 32 lanes' parts (fixed order), then the
      // owner of row q gathers its three sums: at C = 64 lane 2q holds
      // r, u and lane 2q+1 holds c; below, value i sits in lanes i*S...
      warp_reduce_scatter<C>(acc, lane);
      float s_r, s_u, s_c;
      if constexpr (C == 64) {
        s_r = acc[0];
        s_u = acc[1];
        s_c = __shfl_down_sync(0xffffffffu, acc[0], 1);
      } else {
        s_r = acc[0];
        s_u = __shfl_down_sync(0xffffffffu, acc[0], S);
        s_c = __shfl_down_sync(0xffffffffu, acc[0], 2 * S);
      }
      if (cell_ok) {
        const float rz_c = s_c + rb_c;
        const float rg = sigmoid(x_r + (s_r + rb_r));
        const float ug = sigmoid(x_u + (s_u + rb_u));
        const float c = tanhf(x_c + rg * rz_c);
        const float hp = h_s[q_own * H + j];
        const float h = ug * hp + (1.0f - ug) * c;
        const size_t cell = (size_t)n * H + j;
        if constexpr (kSave) {
          float* ru_t = ru + (size_t)t * N * 2 * H + (size_t)n * 2 * H + j;
          ru_t[0] = rg;
          ru_t[H] = ug;
          rzc[(size_t)t * nh + cell] = rz_c;
          cand[(size_t)t * nh + cell] = c;
        } else {
          if (t == T - 1) hT[cell] = h;
        }
        h_out[cell] = h;
      }
    }
    if (t + 1 < T) grid.sync();
  }
}

size_t smem_bytes(int H, int rows) {
  return ((size_t)3 * kUnits * H + (size_t)rows * H) * sizeof(float);
}

// With `dry`, only the checks: 0 where the launch would go ahead.
template <int ROWS, bool kSave>
int launch(const float* xw, const float* r, const float* rb, const float* h0,
           float* hs, float* hT, float* ru, float* rzc, float* cand, int T,
           int N, int H, int sms, int smem_optin, cudaStream_t stream,
           bool dry) {
  const size_t smem = smem_bytes(H, ROWS);
  if (smem > (size_t)smem_optin) return -1;
  auto kernel = gru_seq_kernel<ROWS, kSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int capacity = per_sm * sms;
  const int unit_tiles = (H + kUnits - 1) / kUnits;
  const int row_tiles = (N + ROWS - 1) / ROWS;
  if (capacity < unit_tiles) return -2;
  int row_groups = capacity / unit_tiles;
  if (row_groups > row_tiles) row_groups = row_tiles;
  if (dry) return 0;
  void* args[] = {(void*)&xw, (void*)&r, (void*)&rb, (void*)&h0,
                  (void*)&hs, (void*)&hT, (void*)&ru, (void*)&rzc,
                  (void*)&cand, (void*)&T, (void*)&N, (void*)&H,
                  (void*)&unit_tiles, (void*)&row_groups};
  err = cudaLaunchCooperativeKernel((void*)kernel,
                                    dim3(unit_tiles * row_groups),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ROWS: the smallest power of two covering N, at most 16; a smaller tile
// when the larger one's h rows do not fit beside the R slice.
template <bool kSave>
int run(const float* xw, const float* r, const float* rb, const float* h0,
        float* hs, float* hT, float* ru, float* rzc, float* cand, int T,
        int N, int H, cudaStream_t st, bool dry) {
  if (T < 1 || N < 1 || H < 1) return -3;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int smem_optin = 0, sms = 0, coop = 0;
  cudaDeviceGetAttribute(&smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -2;
  int rows = 1;
  while (rows < N && rows < kMaxRows) rows *= 2;
  while (rows > 1 && smem_bytes(H, rows) > (size_t)smem_optin) rows /= 2;
#define GRU_LAUNCH(R_)                                                      \
  launch<R_, kSave>(xw, r, rb, h0, hs, hT, ru, rzc, cand, T, N, H, sms,     \
                    smem_optin, st, dry)
  switch (rows) {
    case 16: return GRU_LAUNCH(16);
    case 8: return GRU_LAUNCH(8);
    case 4: return GRU_LAUNCH(4);
    case 2: return GRU_LAUNCH(2);
    default: return GRU_LAUNCH(1);
  }
#undef GRU_LAUNCH
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for the R slice in shared memory on this device;
// -2: the grid cannot be made co-resident for a cooperative launch;
// -3: an empty dimension.
extern "C" int gru_seq_infer_f32(const float* xw, const float* r,
                                 const float* rb, const float* h0,
                                 float* hs, float* hT, int T, int N, int H,
                                 void* stream) {
  return run<false>(xw, r, rb, h0, hs, hT, nullptr, nullptr, nullptr, T, N,
                    H, (cudaStream_t)stream, false);
}

// The training forward: hs, ru [T,N,2H], rz_c and cand [T,N,H]; same
// codes.
extern "C" int gru_seq_fwd_f32(const float* xw, const float* r,
                               const float* rb, const float* h0, float* hs,
                               float* ru, float* rzc, float* cand, int T,
                               int N, int H, void* stream) {
  return run<true>(xw, r, rb, h0, hs, nullptr, ru, rzc, cand, T, N, H,
                   (cudaStream_t)stream, false);
}

// Whether gru_seq_infer_f32 (save = 0) or gru_seq_fwd_f32 (save = 1) would
// launch at batch N and width H on the current device: the same checks,
// and nothing launched. 0 if it would, else the code it would return. The
// wrappers choose the route with it, before any launch.
extern "C" int gru_seq_fits(int N, int H, int save) {
  return save ? run<true>(nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, 1, N, H,
                          nullptr, true)
              : run<false>(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, 1, N, H,
                           nullptr, true);
}

extern "C" const char* gru_seq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
