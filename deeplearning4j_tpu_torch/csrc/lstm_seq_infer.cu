// LSTM recurrence forward for Hopper, sm_90a: two entry points that share
// one kernel body, told apart by the compile-time flag kSave.
//
// lstm_seq_infer_f32 (kSave = false) replaces
// deeplearning4j_tpu/kernels/lstm.py:_fwd_infer_kernel (launched by
// _fwd_call with save_residuals=False):
//
//   xw [T,N,4H] f32 (input projection, bias and forgetBias folded in),
//   R [H,4H], h0, c0 [N,H]  ->  hs [T,N,H], hT, cT [N,H]
//   z = xw_t + h_{t-1} R;  gates i,f,g,o = sig, sig, tanh, sig;
//   c = f c + i g;  h = o tanh(c)
//
// lstm_seq_fwd_f32 (kSave = true) replaces _fwd_kernel (launched by
// _fwd_call with save_residuals=True), the training forward: the same
// recurrence, writing the residuals the backward needs instead of hT, cT:
//
//   -> hs [T,N,H], gates [T,N,4H] (post-activation i|f|g|o), cs [T,N,H]
//
// The residuals add 5 stores per cell and step (4 gates and c) to the 1
// of hs; at T=100, N=32, H=256 they are 16.4 MB on top of xw's 13.1 MB,
// small beside the serial steps that bound the kernel at such batches.
//
// What bounds it on this card. Each step is an [N,H]x[H,4H] product plus
// gates, and step t needs every h_{t-1}. At N=1024, H=256, T=100 the
// products are 54 GFLOP of f32 FMA, which on the non-tensor f32 pipe
// (67 TFLOP/s) take 0.8 ms against 0.16 ms for the 0.5 GB of xw and hs:
// operations bound it. At serving batches (N <= 32) neither does: the T
// serial steps do, each one a grid-wide barrier plus a dependent chain
// of multiply-adds over H.
//
// Design (one launch per sequence, as on the TPU):
// - A block owns 32 hidden units j (one per lane) with all four gate
//   columns of them, and keeps that [H, 4*32] slice of R in shared memory
//   for the whole sequence: the TPU kernel kept R resident in VMEM, here
//   no single SM can hold R (1 MiB at H=256), so it is split by columns
//   across blocks and never re-read from device memory.
// - Blocks with the same unit slice split the rows n into tiles; a block
//   loops over its row tiles. Each (n, j) cell belongs to one thread for
//   the whole sequence, so c lives in cT (read and written only by its
//   owner) and needs no exchange.
// - Each step a block stages h_{t-1} rows from hs[t-1] (or h0) in shared
//   memory, accumulates its 4 gate sums in f32 FMA (no TF32, no tensor
//   cores), applies the gates and writes hs[t]. A cooperative grid
//   barrier (cooperative_groups::this_grid().sync()) separates steps;
//   the grid is sized from the occupancy so all blocks are co-resident.
// - Small batches leave most of the grid idle and make each step one long
//   dependent chain of H multiply-adds. So the 8 warps of a block split
//   the sum over k into KSPLIT parts (KSPLIT in 1, 2, 4, 8) and add the
//   partial sums through shared memory; a tile then has 16/KSPLIT rows,
//   and more tiles spread over more blocks. The wrapper takes the largest
//   KSPLIT whose tiles all fit in one co-resident wave; large batches
//   (N=1024) keep KSPLIT=1.
// - h_{t-1} is written by other blocks during this launch, so it is read
//   with __ldcg (L2, never a stale L1 line).
// The ragged edges in N and H are masked; no shape alignment is needed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 32;                   // hidden units per block
constexpr int kRowsPerWarp = 2;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // rows per tile, KSPLIT=1
// partial sums of every warp: [kWarps][kRowsPerWarp][4][32]
constexpr int kRedFloats = kWarps * kRowsPerWarp * 4 * 32;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// kSave: write gates and cs for the backward (training) instead of hT,
// cT; c_{t-1} is then read back from cs[t-1], else from cT.
template <int KSPLIT, bool kSave>
__global__ void __launch_bounds__(kThreads)
lstm_seq_kernel(const float* __restrict__ xw,
                const float* __restrict__ r,
                const float* __restrict__ h0,
                const float* __restrict__ c0,
                float* hs, float* __restrict__ hT, float* cT,
                float* __restrict__ gates, float* cs,
                int T, int N, int H, int unit_tiles, int row_groups) {
  constexpr int kRows = kMaxRows / KSPLIT;   // rows per tile
  extern __shared__ float smem[];
  float* r_s = smem;                          // [H][4 * kUnits]
  float* red = r_s + (size_t)H * 4 * kUnits;  // [kWarps][2][4][32]
  float* h_s = red + kRedFloats;              // [kRows][H]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ks = warp % KSPLIT;               // this warp's part of k
  const int row_warp = warp / KSPLIT;         // this warp's rows in a tile
  const int unit_tile = blockIdx.x % unit_tiles;
  const int group = blockIdx.x / unit_tiles;
  const int j = unit_tile * kUnits + lane;
  const bool j_ok = j < H;
  const size_t four_h = 4 * (size_t)H;
  const int k_chunk = (H + KSPLIT - 1) / KSPLIT;
  const int k_begin = ks * k_chunk;
  const int k_end = min(H, k_begin + k_chunk);

  for (int idx = threadIdx.x; idx < H * 4 * kUnits; idx += kThreads) {
    const int k = idx / (4 * kUnits);
    const int col = idx % (4 * kUnits);
    const int g = col / kUnits;
    const int jg = unit_tile * kUnits + col % kUnits;
    r_s[idx] = jg < H ? r[k * four_h + (size_t)g * H + jg] : 0.0f;
  }

  cg::grid_group grid = cg::this_grid();
  const int row_tiles = (N + kRows - 1) / kRows;
  const size_t nh = (size_t)N * H;

  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : hs + (size_t)(t - 1) * nh;
    const float* c_prev =
        t == 0 ? c0 : (kSave ? cs + (size_t)(t - 1) * nh : cT);
    const float* xw_t = xw + (size_t)t * N * four_h;
    float* h_out = hs + (size_t)t * nh;

    for (int rt = group; rt < row_tiles; rt += row_groups) {
      const int n0 = rt * kRows;
      __syncthreads();  // R staged; previous tile's readers of h_s done
      for (int idx = threadIdx.x; idx < kRows * H; idx += kThreads) {
        const int n = n0 + idx / H;
        h_s[idx] = n < N ? __ldcg(h_prev + (size_t)n * H + idx % H) : 0.0f;
      }
      __syncthreads();

      const int r0w = row_warp * kRowsPerWarp;   // first row in the tile
      float acc[kRowsPerWarp][4];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int n = n0 + r0w + q;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[q][g] = (ks == 0 && n < N && j_ok)
                          ? xw_t[(size_t)n * four_h + (size_t)g * H + j]
                          : 0.0f;
      }
      if (n0 + r0w < N) {   // warp-uniform: skip tiles' padding rows
        const float* h_row = h_s + r0w * H;
#pragma unroll 4
        for (int k = k_begin; k < k_end; ++k) {
          const float* rk = r_s + k * 4 * kUnits + lane;
          const float r0 = rk[0], r1 = rk[kUnits], r2 = rk[2 * kUnits],
                      r3 = rk[3 * kUnits];
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q) {
            const float hv = h_row[q * H + k];
            acc[q][0] = fmaf(hv, r0, acc[q][0]);
            acc[q][1] = fmaf(hv, r1, acc[q][1]);
            acc[q][2] = fmaf(hv, r2, acc[q][2]);
            acc[q][3] = fmaf(hv, r3, acc[q][3]);
          }
        }
      }
      if constexpr (KSPLIT > 1) {
        float* mine = red + warp * (kRowsPerWarp * 4 * 32) + lane;
#pragma unroll
        for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
          for (int g = 0; g < 4; ++g) mine[(q * 4 + g) * 32] = acc[q][g];
        __syncthreads();
        if (ks != 0) continue;   // the ks == 0 warp finishes the rows
#pragma unroll
        for (int s = 1; s < KSPLIT; ++s) {
          const float* part =
              red + (warp + s) * (kRowsPerWarp * 4 * 32) + lane;
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q)
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[q][g] += part[(q * 4 + g) * 32];
        }
      }
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int n = n0 + r0w + q;
        if (n >= N || !j_ok) continue;
        const size_t cell = (size_t)n * H + j;
        const float i_g = sigmoid(acc[q][0]);
        const float f_g = sigmoid(acc[q][1]);
        const float g_g = tanhf(acc[q][2]);
        const float o_g = sigmoid(acc[q][3]);
        const float c = f_g * c_prev[cell] + i_g * g_g;
        const float h = o_g * tanhf(c);
        if constexpr (kSave) {
          float* g_out = gates + (size_t)t * N * four_h + (size_t)n * four_h
                         + j;
          g_out[0] = i_g;
          g_out[H] = f_g;
          g_out[2 * H] = g_g;
          g_out[3 * H] = o_g;
          cs[(size_t)t * nh + cell] = c;
        } else {
          cT[cell] = c;
          if (t == T - 1) hT[cell] = h;
        }
        h_out[cell] = h;
      }
    }
    if (t + 1 < T) grid.sync();
  }
}

size_t smem_bytes(int H, int ksplit) {
  return ((size_t)H * 4 * kUnits + kRedFloats +
          (size_t)(kMaxRows / ksplit) * H) * sizeof(float);
}

constexpr int kNotOneWave = -4;

// Launch the KSPLIT variant. Unless `force`, only when all its row tiles
// fit in one co-resident wave (else kNotOneWave, and nothing runs). With
// `dry`, only the checks: 0 where the launch would go ahead.
template <int KSPLIT, bool kSave>
int launch(const float* xw, const float* r, const float* h0,
           const float* c0, float* hs, float* hT, float* cT, float* gates,
           float* cs, int T, int N, int H, int sms, int smem_optin,
           cudaStream_t stream, bool force, bool dry) {
  const size_t smem = smem_bytes(H, KSPLIT);
  if (smem > (size_t)smem_optin) return -1;
  auto kernel = lstm_seq_kernel<KSPLIT, kSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int capacity = per_sm * sms;
  const int unit_tiles = (H + kUnits - 1) / kUnits;
  const int rows = kMaxRows / KSPLIT;
  const int row_tiles = (N + rows - 1) / rows;
  if (!force && (long)row_tiles * unit_tiles > capacity) return kNotOneWave;
  if (capacity < unit_tiles) return -2;
  int row_groups = capacity / unit_tiles;
  if (row_groups > row_tiles) row_groups = row_tiles;
  if (dry) return 0;
  void* args[] = {(void*)&xw, (void*)&r, (void*)&h0, (void*)&c0,
                  (void*)&hs, (void*)&hT, (void*)&cT,
                  (void*)&gates, (void*)&cs,
                  (void*)&T, (void*)&N, (void*)&H,
                  (void*)&unit_tiles, (void*)&row_groups};
  err = cudaLaunchCooperativeKernel((void*)kernel,
                                    dim3(unit_tiles * row_groups),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The largest split whose row tiles all fit in one co-resident wave;
// KSPLIT=1 otherwise, looping over row tiles.
template <bool kSave>
int run(const float* xw, const float* r, const float* h0, const float* c0,
        float* hs, float* hT, float* cT, float* gates, float* cs, int T,
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
  int rc = launch<8, kSave>(xw, r, h0, c0, hs, hT, cT, gates, cs, T, N, H,
                            sms, smem_optin, st, false, dry);
  if (rc == kNotOneWave)
    rc = launch<4, kSave>(xw, r, h0, c0, hs, hT, cT, gates, cs, T, N, H,
                          sms, smem_optin, st, false, dry);
  if (rc == kNotOneWave)
    rc = launch<2, kSave>(xw, r, h0, c0, hs, hT, cT, gates, cs, T, N, H,
                          sms, smem_optin, st, false, dry);
  if (rc == kNotOneWave)
    rc = launch<1, kSave>(xw, r, h0, c0, hs, hT, cT, gates, cs, T, N, H,
                          sms, smem_optin, st, true, dry);
  return rc;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for the R slice in shared memory on this device;
// -2: the grid cannot be made co-resident for a cooperative launch;
// -3: an empty dimension.
extern "C" int lstm_seq_infer_f32(const float* xw, const float* r,
                                  const float* h0, const float* c0,
                                  float* hs, float* hT, float* cT,
                                  int T, int N, int H, void* stream) {
  return run<false>(xw, r, h0, c0, hs, hT, cT, nullptr, nullptr, T, N, H,
                    (cudaStream_t)stream, false);
}

// The training forward: hs, gates [T,N,4H] and cs [T,N,H]; same codes.
extern "C" int lstm_seq_fwd_f32(const float* xw, const float* r,
                                const float* h0, const float* c0,
                                float* hs, float* gates, float* cs,
                                int T, int N, int H, void* stream) {
  return run<true>(xw, r, h0, c0, hs, nullptr, nullptr, gates, cs, T, N, H,
                   (cudaStream_t)stream, false);
}

// Whether lstm_seq_infer_f32 (save = 0) or lstm_seq_fwd_f32 (save = 1)
// would launch at batch N and width H on the current device: the same
// checks, and nothing launched. 0 if it would, else the code it would
// return. The wrappers choose the route with it, before any launch.
extern "C" int lstm_seq_fits(int N, int H, int save) {
  return save ? run<true>(nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, nullptr, nullptr, nullptr, 1, N, H,
                          nullptr, true)
              : run<false>(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, 1, N, H,
                           nullptr, true);
}

extern "C" const char* lstm_seq_infer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
