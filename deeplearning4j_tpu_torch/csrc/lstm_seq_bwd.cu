// LSTM backward through time (BPTT) for Hopper, sm_90a.
//
// Replaces deeplearning4j_tpu/kernels/lstm.py:_bwd_kernel (launched by
// _bwd_call). Same function, given the training forward's residuals:
//
//   dhs [T,N,H], dhT, dcT [N,H], gates [T,N,4H] (post-activation
//   i|f|g|o), cs [T,N,H], hs [T,N,H], R [H,4H], h0, c0 [N,H]
//   ->  dxw [T,N,4H], dR [H,4H], dh0, dc0 [N,H]
//
// walking t = T-1 .. 0 with dh = dhs_t + dz_{t+1} R^T (dhT at T-1) and
//   tc = tanh(c_t);  dc = dc + dh o (1 - tc^2);  dc_{t-1} = dc f
//   dz_t = [dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), dh tc o(1-o)]
//   dR = sum_t h_{t-1}^T dz_t;  dh0 = dz_0 R^T;  dc0 = dc f at t = 0
//
// What bounds it on this card. The dz R^T chain and dR are each
// 2*T*N*H*4H multiply-adds: at T=100, N=32, H=256 that is 3.4 GFLOP of
// f32 FMA, 0.050 ms on the non-tensor f32 pipe (67 TFLOP/s), against
// 38 MB of dhs, gates, cs, hs, dxw, R and dR read or written once,
// 0.011 ms at 3.35 TB/s. Neither bounds it at such batches: the T serial
// steps do, each one a grid-wide barrier plus a dependent chain over 4H,
// as in the forward.
//
// Design. The TPU kernel carries dh, dc and a dR accumulator in VMEM across
// a sequential grid. Here the work splits in two kernels on one stream:
//
// 1. The sweep: one cooperative launch walks t downwards, with a grid
//    barrier between steps, mirroring the forward. A block owns 32 hidden
//    units k (one per lane) and keeps the rows R[k-slice, :] ([32, 4H],
//    128 KiB at H=256) in shared memory, transposed so that lanes read
//    consecutive words. Each step it stages the dz_{t+1} rows of its row
//    tile from dxw through L2 (__ldcg: other blocks wrote them during this
//    launch), sums dz_{t+1} R^T for its cells, and forms the four dz
//    columns of its units. Each (n, k) cell belongs to one thread for the
//    whole sweep, so the dc carry lives in dc0 (read and written only by
//    its owner) and needs no exchange. One more phase after t = 0 writes
//    dh0 = dz_0 R^T. As in the forward, the 8 warps of a block split the
//    sum over j into KSPLIT parts at small batches.
// 2. dR: a tiled product [H, T*N] x [T*N, 4H] of the shifted hs (h0 for
//    t = 0) and dxw. A block owns a 32 x 64 tile of dR and sums over T*N
//    in a fixed order, with no atomics, so two runs give the same bits.
//    Plain f32 FMA; tensor cores are left for later work.
//
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
// partial sums of every warp: [kWarps][kRowsPerWarp][32]
constexpr int kRedFloats = kWarps * kRowsPerWarp * 32;

template <int KSPLIT>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_sweep_kernel(const float* __restrict__ dhs,
                      const float* __restrict__ dhT,
                      const float* __restrict__ dcT,
                      const float* __restrict__ gates,
                      const float* __restrict__ cs,
                      const float* __restrict__ r,
                      const float* __restrict__ c0,
                      float* dxw, float* __restrict__ dh0, float* dc0,
                      int T, int N, int H, int unit_tiles, int row_groups) {
  constexpr int kRows = kMaxRows / KSPLIT;   // rows per tile
  const int four_h = 4 * H;
  extern __shared__ float smem[];
  float* r_s = smem;                               // [4H][kUnits]
  float* red = r_s + (size_t)four_h * kUnits;      // [kWarps][2][32]
  float* dz_s = red + kRedFloats;                  // [kRows][4H]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ks = warp % KSPLIT;               // this warp's part of j
  const int row_warp = warp / KSPLIT;         // this warp's rows in a tile
  const int unit_tile = blockIdx.x % unit_tiles;
  const int group = blockIdx.x / unit_tiles;
  const int k = unit_tile * kUnits + lane;
  const bool k_ok = k < H;
  const int j_chunk = (four_h + KSPLIT - 1) / KSPLIT;
  const int j_begin = ks * j_chunk;
  const int j_end = min(four_h, j_begin + j_chunk);

  // r_s[j][u] = R[unit_tile * 32 + u, j]: read along j (coalesced), stored
  // so that the 32 lanes read 32 consecutive words in the loop below
  for (int idx = threadIdx.x; idx < kUnits * four_h; idx += kThreads) {
    const int u = idx / four_h;
    const int j = idx % four_h;
    const int kg = unit_tile * kUnits + u;
    r_s[j * kUnits + u] = kg < H ? r[(size_t)kg * four_h + j] : 0.0f;
  }

  cg::grid_group grid = cg::this_grid();
  const int row_tiles = (N + kRows - 1) / kRows;
  const size_t nh = (size_t)N * H;
  const size_t n4h = (size_t)N * four_h;

  // t = T-1 .. 0 are the steps; t = -1 only sums dz_0 R^T into dh0
  for (int t = T - 1; t >= -1; --t) {
    const bool have_next = t + 1 < T;   // dz_{t+1} exists
    const float* dz_next = dxw + (size_t)(t + 1) * n4h;

    for (int rt = group; rt < row_tiles; rt += row_groups) {
      const int n0 = rt * kRows;
      const int r0w = row_warp * kRowsPerWarp;   // first row in the tile
      float acc[kRowsPerWarp];
#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) acc[q] = 0.0f;

      if (have_next) {   // block-uniform
        __syncthreads();  // R staged; previous tile's readers of dz_s done
        for (int idx = threadIdx.x; idx < kRows * four_h; idx += kThreads) {
          const int n = n0 + idx / four_h;
          dz_s[idx] = n < N ? __ldcg(dz_next + (size_t)n * four_h
                                     + idx % four_h)
                            : 0.0f;
        }
        __syncthreads();
        if (n0 + r0w < N) {   // warp-uniform: skip tiles' padding rows
          const float* dz_row = dz_s + (size_t)r0w * four_h;
#pragma unroll 4
          for (int j = j_begin; j < j_end; ++j) {
            const float rv = r_s[j * kUnits + lane];
#pragma unroll
            for (int q = 0; q < kRowsPerWarp; ++q)
              acc[q] = fmaf(dz_row[q * four_h + j], rv, acc[q]);
          }
        }
        if constexpr (KSPLIT > 1) {
          float* mine = red + warp * (kRowsPerWarp * 32) + lane;
#pragma unroll
          for (int q = 0; q < kRowsPerWarp; ++q) mine[q * 32] = acc[q];
          __syncthreads();
          if (ks != 0) continue;   // the ks == 0 warp finishes the rows
#pragma unroll
          for (int s = 1; s < KSPLIT; ++s) {
            const float* part = red + (warp + s) * (kRowsPerWarp * 32) + lane;
#pragma unroll
            for (int q = 0; q < kRowsPerWarp; ++q) acc[q] += part[q * 32];
          }
        }
      } else if (ks != 0) {
        continue;
      }

#pragma unroll
      for (int q = 0; q < kRowsPerWarp; ++q) {
        const int n = n0 + r0w + q;
        if (n >= N || !k_ok) continue;
        const size_t cell = (size_t)n * H + k;
        if (t < 0) {
          dh0[cell] = acc[q];
          continue;
        }
        const float dh = dhs[(size_t)t * nh + cell]
                         + (have_next ? acc[q] : dhT[cell]);
        const float* g_t = gates + (size_t)t * n4h + (size_t)n * four_h + k;
        const float i_g = g_t[0];
        const float f_g = g_t[H];
        const float g_g = g_t[2 * H];
        const float o_g = g_t[3 * H];
        const float c = cs[(size_t)t * nh + cell];
        const float c_prev = t == 0 ? c0[cell] : cs[(size_t)(t - 1) * nh + cell];
        const float dc_in = have_next ? dc0[cell] : dcT[cell];
        const float tc = tanhf(c);
        const float d_o = dh * tc;
        const float dc = dc_in + dh * o_g * (1.0f - tc * tc);
        float* dz = dxw + (size_t)t * n4h + (size_t)n * four_h + k;
        dz[0] = dc * g_g * i_g * (1.0f - i_g);
        dz[H] = dc * c_prev * f_g * (1.0f - f_g);
        dz[2 * H] = dc * i_g * (1.0f - g_g * g_g);
        dz[3 * H] = d_o * o_g * (1.0f - o_g);
        dc0[cell] = dc * f_g;   // the carry; dc0 itself after t = 0
      }
    }
    if (t >= 0) grid.sync();
  }
}

// dR[k, j] = sum over m = t*N + n of hprev[m, k] * dxw[m, j], where
// hprev[m] is h0[n] for t = 0 and hs[t-1][n] after. 32 x 64 tiles of dR,
// 256 threads, each owning 4 rows k and 2 columns j; m in steps of 32.
constexpr int kDrBM = 32;
constexpr int kDrBN = 64;
constexpr int kDrBK = 32;
constexpr int kDrThreads = 256;

__global__ void __launch_bounds__(kDrThreads)
lstm_bwd_dr_kernel(const float* __restrict__ hs,
                   const float* __restrict__ h0,
                   const float* __restrict__ dxw, float* __restrict__ dr,
                   int M, int N, int H) {
  __shared__ float a_s[kDrBK][kDrBM];
  __shared__ float b_s[kDrBK][kDrBN];
  const int four_h = 4 * H;
  const int tx = threadIdx.x % 32;   // columns tx, tx + 32
  const int ty = threadIdx.x / 32;   // rows 4 ty .. 4 ty + 3
  const int k0 = blockIdx.y * kDrBM;
  const int j0 = blockIdx.x * kDrBN;
  float acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;

  for (int m0 = 0; m0 < M; m0 += kDrBK) {
    for (int e = threadIdx.x; e < kDrBK * kDrBM; e += kDrThreads) {
      const int mm = e / kDrBM, kk = e % kDrBM;
      const int m = m0 + mm, kg = k0 + kk;
      float v = 0.0f;
      if (m < M && kg < H)
        v = m < N ? h0[(size_t)m * H + kg] : hs[(size_t)(m - N) * H + kg];
      a_s[mm][kk] = v;
    }
    for (int e = threadIdx.x; e < kDrBK * kDrBN; e += kDrThreads) {
      const int mm = e / kDrBN, jj = e % kDrBN;
      const int m = m0 + mm, j = j0 + jj;
      b_s[mm][jj] = (m < M && j < four_h) ? dxw[(size_t)m * four_h + j]
                                          : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kDrBK; ++mm) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[mm][ty * 4 + i];
      const float b0 = b_s[mm][tx], b1 = b_s[mm][tx + 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a[i], b0, acc[i][0]);
        acc[i][1] = fmaf(a[i], b1, acc[i][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kg = k0 + ty * 4 + i;
    if (kg >= H) continue;
    if (j0 + tx < four_h) dr[(size_t)kg * four_h + j0 + tx] = acc[i][0];
    if (j0 + tx + 32 < four_h)
      dr[(size_t)kg * four_h + j0 + tx + 32] = acc[i][1];
  }
}

size_t sweep_smem_bytes(int H, int ksplit) {
  return ((size_t)4 * H * kUnits + kRedFloats +
          (size_t)(kMaxRows / ksplit) * 4 * H) * sizeof(float);
}

constexpr int kNotOneWave = -4;

// Launch the KSPLIT sweep. Unless `force`, only when all its row tiles fit
// in one co-resident wave (else kNotOneWave, and nothing runs). With `dry`,
// only the checks: 0 where the launch would go ahead.
template <int KSPLIT>
int launch_sweep(const float* dhs, const float* dhT, const float* dcT,
                 const float* gates, const float* cs, const float* r,
                 const float* c0, float* dxw, float* dh0, float* dc0, int T,
                 int N, int H, int sms, int smem_optin, cudaStream_t stream,
                 bool force, bool dry) {
  const size_t smem = sweep_smem_bytes(H, KSPLIT);
  if (smem > (size_t)smem_optin) return -1;
  auto kernel = lstm_bwd_sweep_kernel<KSPLIT>;
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
  void* args[] = {(void*)&dhs, (void*)&dhT, (void*)&dcT, (void*)&gates,
                  (void*)&cs, (void*)&r, (void*)&c0,
                  (void*)&dxw, (void*)&dh0, (void*)&dc0,
                  (void*)&T, (void*)&N, (void*)&H,
                  (void*)&unit_tiles, (void*)&row_groups};
  err = cudaLaunchCooperativeKernel((void*)kernel,
                                    dim3(unit_tiles * row_groups),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The reverse sweep, or with `dry` only its checks; codes as below.
int sweep(const float* dhs, const float* dhT, const float* dcT,
          const float* gates, const float* cs, const float* r,
          const float* c0, float* dxw, float* dh0, float* dc0, int T, int N,
          int H, cudaStream_t st, bool dry) {
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
  // the largest split whose row tiles all fit in one co-resident wave;
  // KSPLIT=1 otherwise, looping over row tiles
  int rc = launch_sweep<8>(dhs, dhT, dcT, gates, cs, r, c0, dxw, dh0, dc0,
                           T, N, H, sms, smem_optin, st, false, dry);
  if (rc == kNotOneWave)
    rc = launch_sweep<4>(dhs, dhT, dcT, gates, cs, r, c0, dxw, dh0, dc0, T,
                         N, H, sms, smem_optin, st, false, dry);
  if (rc == kNotOneWave)
    rc = launch_sweep<2>(dhs, dhT, dcT, gates, cs, r, c0, dxw, dh0, dc0, T,
                         N, H, sms, smem_optin, st, false, dry);
  if (rc == kNotOneWave)
    rc = launch_sweep<1>(dhs, dhT, dcT, gates, cs, r, c0, dxw, dh0, dc0, T,
                         N, H, sms, smem_optin, st, true, dry);
  return rc;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for the R rows in shared memory on this device;
// -2: the grid cannot be made co-resident for a cooperative launch;
// -3: an empty dimension.
extern "C" int lstm_seq_bwd_f32(const float* dhs, const float* dhT,
                                const float* dcT, const float* gates,
                                const float* cs, const float* hs,
                                const float* r, const float* h0,
                                const float* c0, float* dxw, float* dr,
                                float* dh0, float* dc0, int T, int N, int H,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = sweep(dhs, dhT, dcT, gates, cs, r, c0, dxw, dh0, dc0, T, N,
                       H, st, false);
  if (rc != 0) return rc;
  const int M = T * N;
  dim3 grid((4 * H + kDrBN - 1) / kDrBN, (H + kDrBM - 1) / kDrBM);
  lstm_bwd_dr_kernel<<<grid, kDrThreads, 0, st>>>(hs, h0, dxw, dr, M, N, H);
  return cudaGetLastError();
}

// Whether lstm_seq_bwd_f32 would launch at batch N and width H on the
// current device: the sweep's checks, and nothing launched. 0 if it
// would, else the code it would return. The wrappers choose the route
// with it, before any launch.
extern "C" int lstm_seq_bwd_fits(int N, int H) {
  return sweep(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, 1, N, H, nullptr, true);
}

// The dR pass alone, from a dxw that a reverse sweep wrote (the step
// route's, csrc/rnn_step.cu, for the widths this sweep does not take).
// Same codes.
extern "C" int lstm_seq_bwd_dr_f32(const float* hs, const float* h0,
                                   const float* dxw, float* dr, int T, int N,
                                   int H, void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  dim3 grid((4 * H + kDrBN - 1) / kDrBN, (H + kDrBM - 1) / kDrBM);
  lstm_bwd_dr_kernel<<<grid, kDrThreads, 0, (cudaStream_t)stream>>>(
      hs, h0, dxw, dr, T * N, N, H);
  return cudaGetLastError();
}

extern "C" const char* lstm_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
