// GRU (reset-after) backward through time (BPTT) for Hopper, sm_90a.
//
// Replaces deeplearning4j_tpu/kernels/gru.py:_bwd_kernel (launched by
// _bwd_call). Same function, given the training forward's residuals:
//
//   dhs [T,N,H], dhT [N,H], ru [T,N,2H] (post-sigmoid r|u), rz_c, cand,
//   hs [T,N,H], R [H,3H], h0 [N,H]
//   ->  dxw [T,N,3H], dR [H,3H], drb [3H], dh0 [N,H]
//
// walking t = T-1 .. 0 with dh = dhs_t + carry (dhT at T-1), h_prev the
// previous step's h (h0 at t = 0), and
//   dcand = dh (1-u);  du = dh (h_prev - cand);  dc = dcand (1 - cand^2)
//   dr = dc rz_c r (1-r);  dU = du u (1-u)
//   dxw_t = [dr, dU, dc]            (the input side)
//   drz_t = [dr, dU, dc r]          (the recurrent side)
//   carry = dh u + drz_t R^T;  dh0 = the carry after t = 0
//   dR = sum_t h_prev^T drz_t;  drb = sum_t,n drz_t
//
// The two dz differ in the candidate column, and dR, drb and the carry
// sum drz, not dxw: the sweep writes both, drz into a [T,N,3H] scratch
// that the wrapper allocates, which the next step and the dR pass read.
//
// What bounds it on this card. The drz R^T chain and dR are each
// 2*T*N*H*3H multiply-adds: at the training shape T=100, N=64, H=1024
// that is 80.5 GFLOP of f32 FMA, 1.20 ms on the non-tensor f32 pipe
// (67 TFLOP/s), against 0.36 GB of inputs and outputs read or written
// once, 0.11 ms at 3.35 TB/s: operations bound it. At N <= 32 the T
// serial steps do, each one a grid-wide barrier.
//
// Design. The TPU kernel carries dh and the dR, drb accumulators in VMEM
// across a sequential grid. Here the work splits in two kernels on one
// stream:
//
// 1. The sweep: one cooperative launch walks t downwards, with a grid
//    barrier between steps, mirroring the forward. A block owns kUnits = 8
//    hidden units k and keeps their rows of R in shared memory, unit-major
//    ([8][3H]): 96 KiB at H=1024 (the LSTM sweep's 32 rows plus a staged
//    dz tile would need over 600 KiB there), so two blocks fit on an SM
//    and ceil(H/8) = 128 unit slices are co-resident twice over. Each warp
//    takes RW rows of a row tile (RW = 1, 2 or 4 by N); its lanes split j
//    in runs of 4 (j = 4 lane + 128 i, as float4) and read drz_{t+1}[n, j]
//    straight from L2 (__ldcg: other blocks wrote it during this launch;
//    no row is read by two warps of a block, so staging it in shared
//    memory would save nothing). A lane reads its 8 units' R values once
//    for all RW rows (the first version took one row per warp and so read
//    the whole R slice from shared memory for every row, which bounded
//    it). A reduce-scatter butterfly of warp shuffles
//    adds the 32 lanes' parts, leaving each (row, unit) sum in its own
//    lane, which finishes cell (n, k). Each cell belongs to one thread for
//    the whole sweep, so the carry dh u lives in dh0 (read and written
//    only by its owner) and needs no exchange. One more phase after t = 0
//    adds drz_0 R^T into dh0.
// 2. dR and drb: a tiled product [H, T*N] x [T*N, 3H] of the shifted hs
//    (h0 for t = 0) and drz. A block owns a 128 x 128 tile of dR, each of
//    its 256 threads an 8 x 8 register tile, and sums over T*N in steps of
//    16 in a fixed order, with no atomics, so two runs give the same bits;
//    two shared-memory buffers let the next step's loads overlap this
//    step's sums. Two blocks fit on an SM (at most 128 registers, a few
//    spilled), so the 192 tiles at H=1024 run in one wave on 132 SMs;
//    scripts/gru_dr_bounds_ab.py times this against one block per SM.
//    The blocks of the first row of tiles also sum their drz columns from
//    the staged tiles into drb, in the same fixed order. Plain f32 FMA;
//    tensor cores are left for later work (f32 parity must hold).
//
// The ragged edges in N and H are masked; no shape alignment is needed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 8;                    // hidden units per block
constexpr int kWarps = 8;                    // rows per row tile
constexpr int kThreads = kWarps * 32;

// RW rows per warp; VEC consecutive columns j per lane and load (4 when
// H % 4 == 0, so that drz rows and R rows are read as float4).
template <int RW, int VEC>
__global__ void __launch_bounds__(kThreads)
gru_bwd_sweep_kernel(const float* __restrict__ dhs,
                     const float* __restrict__ dhT,
                     const float* __restrict__ ru,
                     const float* __restrict__ rzc,
                     const float* __restrict__ cand,
                     const float* __restrict__ hs,
                     const float* __restrict__ r,
                     const float* __restrict__ h0,
                     float* __restrict__ dxw, float* drz, float* dh0,
                     int T, int N, int H, int unit_tiles, int row_groups) {
  constexpr int kTile = kWarps * RW;         // rows per row tile
  constexpr int C = RW * kUnits;             // sums per warp
  constexpr int kSpread = 32 / C;            // lanes holding each sum
  using VecT = typename std::conditional<VEC == 4, float4, float>::type;
  const int three_h = 3 * H;
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);   // [kUnits][3H]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int unit_tile = blockIdx.x % unit_tiles;
  const int group = blockIdx.x / unit_tiles;
  const int k0 = unit_tile * kUnits;

  // r_s[u * 3H + j] = R[k0 + u, j]: unit-major, so that the lanes' loads
  // of consecutive j are consecutive words (no bank conflicts)
  for (int idx = threadIdx.x; idx < kUnits * three_h; idx += kThreads) {
    const int kg = k0 + idx / three_h;
    r_s[idx] = kg < H ? r[(size_t)kg * three_h + idx % three_h] : 0.0f;
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const int row_tiles = (N + kTile - 1) / kTile;
  const size_t nh = (size_t)N * H;
  const size_t n3h = (size_t)N * three_h;

  // t = T-1 .. 0 are the steps; t = -1 only adds drz_0 R^T into dh0
  for (int t = T - 1; t >= -1; --t) {
    const bool have_next = t + 1 < T;   // drz_{t+1} exists
    for (int rt = group; rt < row_tiles; rt += row_groups) {
      const int nb = rt * kTile + warp * RW;   // this warp's first row
      if (nb >= N) continue;                   // warp-uniform
      float acc[C];
#pragma unroll
      for (int i = 0; i < C; ++i) acc[i] = 0.0f;
      if (have_next) {
        const float* d_t = drz + (size_t)(t + 1) * n3h;
#pragma unroll 2
        for (int j = VEC * lane; j < three_h; j += 32 * VEC) {
          float rv[kUnits][VEC];
#pragma unroll
          for (int u = 0; u < kUnits; ++u) {
            const VecT w = *reinterpret_cast<const VecT*>(
                r_s + (size_t)u * three_h + j);
            if constexpr (VEC == 4) {
              rv[u][0] = w.x; rv[u][1] = w.y; rv[u][2] = w.z; rv[u][3] = w.w;
            } else {
              rv[u][0] = w;
            }
          }
#pragma unroll
          for (int q = 0; q < RW; ++q) {
            float d[VEC];
            if (nb + q < N) {
              const VecT x = __ldcg(reinterpret_cast<const VecT*>(
                  d_t + (size_t)(nb + q) * three_h + j));
              if constexpr (VEC == 4) {
                d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
              } else {
                d[0] = x;
              }
            } else {
#pragma unroll
              for (int e = 0; e < VEC; ++e) d[e] = 0.0f;
            }
#pragma unroll
            for (int u = 0; u < kUnits; ++u)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[q * kUnits + u] = fmaf(d[e], rv[u][e],
                                           acc[q * kUnits + u]);
          }
        }
      }
      warp_reduce_scatter<C>(acc, lane);
      const float s = acc[0];
      if (lane % kSpread != 0) continue;
      const int q = (lane / kSpread) / kUnits;
      const int k = k0 + (lane / kSpread) % kUnits;
      const int n = nb + q;
      if (n >= N || k >= H) continue;
      const size_t cell = (size_t)n * H + k;
      if (t < 0) {
        dh0[cell] = dh0[cell] + s;
        continue;
      }
      const float dh = dhs[(size_t)t * nh + cell] +
                       (have_next ? dh0[cell] + s : dhT[cell]);
      const float* ru_t = ru + (size_t)t * N * 2 * H + (size_t)n * 2 * H + k;
      const float rg = ru_t[0];
      const float ug = ru_t[H];
      const float c = cand[(size_t)t * nh + cell];
      const float rz_c = rzc[(size_t)t * nh + cell];
      const float hp = t == 0 ? h0[cell] : hs[(size_t)(t - 1) * nh + cell];
      const float dcand = dh * (1.0f - ug);
      const float du = dh * (hp - c);
      const float dc = dcand * (1.0f - c * c);
      const float dr = dc * rz_c * rg * (1.0f - rg);
      const float dU = du * ug * (1.0f - ug);
      const size_t row = (size_t)t * n3h + (size_t)n * three_h + k;
      dxw[row] = dr;
      dxw[row + H] = dU;
      dxw[row + 2 * H] = dc;
      drz[row] = dr;
      drz[row + H] = dU;
      drz[row + 2 * H] = dc * rg;
      dh0[cell] = dh * ug;   // the carry's local part; dh0 after t = -1
    }
    if (t >= 0) grid.sync();
  }
}

// dR[k, j] = sum over m = t*N + n of hprev[m, k] * drz[m, j], where
// hprev[m] is h0[n] for t = 0 and hs[t-1][n] after; drb[j] = sum over m
// of drz[m, j]. 128 x 128 tiles of dR; thread (ty, tx) of 16 x 16 owns
// rows {4 ty + i, 64 + 4 ty + i} and columns {4 tx + i, 64 + 4 tx + i}.
// m runs in steps of kDrBK through two shared-memory buffers: the next
// step's tiles are loaded into registers while this step's are summed, so
// one barrier per step suffices and the loads' latency is hidden.
constexpr int kDrBM = 128;
constexpr int kDrBN = 128;
constexpr int kDrBK = 16;
constexpr int kDrThreads = 256;
constexpr int kDrLoads = kDrBK * kDrBM / kDrThreads;   // per thread, = BN

// two blocks per SM: the 192 tiles of dR at H=1024 then run in one wave
__global__ void __launch_bounds__(kDrThreads, 2)
gru_bwd_dr_kernel(const float* __restrict__ hs,
                  const float* __restrict__ h0,
                  const float* __restrict__ drz, float* __restrict__ dr,
                  float* __restrict__ drb, int M, int N, int H) {
  __shared__ __align__(16) float a_s[2][kDrBK][kDrBM];
  __shared__ __align__(16) float b_s[2][kDrBK][kDrBN];
  const int three_h = 3 * H;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.y * kDrBM;
  const int j0 = blockIdx.x * kDrBN;
  const bool sums_bias = blockIdx.y == 0 && threadIdx.x < kDrBN;
  float bias_acc = 0.0f;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  // element e = threadIdx.x + kDrThreads * l of a tile is row e / 128,
  // column e % 128: consecutive threads, consecutive addresses
  float a_reg[kDrLoads], b_reg[kDrLoads];
  auto load = [&](int m0) {
#pragma unroll
    for (int l = 0; l < kDrLoads; ++l) {
      const int e = threadIdx.x + kDrThreads * l;
      const int m = m0 + e / kDrBM;
      const int kg = k0 + e % kDrBM, j = j0 + e % kDrBN;
      float a = 0.0f, b = 0.0f;
      if (m < M) {
        if (kg < H)
          a = m < N ? h0[(size_t)m * H + kg] : hs[(size_t)(m - N) * H + kg];
        if (j < three_h) b = drz[(size_t)m * three_h + j];
      }
      a_reg[l] = a;
      b_reg[l] = b;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int l = 0; l < kDrLoads; ++l) {
      const int e = threadIdx.x + kDrThreads * l;
      a_s[buf][e / kDrBM][e % kDrBM] = a_reg[l];
      b_s[buf][e / kDrBN][e % kDrBN] = b_reg[l];
    }
  };

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int m0 = 0; m0 < M; m0 += kDrBK, buf ^= 1) {
    const bool more = m0 + kDrBK < M;
    if (more) load(m0 + kDrBK);
    if (sums_bias) {
#pragma unroll
      for (int mm = 0; mm < kDrBK; ++mm) bias_acc += b_s[buf][mm][threadIdx.x];
    }
#pragma unroll
    for (int mm = 0; mm < kDrBK; ++mm) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&a_s[buf][mm][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&a_s[buf][mm][64 + 4 * ty]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&b_s[buf][mm][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&b_s[buf][mm][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    // the other buffer was last read before the previous barrier
    if (more) store(buf ^ 1);
    __syncthreads();
  }
  if (sums_bias && j0 + threadIdx.x < three_h) drb[j0 + threadIdx.x] = bias_acc;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kg = k0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (kg >= H) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + (c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4);
      if (j < three_h) dr[(size_t)kg * three_h + j] = acc[i][c];
    }
  }
}

size_t sweep_smem_bytes(int H) {
  return (size_t)3 * H * kUnits * sizeof(float);
}

// With `dry`, only the checks: 0 where the launch would go ahead.
template <int RW, int VEC>
int launch_sweep(const float* dhs, const float* dhT, const float* ru,
                 const float* rzc, const float* cand, const float* hs,
                 const float* r, const float* h0, float* dxw, float* drz,
                 float* dh0, int T, int N, int H, int sms, int smem_optin,
                 cudaStream_t st, bool dry) {
  const size_t smem = sweep_smem_bytes(H);
  if (smem > (size_t)smem_optin) return -1;
  auto kernel = gru_bwd_sweep_kernel<RW, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  const int capacity = per_sm * sms;
  int unit_tiles = (H + kUnits - 1) / kUnits;
  const int tile = kWarps * RW;
  const int row_tiles = (N + tile - 1) / tile;
  if (capacity < unit_tiles) return -2;
  int row_groups = capacity / unit_tiles;
  if (row_groups > row_tiles) row_groups = row_tiles;
  if (dry) return 0;
  void* args[] = {(void*)&dhs, (void*)&dhT, (void*)&ru, (void*)&rzc,
                  (void*)&cand, (void*)&hs, (void*)&r, (void*)&h0,
                  (void*)&dxw, (void*)&drz, (void*)&dh0,
                  (void*)&T, (void*)&N, (void*)&H,
                  (void*)&unit_tiles, (void*)&row_groups};
  err = cudaLaunchCooperativeKernel((void*)kernel,
                                    dim3(unit_tiles * row_groups),
                                    dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// RW rows per warp: 1 up to N = 8, 2 up to 16, else 4 (tiles of 8, 16, 32
// rows); float4 columns when H % 4 == 0.
template <int VEC>
int run_sweep(const float* dhs, const float* dhT, const float* ru,
              const float* rzc, const float* cand, const float* hs,
              const float* r, const float* h0, float* dxw, float* drz,
              float* dh0, int T, int N, int H, int sms, int smem_optin,
              cudaStream_t st, bool dry) {
#define GRU_SWEEP(RW_)                                                      \
  launch_sweep<RW_, VEC>(dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, drz, dh0, \
                         T, N, H, sms, smem_optin, st, dry)
  if (N <= kWarps) return GRU_SWEEP(1);
  if (N <= 2 * kWarps) return GRU_SWEEP(2);
  return GRU_SWEEP(4);
#undef GRU_SWEEP
}

void launch_dr(const float* hs, const float* h0, const float* drz,
               float* dr, float* drb, int T, int N, int H,
               cudaStream_t st) {
  dim3 grid((3 * H + kDrBN - 1) / kDrBN, (H + kDrBM - 1) / kDrBM);
  gru_bwd_dr_kernel<<<grid, kDrThreads, 0, st>>>(hs, h0, drz, dr, drb,
                                                  T * N, N, H);
}

// The reverse sweep, or with `dry` only its checks; codes as below.
int sweep(const float* dhs, const float* dhT, const float* ru,
          const float* rzc, const float* cand, const float* hs,
          const float* r, const float* h0, float* dxw, float* drz,
          float* dh0, int T, int N, int H, cudaStream_t st, bool dry) {
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
  return H % 4 == 0
             ? run_sweep<4>(dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, drz,
                            dh0, T, N, H, sms, smem_optin, st, dry)
             : run_sweep<1>(dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, drz,
                            dh0, T, N, H, sms, smem_optin, st, dry);
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for the R rows in shared memory on this device;
// -2: the grid cannot be made co-resident for a cooperative launch;
// -3: an empty dimension.
extern "C" int gru_seq_bwd_f32(const float* dhs, const float* dhT,
                               const float* ru, const float* rzc,
                               const float* cand, const float* hs,
                               const float* r, const float* h0, float* dxw,
                               float* drz, float* dr, float* drb,
                               float* dh0, int T, int N, int H,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rc = sweep(dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, drz, dh0, T,
                       N, H, st, false);
  if (rc != 0) return rc;
  launch_dr(hs, h0, drz, dr, drb, T, N, H, st);
  return cudaGetLastError();
}

// Whether gru_seq_bwd_f32 would launch at batch N and width H on the
// current device: the sweep's checks, and nothing launched. 0 if it
// would, else the code it would return. The wrappers choose the route
// with it, before any launch.
extern "C" int gru_seq_bwd_fits(int N, int H) {
  return sweep(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, nullptr, 1, N, H, nullptr,
               true);
}

// The dR, drb pass alone, from a drz that gru_seq_bwd_f32 wrote: lets a
// measurement time the two passes apart. Same codes.
extern "C" int gru_seq_bwd_dr_f32(const float* hs, const float* h0,
                                  const float* drz, float* dr, float* drb,
                                  int T, int N, int H, void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  launch_dr(hs, h0, drz, dr, drb, T, N, H, (cudaStream_t)stream);
  return cudaGetLastError();
}

extern "C" const char* gru_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
