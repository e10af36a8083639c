// The step route of the LSTM and GRU (reset-after) recurrences for Hopper,
// sm_90a: one ordinary launch per time step, for the hidden widths whose
// persistent kernels (lstm_seq_infer.cu, lstm_seq_bwd.cu, gru_seq.cu,
// gru_seq_bwd.cu) cannot keep their slice of R in shared memory or their
// grid co-resident. kernels/rnn_step.py picks the route by shape, before
// any launch, by asking each persistent source's *_fits entry (its own
// launch checks, with nothing launched).
//
// It replaces the same Pallas kernels as the persistent sources, where
// the JAX package runs them past its kernels' VMEM budget as a lax.scan
// (deeplearning4j_tpu/kernels/lstm.py:52-64, kernels/gru.py:41-47):
//
// - rnn_step_fwd_{lstm,gru}_f32: the forward (deeplearning4j_tpu/kernels/
//   lstm.py _fwd_infer_kernel and _fwd_kernel; kernels/gru.py likewise),
//   with the residual-saving flag `save` as the persistent forwards have
//   it. Layouts, gate order and the order of every sum are theirs:
//     LSTM  z = xw_t + h_{t-1} R;  c = f c + i g;  h = o tanh(c)
//     GRU   rz = h_{t-1} R + rb;  r, u = sigmoid(xw_ru + rz_ru)
//           cand = tanh(xw_c + r rz_c);  h = u h_{t-1} + (1 - u) cand
// - rnn_step_bwd_{lstm,gru}_f32: the reverse sweep of the backward
//   (_bwd_kernel); dR (and the GRU's drb) then come from the persistent
//   sources' fixed-order dR passes (lstm_seq_bwd_dr_f32,
//   gru_seq_bwd_dr_f32), which take any H.
//
// What bounds it on this card. Each step is an [N,H] x [H,G*H] product
// (G = 4 gates for the LSTM, 3 for the GRU) that reads all of R: 64 MiB
// at H=2048 for the LSTM, 48 MiB for the GRU, about the 50 MB of L2. At
// serving batches the T launches' R reads bound it (T * 4*G*H^2 bytes at
// 3.35 TB/s, if L2 keeps nothing); at N=64 the 2*N*H*G*H multiply-adds on
// the plain f32 pipe (67 TFLOP/s) come close.
//
// Design. No cooperative grid and no R in shared memory: a block owns 32
// hidden units (one per lane) and a tile of rows (ROWS = 64, 32 or 8, the
// largest whose grid still covers the SMs; RPW = ROWS/8 rows per warp),
// and sums over k in chunks of 32: the
// chunk's h rows and its [32, G*32] slice of R are staged in shared
// memory (R read from L2/HBM once per row tile), and each lane keeps
// RPW*G sums in registers. The step's pointwise math follows in the same
// thread, so each (n, j) cell belongs to one thread per launch; the
// LSTM's c and the GRU's dh*u carry live in [N,H] buffers that only the
// cell's owner reads and writes, at the same place in every launch.
// The backward's launch for step t first forms the carry dz_{t+1} R^T
// (the sum over G*H runs in chunks of 32 columns of R, staged
// transposed), then computes step t's dz; one more launch after t = 0
// writes dh0. Every sum runs in a fixed order, no atomics: two runs give
// the same bits. Any N, H >= 1.

#include <cuda_runtime.h>

namespace {

constexpr int kUnits = 32;     // hidden units per block, one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;     // k (or j) per staged chunk

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One forward step t. G = 4 (LSTM) or 3 (GRU).
template <int G, int RPW, bool kSave>
__global__ void __launch_bounds__(kThreads)
step_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ r,
                const float* __restrict__ rb, const float* __restrict__ h0,
                const float* __restrict__ c0, float* __restrict__ hs,
                float* __restrict__ c_state, float* __restrict__ gates,
                float* __restrict__ cs, float* __restrict__ rzc_out,
                float* __restrict__ cand_out, int t, int N, int H) {
  constexpr int ROWS = kWarps * RPW;
  __shared__ float h_s[ROWS][kChunk];
  __shared__ float r_s[kChunk][G * kUnits];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kUnits;
  const int n0 = blockIdx.y * ROWS;
  const int j = j0 + lane;
  const int gh = G * H;
  const size_t nh = (size_t)N * H;
  const float* h_prev = t == 0 ? h0 : hs + (size_t)(t - 1) * nh;

  float acc[RPW][G];
#pragma unroll
  for (int q = 0; q < RPW; ++q)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[q][g] = 0.0f;

  for (int k0 = 0; k0 < H; k0 += kChunk) {
    __syncthreads();
    for (int e = threadIdx.x; e < ROWS * kChunk; e += kThreads) {
      const int row = e / kChunk, kk = e % kChunk;
      const int n = n0 + row, k = k0 + kk;
      h_s[row][kk] = n < N && k < H ? h_prev[(size_t)n * H + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < kChunk * G * kUnits; e += kThreads) {
      const int kk = e / (G * kUnits), col = e % (G * kUnits);
      const int g = col / kUnits, jj = j0 + col % kUnits, k = k0 + kk;
      r_s[kk][col] =
          k < H && jj < H ? r[(size_t)k * gh + (size_t)g * H + jj] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      float w[G];
#pragma unroll
      for (int g = 0; g < G; ++g) w[g] = r_s[kk][g * kUnits + lane];
#pragma unroll
      for (int q = 0; q < RPW; ++q) {
        const float hv = h_s[warp * RPW + q][kk];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[q][g] = fmaf(hv, w[g], acc[q][g]);
      }
    }
  }

  if (j >= H) return;
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int n = n0 + warp * RPW + q;
    if (n >= N) continue;
    const size_t cell = (size_t)n * H + j;
    const float* x = xw + (size_t)t * N * gh + (size_t)n * gh + j;
    float h;
    if constexpr (G == 4) {
      const float ig = sigmoid(x[0] + acc[q][0]);
      const float fg = sigmoid(x[H] + acc[q][1]);
      const float gg = tanhf(x[2 * H] + acc[q][2]);
      const float og = sigmoid(x[3 * H] + acc[q][3]);
      const float c_prev = kSave ? (t == 0 ? c0[cell]
                                           : cs[(size_t)(t - 1) * nh + cell])
                                 : c_state[cell];
      const float c = fg * c_prev + ig * gg;
      h = og * tanhf(c);
      if constexpr (kSave) {
        float* gt = gates + (size_t)t * N * gh + (size_t)n * gh + j;
        gt[0] = ig;
        gt[H] = fg;
        gt[2 * H] = gg;
        gt[3 * H] = og;
        cs[(size_t)t * nh + cell] = c;
      } else {
        c_state[cell] = c;
      }
    } else {
      const float rz_c = acc[q][2] + rb[2 * H + j];
      const float rg = sigmoid(x[0] + (acc[q][0] + rb[j]));
      const float ug = sigmoid(x[H] + (acc[q][1] + rb[H + j]));
      const float c = tanhf(x[2 * H] + rg * rz_c);
      h = ug * h_prev[cell] + (1.0f - ug) * c;
      if constexpr (kSave) {
        float* ru = gates + (size_t)t * N * 2 * H + (size_t)n * 2 * H + j;
        ru[0] = rg;
        ru[H] = ug;
        rzc_out[(size_t)t * nh + cell] = rz_c;
        cand_out[(size_t)t * nh + cell] = c;
      }
    }
    hs[(size_t)t * nh + cell] = h;
  }
}

// One backward launch. dz_next [N, G*H] is the recurrent-side dz of step
// t+1 (null at t = T-1, where the carry is dhT); t = -1 only writes
// dh0 = the carry. LSTM: carry = dz_next R^T; GRU: carry = dhu +
// dz_next R^T, dhu = dh_{t+1} u_{t+1} kept per cell.
template <int G, int RPW>
__global__ void __launch_bounds__(kThreads)
step_bwd_kernel(const float* __restrict__ dz_next,
                const float* __restrict__ r, const float* __restrict__ dhs,
                const float* __restrict__ dhT,
                const float* __restrict__ res0,   // LSTM gates / GRU ru
                const float* __restrict__ res1,   // LSTM cs / GRU rz_c
                const float* __restrict__ res2,   // GRU cand
                const float* __restrict__ hs, const float* __restrict__ h0,
                const float* __restrict__ c0, float* __restrict__ dxw,
                float* __restrict__ drz, float* __restrict__ carry_state,
                float* __restrict__ dh0, int t, int N, int H) {
  constexpr int ROWS = kWarps * RPW;
  __shared__ float dz_s[ROWS][kChunk];
  __shared__ float rt_s[kChunk][kUnits + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kUnits;
  const int n0 = blockIdx.y * ROWS;
  const int k = k0 + lane;
  const int gh = G * H;
  const size_t nh = (size_t)N * H;

  float acc[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) acc[q] = 0.0f;
  if (dz_next != nullptr) {
    for (int j0 = 0; j0 < gh; j0 += kChunk) {
      __syncthreads();
      for (int e = threadIdx.x; e < ROWS * kChunk; e += kThreads) {
        const int row = e / kChunk, jj = e % kChunk;
        const int n = n0 + row, jg = j0 + jj;
        dz_s[row][jj] =
            n < N && jg < gh ? dz_next[(size_t)n * gh + jg] : 0.0f;
      }
      for (int e = threadIdx.x; e < kUnits * kChunk; e += kThreads) {
        const int u = e / kChunk, jj = e % kChunk;
        const int kr = k0 + u, jg = j0 + jj;
        rt_s[jj][u] = kr < H && jg < gh ? r[(size_t)kr * gh + jg] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < kChunk; ++jj) {
        const float w = rt_s[jj][lane];
#pragma unroll
        for (int q = 0; q < RPW; ++q)
          acc[q] = fmaf(dz_s[warp * RPW + q][jj], w, acc[q]);
      }
    }
  }

  if (k >= H) return;
#pragma unroll
  for (int q = 0; q < RPW; ++q) {
    const int n = n0 + warp * RPW + q;
    if (n >= N) continue;
    const size_t cell = (size_t)n * H + k;
    float carry;
    if (dz_next == nullptr) {
      carry = dhT[cell];
    } else if constexpr (G == 4) {
      carry = acc[q];
    } else {
      carry = carry_state[cell] + acc[q];
    }
    if (t < 0) {
      dh0[cell] = carry;
      continue;
    }
    const float dh = dhs[(size_t)t * nh + cell] + carry;
    const size_t zrow = (size_t)t * N * gh + (size_t)n * gh + k;
    if constexpr (G == 4) {
      const float* gt = res0 + zrow;
      const float ig = gt[0], fg = gt[H], gg = gt[2 * H], og = gt[3 * H];
      const float c_prev = t == 0 ? c0[cell] : res1[(size_t)(t - 1) * nh + cell];
      const float tc = tanhf(res1[(size_t)t * nh + cell]);
      const float d_o = dh * tc;
      const float dc = carry_state[cell] + dh * og * (1.0f - tc * tc);
      float* dz = dxw + zrow;
      dz[0] = dc * gg * ig * (1.0f - ig);
      dz[H] = dc * c_prev * fg * (1.0f - fg);
      dz[2 * H] = dc * ig * (1.0f - gg * gg);
      dz[3 * H] = d_o * og * (1.0f - og);
      carry_state[cell] = dc * fg;
    } else {
      const float* ru = res0 + (size_t)t * N * 2 * H + (size_t)n * 2 * H + k;
      const float rg = ru[0], ug = ru[H];
      const float hp = t == 0 ? h0[cell] : hs[(size_t)(t - 1) * nh + cell];
      const float cd = res2[(size_t)t * nh + cell];
      const float dcand = dh * (1.0f - ug);
      const float du = dh * (hp - cd);
      const float dc_pre = dcand * (1.0f - cd * cd);
      const float dr = dc_pre * res1[(size_t)t * nh + cell] * rg * (1.0f - rg);
      const float d_u = du * ug * (1.0f - ug);
      dxw[zrow] = dr;
      dxw[zrow + H] = d_u;
      dxw[zrow + 2 * H] = dc_pre;
      drz[zrow] = dr;
      drz[zrow + H] = d_u;
      drz[zrow + 2 * H] = dc_pre * rg;
      carry_state[cell] = dh * ug;
    }
  }
}

template <int RPW>
dim3 grid_for(int N, int H) {
  return dim3((H + kUnits - 1) / kUnits, (N + kWarps * RPW - 1) / (kWarps * RPW));
}

template <int G, int RPW, bool kSave>
int fwd_steps(const float* xw, const float* r, const float* rb,
              const float* h0, const float* c0, float* hs, float* c_state,
              float* gates, float* cs, float* rzc, float* cand, int T, int N,
              int H, cudaStream_t st) {
  const dim3 grid = grid_for<RPW>(N, H);
  for (int t = 0; t < T; ++t) {
    step_fwd_kernel<G, RPW, kSave><<<grid, kThreads, 0, st>>>(
        xw, r, rb, h0, c0, hs, c_state, gates, cs, rzc, cand, t, N, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

template <int G, int RPW>
int bwd_steps(const float* r, const float* dhs, const float* dhT,
              const float* res0, const float* res1, const float* res2,
              const float* hs, const float* h0, const float* c0, float* dxw,
              float* drz, float* carry_state, float* dh0, int T, int N,
              int H, cudaStream_t st) {
  const dim3 grid = grid_for<RPW>(N, H);
  const size_t zstep = (size_t)N * G * H;
  // the recurrent-side dz: dxw itself for the LSTM, drz for the GRU
  const float* dz = G == 4 ? dxw : drz;
  for (int t = T - 1; t >= -1; --t) {
    const float* dz_next = t == T - 1 ? nullptr : dz + (size_t)(t + 1) * zstep;
    step_bwd_kernel<G, RPW><<<grid, kThreads, 0, st>>>(
        dz_next, r, dhs, dhT, res0, res1, res2, hs, h0, c0, dxw, drz,
        carry_state, dh0, t, N, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}

// RPW rows per warp (row tiles of 64, 32 or 8): the largest whose grid
// still gives every SM a block, so that small batches spread over the
// card instead of leaving most SMs idle.
int rows_per_warp(int N, int H) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long unit_tiles = (H + kUnits - 1) / kUnits;
  for (int rpw : {8, 4}) {
    const int rows = kWarps * rpw;
    if (unit_tiles * ((N + rows - 1) / rows) >= sms) return rpw;
  }
  return 1;
}

#define RNN_BY_ROWS(CALL)                  \
  switch (rows_per_warp(N, H)) {           \
    case 8: return CALL(8);                \
    case 4: return CALL(4);                \
    default: return CALL(1);               \
  }

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -3: an empty dimension.
// The LSTM forward: save = 0 writes hs and the c state (in place: the
// caller fills it with c0, it ends as cT); save = 1 writes hs, gates and
// cs.
extern "C" int rnn_step_fwd_lstm_f32(const float* xw, const float* r,
                                     const float* h0, const float* c0,
                                     float* hs, float* c_state, float* gates,
                                     float* cs, int save, int T, int N,
                                     int H, void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  cudaStream_t st = (cudaStream_t)stream;
#define LSTM_FWD(RPW_)                                                     \
  (save ? fwd_steps<4, RPW_, true>(xw, r, nullptr, h0, c0, hs, c_state,    \
                                   gates, cs, nullptr, nullptr, T, N, H, st) \
        : fwd_steps<4, RPW_, false>(xw, r, nullptr, h0, c0, hs, c_state,   \
                                    gates, cs, nullptr, nullptr, T, N, H, st))
  RNN_BY_ROWS(LSTM_FWD)
#undef LSTM_FWD
}

// The GRU forward: save = 0 writes hs; save = 1 also ru, rz_c and cand.
extern "C" int rnn_step_fwd_gru_f32(const float* xw, const float* r,
                                    const float* rb, const float* h0,
                                    float* hs, float* ru, float* rzc,
                                    float* cand, int save, int T, int N,
                                    int H, void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  cudaStream_t st = (cudaStream_t)stream;
#define GRU_FWD(RPW_)                                                       \
  (save ? fwd_steps<3, RPW_, true>(xw, r, rb, h0, nullptr, hs, nullptr, ru, \
                                   nullptr, rzc, cand, T, N, H, st)         \
        : fwd_steps<3, RPW_, false>(xw, r, rb, h0, nullptr, hs, nullptr,    \
                                    nullptr, nullptr, nullptr, nullptr, T,  \
                                    N, H, st))
  RNN_BY_ROWS(GRU_FWD)
#undef GRU_FWD
}

// The LSTM reverse sweep: dxw [T,N,4H] and dh0; dc_state is filled with
// dcT by the caller and ends as dc0.
extern "C" int rnn_step_bwd_lstm_f32(const float* dhs, const float* dhT,
                                     const float* gates, const float* cs,
                                     const float* r, const float* c0,
                                     float* dxw, float* dc_state,
                                     float* dh0, int T, int N, int H,
                                     void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  cudaStream_t st = (cudaStream_t)stream;
#define LSTM_BWD(RPW_)                                                      \
  bwd_steps<4, RPW_>(r, dhs, dhT, gates, cs, nullptr, nullptr, nullptr, c0, \
                     dxw, nullptr, dc_state, dh0, T, N, H, st)
  RNN_BY_ROWS(LSTM_BWD)
#undef LSTM_BWD
}

// The GRU reverse sweep: dxw and drz [T,N,3H] and dh0; dhu is a [N,H]
// scratch (the dh*u carry), no input needed.
extern "C" int rnn_step_bwd_gru_f32(const float* dhs, const float* dhT,
                                    const float* ru, const float* rzc,
                                    const float* cand, const float* hs,
                                    const float* r, const float* h0,
                                    float* dxw, float* drz, float* dhu,
                                    float* dh0, int T, int N, int H,
                                    void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  cudaStream_t st = (cudaStream_t)stream;
#define GRU_BWD(RPW_)                                                       \
  bwd_steps<3, RPW_>(r, dhs, dhT, ru, rzc, cand, hs, h0, nullptr, dxw, drz, \
                     dhu, dh0, T, N, H, st)
  RNN_BY_ROWS(GRU_BWD)
#undef GRU_BWD
}

extern "C" const char* rnn_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
