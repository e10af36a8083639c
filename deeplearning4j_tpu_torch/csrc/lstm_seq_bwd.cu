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
// 0.011 ms at 3.35 TB/s. At such batches the sweep's T serial steps bound
// it, each an exchange of dz between the blocks that hold R plus a short
// product; the dR pass is a plain product, bound by operations.
//
// Design (two kernels on one stream; launch plans make_plan<true>
// (csrc/lstm_cluster.cuh) and make_dr_plan, mirrored by kernels/lstm.py
// lstm_seq_bwd_plan and lstm_bwd_dr_plan):
//
// 1. The sweep, the forward's structure in reverse (csrc/lstm_seq_infer.cu):
//    each row group is one thread-block cluster of C blocks (8, else 16,
//    else fewer for narrow H) that holds R between them for the whole
//    sweep, rank q keeping R's rows of its U units over all 4H columns,
//    transposed ([4 KH][U], KH = C U >= H, zeros past H), in shared
//    memory. No grid barrier, no cooperative launch: clusters are
//    independent recurrences, and those past the card's capacity run in a
//    later wave. Each step a block sums dz_{t+1} R^T for its units and the
//    cluster's rows, split over the threads as TM rows x 4 units (float4
//    loads) x a range of j; the j-splits' partial sums are added in split
//    order through shared memory. One thread a cell (row, unit) forms the
//    cell's four dz columns: the dc carry stays in its registers, and
//    dhs_t, gates_t, c_t and c_{t-1} were loaded into registers before the
//    step's wait. The block's dz columns go to every block of the cluster
//    by st.async (16 bytes each) into a double-buffered array there, on an
//    mbarrier counting the bytes; the next step waits on it only. One more
//    phase after t = 0 writes dh0 = dz_0 R^T and dc0. Past H = 300 a
//    cluster holds only 2 to 4 rows, and the sweep takes only the batches
//    sweep_takes (csrc/lstm_cluster.cuh) allows: the step route is faster
//    at the others.
// 2. dR: the product hprev^T [H, M] x dxw [M, 4H], M = T*N (hprev is h0
//    for t = 0, hs[t-1] after), as csrc/gru_seq_bwd.cu's dR pass: a block
//    owns a 128 x 128 tile of dR, each of its 256 threads an 8 x 8
//    register tile, and sums its chunk of M in steps of 16 through a
//    six-stage cp.async ring (two blocks an SM, 128 registers). The plan
//    splits M into `splits` chunks (1 to 8) so that tiles x splits fill the
//    card's block slots (at H = 256, 16 tiles x 8); the blocks of one tile
//    form a cluster and each rank adds its rows' partials in rank order
//    through distributed shared memory.
//
// No atomics anywhere: every sum runs in a fixed order, so two runs give
// the same bits. Plain f32 FMA; tensor cores are left alone (f32 parity).
// The ragged edges in N, H and M are masked; no shape alignment is needed.

#include "lstm_cluster.cuh"

namespace {

constexpr int kMaxCells = max_cells(true);

struct Args {
  const float* dhs;
  const float* dhT;
  const float* dcT;
  const float* gates;
  const float* cs;
  const float* r;
  const float* c0;
  float* dxw;
  float* dh0;
  float* dc0;
  int T, N, H;
};

// What the kernel takes of the plan (TM is a template parameter).
struct Geo {
  int cluster, units, rows, rth, splits, kr;
};

// 16 bytes of another cluster rank's shared memory
__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// 16 bytes global -> shared through L2, zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// What the gates of cell (n, k) at step t read besides its sum: dhs_t,
// i, f, g, o of gates_t, c_t and c_{t-1}.
__device__ __forceinline__ void load_cell(const Args& a, int t, int n, int k,
                                          float (&in)[7]) {
  const int H = a.H;
  const size_t nh = (size_t)a.N * H, cell = (size_t)n * H + k;
  const float* g = a.gates + ((size_t)t * a.N + n) * 4 * H + k;
  in[0] = __ldg(a.dhs + (size_t)t * nh + cell);
  in[1] = __ldg(g);
  in[2] = __ldg(g + H);
  in[3] = __ldg(g + 2 * H);
  in[4] = __ldg(g + 3 * H);
  in[5] = __ldg(a.cs + (size_t)t * nh + cell);
  in[6] = t == 0 ? __ldg(a.c0 + cell)
                 : __ldg(a.cs + (size_t)(t - 1) * nh + cell);
}

// The whole reverse sweep of one cluster's rows; TM rows per thread.
// Step v = 0 .. T-1 is t = T-1-v; step T only sums dz_0 R^T into dh0.
template <int TM>
__global__ void __launch_bounds__(TM == 8 ? 256 : 512, 1)
lstm_bwd_sweep_kernel(Args a, Geo p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.cluster, U = p.units, KH = C * U, RTH = p.rth;
  const int KR = p.kr, KP = p.splits * KR, XP = KP + 4;
  const int RCP = RTH * TM, CQ = U / 4;
  const int H = a.H, N = a.N, T = a.T;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rank = cluster_rank();
  const int n0 = (blockIdx.x / C) * p.rows, nrows = min(p.rows, N - n0);
  const int k0 = rank * U;
  const size_t four_h = 4 * (size_t)H;
  // products: thread (unit quad ct, row slot rt, j-split ks)
  const int ct = tid % CQ, rt = (tid / CQ) % RTH, ks = tid / (CQ * RTH);
  float* const r_s = smem;                         // [KP][U]
  float* const xb = r_s + (size_t)KP * U;          // [2][RCP][XP]
  float* const part = xb + 2 * (size_t)RCP * XP;   // [KS][RCP][U]
  float* const stage = part + (size_t)p.splits * RCP * U;   // [RCP][4][U]
  unsigned long long* const bars =
      reinterpret_cast<unsigned long long*>(stage + (size_t)RCP * 4 * U);

  // r_s[g KH + k][u] = R[k0 + u, g H + k], zeros past H; kept for the
  // whole sweep. By cp.async (every thread's copies in flight at once); a
  // warp reads 8 consecutive k of 4 units (four 32-byte runs).
  for (int i = tid; i < KP * U; i += nthreads) {
    const int u = (i / (4 * KP)) * 4 + i % 4, jj = (i / 4) % KP,
              g = jj / KH, k = jj % KH;
    const bool ok = g < 4 && k < H && k0 + u < H;
    cp_async4(r_s + (size_t)jj * U + u,
              ok ? a.r + (size_t)(k0 + u) * four_h + (size_t)g * H + k : a.r,
              ok);
  }
  cp_async_commit();
  for (int i = tid; i < 2 * RCP * XP; i += nthreads) xb[i] = 0.0f;
  // dz_t of every rank arrives by st.async on bars[v & 1]: every rank
  // pushes its 4 x U columns (zeros past H) of every row
  const unsigned bytes = (unsigned)(nrows * 4 * KH * 4);
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bars[0], bytes);               // step 0's pushes
    if (T >= 2) mbar_expect(&bars[1], bytes);   // step 1's
  }
  // the cells this thread finalises: e = row * U + u, e = tid + i threads
  const int cells = nrows * U;
  float dc_reg[kMaxCells], in_reg[kMaxCells][7];
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i) {
    const int e = tid + i * nthreads, k = k0 + e % U;
    dc_reg[i] = 0.0f;
#pragma unroll
    for (int q = 0; q < 7; ++q) in_reg[i][q] = 0.0f;
    if (e < cells && k < H) {
      const int n = n0 + e / U;
      dc_reg[i] = __ldg(a.dcT + (size_t)n * H + k);
      load_cell(a, T - 1, n, k, in_reg[i]);
    }
  }
  cp_async_wait<0>();
  cluster_barrier();   // every block's buffers and mbarriers are ready

  for (int v = 0; v <= T; ++v) {
    const int t = T - 1 - v;
    const bool have_next = v > 0;   // dz_{t+1} exists
    if (have_next) {   // every rank's pushes of step v-1 arrived
      mbar_wait(&bars[(v - 1) & 1], ((v - 1) >> 1) & 1);
      if (tid == 0 && v + 1 <= T - 1) mbar_expect(&bars[(v - 1) & 1], bytes);
      const float* const db = xb + (size_t)((v - 1) & 1) * RCP * XP;
      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
      const float* dq = db + (size_t)rt * XP + ks * KR;
      const float* wq = r_s + (size_t)ks * KR * U + 4 * ct;
#pragma unroll 2
      for (int j = 0; j < KR; j += 4) {
        float4 dv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          dv[i] = *reinterpret_cast<const float4*>(dq + i * RTH * XP + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 w =
              *reinterpret_cast<const float4*>(wq + (size_t)(j + jj) * U);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float d = jj == 0   ? dv[i].x
                            : jj == 1 ? dv[i].y
                            : jj == 2 ? dv[i].z
                                      : dv[i].w;
            acc[i][0] = fmaf(d, w.x, acc[i][0]);
            acc[i][1] = fmaf(d, w.y, acc[i][1]);
            acc[i][2] = fmaf(d, w.z, acc[i][2]);
            acc[i][3] = fmaf(d, w.w, acc[i][3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(
            part + ((size_t)ks * RCP + rt + RTH * i) * U + 4 * ct) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      __syncthreads();
    }

    // the cells: the splits' sums in split order, then dz (at t = -1,
    // dh0 and dc0)
#pragma unroll
    for (int i = 0; i < kMaxCells; ++i) {
      const int e = tid + i * nthreads;
      if (e >= cells) break;
      const int row = e / U, u = e % U, k = k0 + u, n = n0 + row;
      float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (k < H) {
        float s = 0.0f;
        if (have_next)
#pragma unroll 8
          for (int q = 0; q < p.splits; ++q)
            s += part[((size_t)q * RCP + row) * U + u];
        const size_t cell = (size_t)n * H + k;
        if (t < 0) {
          a.dh0[cell] = s;
          a.dc0[cell] = dc_reg[i];
          continue;
        }
        const float* in = in_reg[i];
        const float dh = in[0] + (have_next ? s : __ldg(a.dhT + cell));
        const float i_g = in[1], f_g = in[2], g_g = in[3], o_g = in[4];
        const float tc = tanhf(in[5]);
        const float d_o = dh * tc;
        const float dc = dc_reg[i] + dh * o_g * (1.0f - tc * tc);
        dz[0] = dc * g_g * i_g * (1.0f - i_g);
        dz[1] = dc * in[6] * f_g * (1.0f - f_g);
        dz[2] = dc * i_g * (1.0f - g_g * g_g);
        dz[3] = d_o * o_g * (1.0f - o_g);
        float* out = a.dxw + ((size_t)t * N + n) * four_h + k;
#pragma unroll
        for (int g = 0; g < 4; ++g) out[(size_t)g * H] = dz[g];
        dc_reg[i] = dc * f_g;   // the carry; dc0 after t = 0
      }
      if (t >= 0) {
#pragma unroll
        for (int g = 0; g < 4; ++g) stage[(row * 4 + g) * U + u] = dz[g];
      }
    }
    if (t < 0) break;
    __syncthreads();   // the block's dz_t is staged
    // dz_t to every rank, 16 bytes a store, into buffer v & 1 there
    float* const dst = xb + (size_t)(v & 1) * RCP * XP;
    const int quads = U / 4;
    for (int it = tid; it < nrows * 4 * quads * C; it += nthreads) {
      const int peer = it % C, q = (it / C) % quads,
                g = (it / (C * quads)) % 4, row = it / (C * quads * 4);
      const float4 val =
          *reinterpret_cast<const float4*>(stage + (row * 4 + g) * U + 4 * q);
      st_async(cluster_addr(dst + (size_t)row * XP + g * KH + k0 + 4 * q,
                            peer),
               val, cluster_addr(&bars[v & 1], peer));
    }
    // step t-1's inputs of the cells, into registers while dz_t travels
    if (t >= 1) {
#pragma unroll
      for (int i = 0; i < kMaxCells; ++i) {
        const int e = tid + i * nthreads, k = k0 + e % U;
        if (e < cells && k < H) load_cell(a, t - 1, n0 + e / U, k, in_reg[i]);
      }
    }
  }
}

using SweepKernel = void (*)(Args, Geo);

SweepKernel kernel_of(int tm) {
  return tm == 8   ? lstm_bwd_sweep_kernel<8>
         : tm == 4 ? lstm_bwd_sweep_kernel<4>
         : tm == 2 ? lstm_bwd_sweep_kernel<2>
                   : lstm_bwd_sweep_kernel<1>;
}

// The reverse sweep, or with `dry` only its checks; codes as below.
int sweep(const Args& a, cudaStream_t st, bool dry) {
  if (a.T < 1 || a.N < 1 || a.H < 1) return -3;
  int caps[5];
  int rc = device_caps(lstm_bwd_sweep_kernel<1>, caps);
  if (rc != 0) return rc;
  Plan pl;
  rc = make_plan<true>(a.N, a.H, caps, &pl);
  if (rc != 0 || dry) return rc;
  const SweepKernel k = kernel_of(pl.tm);
  cudaError_t err = prepare(k, pl.smem, pl.cluster);
  if (err != cudaSuccess) return err;
  const Geo geo{pl.cluster, pl.units, pl.rows, pl.rth, pl.splits, pl.kr};
  Launch l(pl.blocks, pl.threads, pl.smem, pl.cluster, st);
  err = cudaLaunchKernelEx(&l.cfg, k, a, geo);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ---------------------------------------------------------------------------
// dR
// ---------------------------------------------------------------------------

constexpr int kDrBM = 128;   // rows of a dR tile (k)
constexpr int kDrBN = 128;   // columns (j)
constexpr int kDrBK = 16;    // m per step
constexpr int kDrThreads = 256;
constexpr int kDrStages = 6;
constexpr int kDrPerSm = 2;  // blocks an SM (the launch bounds)
constexpr int kDrMaxSplits = 8;
constexpr int kDrReduceSteps = 4;   // the cluster's sum, counted in steps
constexpr int kDrStageFloats = kDrBK * (kDrBM + kDrBN);
// a split's partial tile goes over the ring once the sums are done
static_assert(kDrStages * kDrStageFloats >= kDrBM * kDrBN, "ring");
static_assert(kDrBM % kDrMaxSplits == 0, "rows a rank adds");
constexpr int kDrPlanFields = 5;

// tiles: dR tiles; splits: chunks of M (the blocks of one tile, a
// cluster); chunk: m a split sums (a multiple of kDrBK); blocks: the
// grid; smem: dynamic shared memory bytes.
struct DrPlan {
  int tiles, splits, chunk, blocks, smem;
};

// The dR pass's plan for M = T * N rows on `sms` SMs: the splits of M
// (1, 2, 4 or 8) that give the least time counted as waves of kDrPerSm
// blocks an SM times the steps of 16 m a block sums (plus the cluster's
// sum), the fewer splits where two tie. 0, or -3 for an empty dimension.
int make_dr_plan(int T, int N, int H, int sms, DrPlan* p) {
  if (T < 1 || N < 1 || H < 1 || sms < 1) return -3;
  const long M = (long)T * N;
  const int tiles = cdiv(H, kDrBM) * cdiv(4 * H, kDrBN);
  const long steps = (M + kDrBK - 1) / kDrBK;
  const long slots = (long)sms * kDrPerSm;
  long best = -1;
  for (int s = 1; s <= kDrMaxSplits; s *= 2) {
    const long chunk_steps = (steps + s - 1) / s;
    if (s > 1 && (s - 1) * chunk_steps >= steps) continue;   // an idle split
    const long waves = ((long)tiles * s + slots - 1) / slots;
    const long cost = waves * chunk_steps + (s > 1 ? kDrReduceSteps : 0);
    if (best >= 0 && cost >= best) continue;
    best = cost;
    p->splits = s;
    p->chunk = (int)(chunk_steps * kDrBK);
  }
  p->tiles = tiles;
  p->blocks = tiles * p->splits;
  p->smem = kDrStages * kDrStageFloats * 4;
  return 0;
}

// dR[k, j] = sum over m = t*N + n of hprev[m, k] * dxw[m, j], where
// hprev[m] is h0[n] for t = 0 and hs[t-1][n] after. Block b is split
// b % splits (its cluster rank) of tile b / splits, and sums m in
// [split * chunk, (split + 1) * chunk). Thread (ty, tx) of 16 x 16 owns
// rows {4 ty + i, 64 + 4 ty + i} and columns {4 tx + i, 64 + 4 tx + i} of
// the tile. kVec: 16-byte copies (H % 4 == 0 and aligned pointers).
template <bool kVec>
__global__ void __launch_bounds__(kDrThreads, kDrPerSm)
lstm_bwd_dr_kernel(const float* __restrict__ hs,
                   const float* __restrict__ h0,
                   const float* __restrict__ dxw, float* __restrict__ dr,
                   int M, int N, int H, int splits, int chunk) {
  extern __shared__ __align__(16) float dsm[];
  const int four_h = 4 * H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int tiles_j = cdiv(four_h, kDrBN);
  const int k0 = (tile / tiles_j) * kDrBM, j0 = (tile % tiles_j) * kDrBN;
  const int m_begin = min(M, split * chunk), m_end = min(M, m_begin + chunk);
  const int steps = cdiv(m_end - m_begin, kDrBK);

  // step s's rows m of hprev (columns k0 ..) and dxw (columns j0 ..) into
  // stage st: a_s [kDrBK][kDrBM], then b_s [kDrBK][kDrBN]; zeros past
  // m_end, H and 4H
  auto load = [&](int s, int st) {
    float* a_s = dsm + st * kDrStageFloats;
    float* b_s = a_s + kDrBK * kDrBM;
    const int m0 = m_begin + s * kDrBK;
    if constexpr (kVec) {
#pragma unroll
      for (int l = 0; l < kDrBK * kDrBM / 4 / kDrThreads; ++l) {
        const int e = tid + kDrThreads * l;
        const int row = e / (kDrBM / 4), col = (e % (kDrBM / 4)) * 4;
        const int m = m0 + row, kg = k0 + col, j = j0 + col;
        const bool okm = m < m_end;
        const bool oka = okm && kg < H, okb = okm && j < four_h;
        const float* pa = m < N ? h0 + (size_t)m * H + kg
                                : hs + (size_t)(m - N) * H + kg;
        cp_async16(a_s + row * kDrBM + col, oka ? pa : h0, oka);
        cp_async16(b_s + row * kDrBN + col,
                   okb ? dxw + (size_t)m * four_h + j : dxw, okb);
      }
    } else {
#pragma unroll
      for (int l = 0; l < kDrBK * kDrBM / kDrThreads; ++l) {
        const int e = tid + kDrThreads * l;
        const int row = e / kDrBM, col = e % kDrBM;
        const int m = m0 + row, kg = k0 + col, j = j0 + col;
        const bool okm = m < m_end;
        const bool oka = okm && kg < H, okb = okm && j < four_h;
        const float* pa = m < N ? h0 + (size_t)m * H + kg
                                : hs + (size_t)(m - N) * H + kg;
        cp_async4(a_s + row * kDrBM + col, oka ? pa : h0, oka);
        cp_async4(b_s + row * kDrBN + col,
                  okb ? dxw + (size_t)m * four_h + j : dxw, okb);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  for (int s = 0; s < kDrStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kDrStages - 2>();
    __syncthreads();   // step s landed; every thread is past step s - 1
    const int next = s + kDrStages - 1;
    if (next < steps) load(next, next % kDrStages);
    cp_async_commit();
    const float* a_s = dsm + (s % kDrStages) * kDrStageFloats;
    const float* b_s = a_s + kDrBK * kDrBM;
#pragma unroll
    for (int mm = 0; mm < kDrBK; ++mm) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(a_s + mm * kDrBM + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a_s + mm * kDrBM + 64 + 4 * ty);
      const float4 b0 =
          *reinterpret_cast<const float4*>(b_s + mm * kDrBN + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b_s + mm * kDrBN + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }
  cp_async_wait<0>();

  auto row_of = [&](int i) { return i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4; };
  auto col_of = [&](int c) { return c < 4 ? 4 * tx + c : 64 + 4 * tx + c - 4; };
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kg = k0 + row_of(i);
      if (kg >= H) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + col_of(c);
        if (j < four_h) dr[(size_t)kg * four_h + j] = acc[i][c];
      }
    }
    return;
  }

  // the partial tile into this block's shared memory (over the ring, which
  // every thread has finished reading), then each rank adds the splits'
  // partials of its rows in split order, read through the cluster
  __syncthreads();
  float* const part = dsm;   // [kDrBM][kDrBN]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = part + row_of(i) * kDrBN;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cluster_barrier();
  const int rows = kDrBM / splits, r0 = split * rows;
  for (int idx = tid; idx < rows * (kDrBN / 4); idx += kDrThreads) {
    const int row = r0 + idx / (kDrBN / 4), col = (idx % (kDrBN / 4)) * 4;
    const float* src = part + row * kDrBN + col;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < splits; ++q) {
      const float4 w = ld_cluster4(cluster_addr(src, q));
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int kg = k0 + row;
    if (kg >= H) continue;
    float* out = dr + (size_t)kg * four_h + j0 + col;
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + col + c < four_h) out[c] = vals[c];
  }
  // no block leaves while another rank still reads its shared memory
  cluster_barrier();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

int device_sms(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return 0;
}

// The dR pass on stream st; 0 or a cudaError_t.
int launch_dr(const float* hs, const float* h0, const float* dxw, float* dr,
              int T, int N, int H, cudaStream_t st) {
  int sms = 0;
  int rc = device_sms(&sms);
  if (rc != 0) return rc;
  DrPlan pl;
  rc = make_dr_plan(T, N, H, sms, &pl);
  if (rc != 0) return rc;
  const bool vec = H % 4 == 0 && aligned16(hs) && aligned16(h0) &&
                   aligned16(dxw);
  auto kernel = vec ? lstm_bwd_dr_kernel<true> : lstm_bwd_dr_kernel<false>;
  cudaError_t err = prepare(kernel, pl.smem, pl.splits);
  if (err != cudaSuccess) return err;
  Launch l(pl.blocks, kDrThreads, pl.smem, pl.splits, st);
  err = cudaLaunchKernelEx(&l.cfg, kernel, hs, h0, dxw, dr, T * N, N, H,
                           pl.splits, pl.chunk);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for the R slices in shared memory on this device, or a
//     batch past those the sweep takes at this width (sweep_takes in
//     csrc/lstm_cluster.cuh: the step route is faster there);
// -2: the card holds no cluster of the size whose slices fit;
// -3: an empty dimension.
extern "C" int lstm_seq_bwd_f32(const float* dhs, const float* dhT,
                                const float* dcT, const float* gates,
                                const float* cs, const float* hs,
                                const float* r, const float* h0,
                                const float* c0, float* dxw, float* dr,
                                float* dh0, float* dc0, int T, int N, int H,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Args a{dhs, dhT, dcT, gates, cs, r, c0, dxw, dh0, dc0, T, N, H};
  const int rc = sweep(a, st, false);
  if (rc != 0) return rc;
  return launch_dr(hs, h0, dxw, dr, T, N, H, st);
}

// Whether lstm_seq_bwd_f32 would launch at batch N and width H on the
// current device: the sweep's checks, and nothing launched. 0 if it
// would, else the code it would return. The wrappers choose the route
// with it, before any launch.
extern "C" int lstm_seq_bwd_fits(int N, int H) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, 1, N, H};
  return sweep(a, nullptr, true);
}

// The dR pass alone, from a dxw that a reverse sweep wrote (the step
// route's, csrc/rnn_step.cu, for the widths this sweep does not take; it
// also lets a measurement time the two passes apart). Same codes.
extern "C" int lstm_seq_bwd_dr_f32(const float* hs, const float* h0,
                                   const float* dxw, float* dr, int T, int N,
                                   int H, void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  return launch_dr(hs, h0, dxw, dr, T, N, H, (cudaStream_t)stream);
}

// The clusters of 1, 2, 4, 8 and 16 sweep blocks this device holds at
// once at one block an SM, into out[5]. 0 or a cudaError_t.
extern "C" int lstm_seq_bwd_clusters(int* out) {
  return device_caps(lstm_bwd_sweep_kernel<1>, out);
}

// The sweep's launch plan at batch N and width H, nothing launched, for a
// card holding caps[i] clusters of 2^i blocks (kernels/lstm.py
// lstm_seq_bwd_plan mirrors it); caps = NULL: this device. out[13] as
// lstm_seq_plan's. 0, or the codes above.
extern "C" int lstm_seq_bwd_plan(int N, int H, const int* caps, int* out) {
  int dev_caps[5];
  if (caps == nullptr) {
    const int rc = device_caps(lstm_bwd_sweep_kernel<1>, dev_caps);
    if (rc != 0) return rc;
    caps = dev_caps;
  }
  Plan p;
  const int rc = make_plan<true>(N, H, caps, &p);
  if (rc == 0) plan_out(p, out);
  return rc;
}

// The dR pass's plan for T steps at batch N and width H on a card of
// `sms` SMs (sms <= 0: the current device's), nothing launched
// (kernels/lstm.py lstm_bwd_dr_plan mirrors it). out[5]: tiles, splits,
// chunk, blocks, smem_bytes. 0, -3, or a cudaError_t.
extern "C" int lstm_seq_bwd_dr_plan(int T, int N, int H, int sms, int* out) {
  if (sms <= 0) {
    const int rc = device_sms(&sms);
    if (rc != 0) return rc;
  }
  DrPlan p;
  const int rc = make_dr_plan(T, N, H, sms, &p);
  if (rc != 0) return rc;
  const int v[kDrPlanFields] = {p.tiles, p.splits, p.chunk, p.blocks, p.smem};
  for (int i = 0; i < kDrPlanFields; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* lstm_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
