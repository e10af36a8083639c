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
// What bounds it on this card. Each step is an [N,H]x[H,4H] product plus
// gates, and step t needs h_{t-1}. At N=1024, H=256, T=100 the products
// are 54 GFLOP of f32 FMA, 0.8 ms on the non-tensor f32 pipe (67 TFLOP/s),
// against 0.16 ms for the 0.5 GB of xw and hs: operations bound it. At
// serving batches (N <= 32) neither does: the T serial steps do, each one
// an exchange of h between the blocks that hold R plus a short product.
//
// Design (one launch per sequence, as on the TPU, where R stays in VMEM;
// make_plan<false> in csrc/lstm_cluster.cuh, mirrored by kernels/lstm.py
// lstm_seq_plan):
// - Batch rows are independent recurrences: step t of row n needs only
//   h_{t-1} of row n. So each row group (`rows` rows) is one thread-block
//   cluster of C blocks, one block an SM, that holds all of R between them
//   for the whole sequence: rank q keeps the [H, 4U] column slice of its U
//   hidden units (all four gates, interleaved per unit) in shared memory.
//   C = 8 (the portable maximum) where the slice fits, else C = 16 (the
//   non-portable size), else smaller clusters for narrow H; U is a
//   multiple of 4 and the cluster covers KH = C U >= H units, those past H
//   held as zeros. The clusters never wait on each other: no grid barrier,
//   no cooperative launch, and clusters past the card's capacity run in a
//   later wave. The plan spreads N over the clusters the card holds at
//   once (cudaOccupancyMaxActiveClusters), as few rows each as that gives,
//   in as few waves as shared memory allows while a block keeps 128
//   threads (more rows leave less room for the k-splits: at H = 300, 5
//   rows would leave 80 threads and take longer than more waves).
// - Each block keeps h_{t-1} of its cluster's rows, all KH units, in a
//   double-buffered shared array. Each step it sums its 4U gate columns
//   for those rows, split over the threads as TM rows x one unit's 4 gates
//   (float4 loads of R and of h) x a range of k; the k-splits' partial
//   sums are added in split order through shared memory. One thread a
//   cell (row, unit) then runs the gates: c stays in its registers for the
//   whole sequence, xw_t was loaded into registers before the step's
//   wait, and hs (gates, cs) are stored to global memory off the chain.
// - h_t goes to every block of the cluster, itself included, by st.async
//   (16 bytes each) into the other buffer, on an mbarrier there that
//   counts the bytes; the next step waits on that mbarrier only. Two
//   buffers suffice: no block can push h_{t+1} before it has every
//   block's h_t, which each pushes only after its reads of h_{t-1}. (Bulk
//   copies, cp.async.bulk of U floats a row and peer, took longer to
//   issue and land: scripts/lstm_seq_ab.py, PERF.md.)
// - Every value has one writer and every sum a fixed order (no atomics),
//   so two runs give the same bits. Plain f32 FMA; no TF32.
// The ragged edges in N and H are masked; no shape alignment is needed.

#include "lstm_cluster.cuh"

namespace {

constexpr int kMaxCells = max_cells(false);

struct Args {
  const float* xw;
  const float* r;
  const float* h0;
  const float* c0;
  float* hs;
  float* hT;
  float* cT;
  float* gates;
  float* cs;
  int T, N, H;
};

// What the kernel takes of the plan (TM is a template parameter).
struct Geo {
  int cluster, units, rows, rth, splits, kr;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The whole recurrence of one cluster's rows. TM rows per thread; kSave:
// write gates and cs for the backward instead of hT, cT.
template <int TM, bool kSave>
__global__ void __launch_bounds__(TM == 8 ? 256 : 512, 1)
lstm_seq_kernel(Args a, Geo p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.cluster, U = p.units, KH = C * U, RTH = p.rth;
  const int KR = p.kr, KP = p.splits * KR, XP = KP + 4, NC = 4 * U;
  const int RCP = RTH * TM;
  const int H = a.H, N = a.N, T = a.T;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rank = cluster_rank();
  const int n0 = (blockIdx.x / C) * p.rows, nrows = min(p.rows, N - n0);
  const int j0 = rank * U;
  const size_t four_h = 4 * (size_t)H, nh = (size_t)N * H;
  // products: thread (unit ct, row slot rt, k-split ks); rows rt + RTH i
  const int ct = tid % U, rt = (tid / U) % RTH, ks = tid / (U * RTH);
  float* const r_s = smem;                         // [KP][4U]
  float* const xb = r_s + (size_t)KP * NC;         // [2][RCP][XP]
  float* const part = xb + 2 * (size_t)RCP * XP;   // [KS][RCP][4U]
  float* const stage = part + (size_t)p.splits * RCP * NC;   // [RCP][U]
  unsigned long long* const bars =
      reinterpret_cast<unsigned long long*>(stage + (size_t)RCP * U);

  // R[k, g H + j0 + u] -> r_s[k][4u + g], zeros past H; kept for the
  // whole sequence. By cp.async: every thread's copies in flight at once
  for (int i = tid; i < KP * NC; i += nthreads) {
    const int k = i / NC, g = (i % NC) / U, u = i % U, j = j0 + u;
    const bool ok = k < H && j < H;
    cp_async4(r_s + k * NC + 4 * u + g,
              ok ? a.r + (size_t)k * four_h + (size_t)g * H + j : a.r, ok);
  }
  cp_async_commit();
  // h_{-1} = h0 in buffer 1, zeros elsewhere (the pads stay zero)
  for (int i = tid; i < 2 * RCP * XP; i += nthreads) {
    const int b = i / (RCP * XP), row = (i / XP) % RCP, k = i % XP;
    xb[i] = b == 1 && row < nrows && k < H
                ? __ldg(a.h0 + (size_t)(n0 + row) * H + k)
                : 0.0f;
  }
  // h_t of every rank arrives by st.async on bars[t & 1], one arrival a
  // phase (this block's expectation of the bytes): every rank pushes all
  // its units (zeros past H) of every row
  const unsigned bytes = (unsigned)(nrows * KH * 4);
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T >= 2) mbar_expect(&bars[0], bytes);   // step 0's pushes
    if (T >= 3) mbar_expect(&bars[1], bytes);   // step 1's
  }
  // the cells this thread finalises: e = row * U + u, e = tid + i threads
  const int cells = nrows * U;
  float c_reg[kMaxCells], x_reg[kMaxCells][4];
#pragma unroll
  for (int i = 0; i < kMaxCells; ++i) {
    const int e = tid + i * nthreads, j = j0 + e % U;
    c_reg[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) x_reg[i][g] = 0.0f;
    if (e < cells && j < H) {
      const int n = n0 + e / U;
      c_reg[i] = __ldg(a.c0 + (size_t)n * H + j);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        x_reg[i][g] = __ldg(a.xw + (size_t)n * four_h + (size_t)g * H + j);
    }
  }
  cp_async_wait<0>();
  cluster_barrier();   // every block's buffers and mbarriers are ready

  for (int t = 0; t < T; ++t) {
    if (t > 0) {   // h_{t-1}: every rank's pushes of step t-1 arrived
      mbar_wait(&bars[(t - 1) & 1], ((t - 1) >> 1) & 1);
      if (tid == 0 && t + 1 <= T - 2) mbar_expect(&bars[(t - 1) & 1], bytes);
    }
    const float* const hb = xb + (size_t)((t + 1) & 1) * RCP * XP;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.0f;
    {
      const float* hq = hb + (size_t)rt * XP + ks * KR;
      const float* wq = r_s + (size_t)ks * KR * NC + 4 * ct;
#pragma unroll 2
      for (int k = 0; k < KR; k += 4) {
        float4 hv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          hv[i] = *reinterpret_cast<const float4*>(hq + i * RTH * XP + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w =
              *reinterpret_cast<const float4*>(wq + (size_t)(k + kk) * NC);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float hk = kk == 0   ? hv[i].x
                             : kk == 1 ? hv[i].y
                             : kk == 2 ? hv[i].z
                                       : hv[i].w;
            acc[i][0] = fmaf(hk, w.x, acc[i][0]);
            acc[i][1] = fmaf(hk, w.y, acc[i][1]);
            acc[i][2] = fmaf(hk, w.z, acc[i][2]);
            acc[i][3] = fmaf(hk, w.w, acc[i][3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
      *reinterpret_cast<float4*>(
          part + ((size_t)ks * RCP + rt + RTH * i) * NC + 4 * ct) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();

    // the cells: the splits' sums in split order, then the gates
#pragma unroll
    for (int i = 0; i < kMaxCells; ++i) {
      const int e = tid + i * nthreads;
      if (e >= cells) break;
      const int row = e / U, u = e % U, j = j0 + u;
      float h = 0.0f;
      if (j < H) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        const float* ps = part + (size_t)row * NC + 4 * u;
#pragma unroll 8
        for (int q = 0; q < p.splits; ++q) {
          const float4 v =
              *reinterpret_cast<const float4*>(ps + (size_t)q * RCP * NC);
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
        const float i_g = sigmoid(x_reg[i][0] + s.x);
        const float f_g = sigmoid(x_reg[i][1] + s.y);
        const float g_g = tanhf(x_reg[i][2] + s.z);
        const float o_g = sigmoid(x_reg[i][3] + s.w);
        const float c = f_g * c_reg[i] + i_g * g_g;
        h = o_g * tanhf(c);
        c_reg[i] = c;
        const int n = n0 + row;
        const size_t cell = (size_t)n * H + j;
        if constexpr (kSave) {
          float* g_out = a.gates + ((size_t)t * N + n) * four_h + j;
          g_out[0] = i_g;
          g_out[H] = f_g;
          g_out[2 * H] = g_g;
          g_out[3 * H] = o_g;
          a.cs[(size_t)t * nh + cell] = c;
        } else if (t == T - 1) {
          a.hT[cell] = h;
          a.cT[cell] = c;
        }
        a.hs[(size_t)t * nh + cell] = h;
      }
      stage[row * U + u] = h;
    }
    if (t + 1 < T) {
      __syncthreads();   // the block's h_t is staged
      // h_t to every rank, 16 bytes a store, into buffer t & 1 there
      float* const dst = xb + (size_t)(t & 1) * RCP * XP;
      const int quads = U / 4;
      for (int it = tid; it < nrows * quads * C; it += nthreads) {
        const int peer = it % C, q = (it / C) % quads, row = it / (C * quads);
        const float4 v =
            *reinterpret_cast<const float4*>(stage + row * U + 4 * q);
        st_async(cluster_addr(dst + (size_t)row * XP + j0 + 4 * q, peer), v,
                 cluster_addr(&bars[t & 1], peer));
      }
      // xw_{t+1} of the cells, into registers while h_t travels
#pragma unroll
      for (int i = 0; i < kMaxCells; ++i) {
        const int e = tid + i * nthreads, j = j0 + e % U;
        if (e < cells && j < H) {
          const float* x =
              a.xw + ((size_t)(t + 1) * N + n0 + e / U) * four_h + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) x_reg[i][g] = __ldg(x + (size_t)g * H);
        }
      }
    }
  }
}

using Kernel = void (*)(Args, Geo);

template <bool kSave>
Kernel kernel_of(int tm) {
  return tm == 8   ? lstm_seq_kernel<8, kSave>
         : tm == 4 ? lstm_seq_kernel<4, kSave>
         : tm == 2 ? lstm_seq_kernel<2, kSave>
                   : lstm_seq_kernel<1, kSave>;
}

// With `dry`, only the checks: 0 where the launch would go ahead.
template <bool kSave>
int run(const Args& a, cudaStream_t st, bool dry) {
  if (a.T < 1 || a.N < 1 || a.H < 1) return -3;
  int caps[5];
  int rc = device_caps(lstm_seq_kernel<1, false>, caps);
  if (rc != 0) return rc;
  Plan pl;
  rc = make_plan<false>(a.N, a.H, caps, &pl);
  if (rc != 0 || dry) return rc;
  const Kernel k = kernel_of<kSave>(pl.tm);
  cudaError_t err = prepare(k, pl.smem, pl.cluster);
  if (err != cudaSuccess) return err;
  const Geo geo{pl.cluster, pl.units, pl.rows, pl.rth, pl.splits, pl.kr};
  Launch l(pl.blocks, pl.threads, pl.smem, pl.cluster, st);
  err = cudaLaunchKernelEx(&l.cfg, k, a, geo);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for R's slices in shared memory on this device;
// -2: the card holds no cluster of the size whose slices fit;
// -3: an empty dimension.
extern "C" int lstm_seq_infer_f32(const float* xw, const float* r,
                                  const float* h0, const float* c0,
                                  float* hs, float* hT, float* cT,
                                  int T, int N, int H, void* stream) {
  const Args a{xw, r, h0, c0, hs, hT, cT, nullptr, nullptr, T, N, H};
  return run<false>(a, (cudaStream_t)stream, false);
}

// The training forward: hs, gates [T,N,4H] and cs [T,N,H]; same codes.
extern "C" int lstm_seq_fwd_f32(const float* xw, const float* r,
                                const float* h0, const float* c0,
                                float* hs, float* gates, float* cs,
                                int T, int N, int H, void* stream) {
  const Args a{xw, r, h0, c0, hs, nullptr, nullptr, gates, cs, T, N, H};
  return run<true>(a, (cudaStream_t)stream, false);
}

// Whether lstm_seq_infer_f32 (save = 0) or lstm_seq_fwd_f32 (save = 1)
// would launch at batch N and width H on the current device: the same
// checks, and nothing launched. 0 if it would, else the code it would
// return. The wrappers choose the route with it, before any launch.
extern "C" int lstm_seq_fits(int N, int H, int save) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, 1, N, H};
  return save ? run<true>(a, nullptr, true) : run<false>(a, nullptr, true);
}

// The clusters of 1, 2, 4, 8 and 16 blocks this device holds at once at
// one block an SM, into out[5]. 0 or a cudaError_t.
extern "C" int lstm_seq_clusters(int* out) {
  return device_caps(lstm_seq_kernel<1, false>, out);
}

// The launch plan at batch N and width H (the same for save = 0 and 1),
// nothing launched, for a card holding caps[i] clusters of 2^i blocks
// (kernels/lstm.py lstm_seq_plan mirrors it); caps = NULL: this device.
// out[13]: cluster, units, k_pad, rows, tiles, rows_per_thread,
// row_threads, splits, k_per_split, threads, smem_bytes, blocks, resident.
// 0, or the codes above.
extern "C" int lstm_seq_plan(int N, int H, int save, const int* caps,
                             int* out) {
  (void)save;
  int dev_caps[5];
  if (caps == nullptr) {
    const int rc = device_caps(lstm_seq_kernel<1, false>, dev_caps);
    if (rc != 0) return rc;
    caps = dev_caps;
  }
  Plan p;
  const int rc = make_plan<false>(N, H, caps, &p);
  if (rc == 0) plan_out(p, out);
  return rc;
}

extern "C" const char* lstm_seq_infer_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
