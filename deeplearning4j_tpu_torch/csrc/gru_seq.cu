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
// serving batches the T serial steps do: each is a grid-wide barrier, a
// copy of h_{t-1} from L2 and a short chain of sums.
//
// Design (one cooperative launch per sequence, as on the TPU, where R
// stays in VMEM; make_plan, mirrored by kernels/gru.py gru_seq_plan; each
// choice measured on an H100 by scripts/gru_seq_ab.py, PERF.md §6):
// - No SM can hold R (12 MiB at H=1024), so it stays in shared memory for
//   the whole sequence, split over a grid of at most one block an SM. A
//   block owns U = 8, 16 or 32 hidden units (their 3U gate columns; U is a
//   template parameter) and a thread-block cluster of CL = 1 or 2 blocks
//   shares the unit slice and splits the reduction over k: rank q keeps
//   R's rows [q KR, (q+1) KR) of the slice ([KR][3U], 96 KiB at H=1024),
//   and stages only its k-range of h_{t-1}, for all the rows of a row tile
//   (at most 64; N <= 64 is one tile). The plan takes the most blocks not
//   above the SM count whose R slice, ring and sums fit in 227 KiB, then
//   the larger cluster: at H=1024, 128 blocks of 16 units in clusters of
//   2. Clusters of 4 would halve the h each block reads, but an H100 holds
//   only 30 of them at one block an SM (120 blocks); where the card cannot
//   hold the plan's clusters at once the launch takes the next smaller
//   cluster. Blocks left over take row tiles of their own (row groups).
// - h_{t-1} reaches shared memory in chunks of 64 k by cp.async (16-byte
//   copies through L2 where H % 4 == 0; otherwise __ldcg). Where a stage
//   for every chunk fits (N <= 48 at H=1024), all chunks are issued in
//   one loop over every thread (a thread issuing many copies serialises
//   them), one commit group, one wait, and the sums run over the whole
//   k-range without a barrier; else (N = 64) a ring of up to 9 stages,
//   one commit group a chunk, refilled as the sums advance.
// - Each thread keeps a register micro-tile of TM rows x 4 columns (TM =
//   8, 4 or 1 by the tile's rows) and `splits` thread groups share the k
//   (as many as 384 threads allow). A stage holds a thread's TM rows in a
//   slot of its own (rows 64 floats apart, slots 4 floats off a bank
//   multiple), so that per 4 k a thread reads TM + 4 float4 at
//   compile-time offsets from two addresses for 16 TM FMAs, and the
//   threads of a warp that share a row read one address: each load is one
//   wavefront and the loop is 86% FMAs. 8 columns a thread measured
//   slower (twice the splits to add, spills).
// - The splits' sums go through shared memory (added in split order),
//   then by st.async to the rank that finalises each cell, whose mbarrier
//   counts their bytes; it waits for them, adds the CL sums in rank order
//   and runs the gates. (The cluster barrier this replaced fences all of
//   global memory, MEMBAR.GPU, for its release.) No atomics: two runs
//   give the same bits. The cells' xw_t, h_{t-1} and rb go into registers
//   before the sums.
// - Steps are separated by the cooperative grid barrier. The launch
//   carries both the cooperative and the cluster attributes, sized with
//   cudaOccupancyMaxActiveClusters; where the grid cannot be co-resident
//   gru_seq_fits says -2 and kernels/rnn_step.py takes the step route.
// What still holds it (block 0's clock stamps, PERF.md): at N=64 the sums
// run at ~50% of the FMA rate and the h copy is L2-bound; at N=1 the grid
// barrier is a third of a step.
// The ragged edges in N, H and k are masked; no shape alignment is needed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;          // k per staged chunk of h
constexpr int kMaxThreads = 384;    // one block an SM
constexpr int kMaxRows = 64;        // rows per row tile
constexpr int kMaxStages = 9;
constexpr int kMaxCluster = 2;
constexpr int kSmemOptin = 232448;  // bytes a block may opt into (H100)
constexpr int kCells = 2;           // cells a thread preloads per tile
constexpr int kPlanFields = 15;

// The launch plan. units: hidden units per block; cluster: blocks sharing
// a unit slice (the k split); rows: rows per row tile (the last may hold
// fewer); tiles: row tiles; tm: rows per thread; rth, cth: row and column
// threads (4 columns each); splits: thread groups splitting each chunk's
// k; stages: the h ring's; smem: dynamic shared memory bytes; blocks: the
// grid; kr: k per cluster rank (a multiple of 4); groups: blocks with the
// same units and rank that split the row tiles; share: cells a rank
// finalises (a multiple of 4).
struct Plan {
  int units, cluster, rows, tiles, tm, rth, cth, splits, threads, stages,
      smem, blocks, kr, groups, share;
};

__host__ __device__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ int round4(int a) { return (a + 3) & ~3; }

// Floats of a ring stage: rth row slots of tm rows at stride kChunk, slots
// at stride tm * kChunk + 4, so that the rows a warp reads at once (one a
// slot) fall in distinct banks.
__host__ __device__ int stage_floats(int rth, int tm) {
  return rth * (tm * kChunk + 4);
}

// bytes: R's slice [kr][C], then the ring [stages][stage_floats] (the
// splits' sums [splits][rth * tm][C] go over it), then the ranks' sums
// [cl][3][share] and the mbarrier that counts their arrival (16 bytes)
long smem_of(int kr, int c, int stages, int rth, int tm, int splits, int cl,
             int share) {
  const long ring = (long)stages * stage_floats(rth, tm);
  const long part = (long)splits * rth * tm * c;
  return 4 * ((long)kr * c + (ring > part ? ring : part) +
              (long)cl * 3 * share) + 16;
}

// The plan at batch N, width H, on `sms` SMs, with clusters of at most
// max_cluster blocks. 0; -1 where no R slice fits in shared memory; -2
// where one fits but needs more blocks than SMs; -3 for an empty dimension.
int make_plan(int N, int H, int sms, int max_cluster, Plan* p) {
  if (N < 1 || H < 1 || sms < 1) return -3;
  const int tiles = cdiv(N, kMaxRows);
  const int rows = cdiv(N, tiles);
  const int tm = rows >= 32 ? 8 : rows >= 4 ? 4 : 1;
  const int rth = cdiv(rows, tm);
  static const int kUnitChoices[] = {8, 16, 32};
  int rc = -1;
  for (int a = 0; a < 3; ++a)
    for (int cl = 1; cl <= max_cluster; cl *= 2) {
      const int u = kUnitChoices[a], c = 3 * u, cth = c / 4;
      const long blocks = (long)cdiv(H, u) * cl;
      const int kr = round4(cdiv(H, cl));
      if (cl > 1 && (long)(cl - 1) * kr >= H) continue;   // an idle rank
      int splits = kMaxThreads / (rth * cth);
      if (splits > kChunk / 4) splits = kChunk / 4;
      const int share = round4(cdiv(rows * u, cl));
      if (smem_of(kr, c, 2, rth, tm, splits, cl, share) > kSmemOptin)
        continue;
      if (blocks > sms) {
        if (rc == -1) rc = -2;
        continue;
      }
      // the most blocks, then the largest cluster (the least of h staged)
      if (rc == 0 && (blocks < p->blocks ||
                      (blocks == p->blocks && cl <= p->cluster)))
        continue;
      rc = 0;
      p->units = u;
      p->cluster = cl;
      p->rows = rows;
      p->tiles = tiles;
      p->tm = tm;
      p->rth = rth;
      p->cth = cth;
      p->splits = splits;
      p->threads = rth * cth * splits;
      p->blocks = (int)blocks;
      p->kr = kr;
      p->share = share;
    }
  if (rc != 0) return rc;
  int groups = sms / p->blocks;
  if (groups > tiles) groups = tiles;
  p->groups = groups;
  p->blocks *= groups;
  // a stage for each chunk and one more where they fit (every chunk in
  // flight at once), else a ring of at most kMaxStages
  const int chunks = cdiv(p->kr, kChunk);
  auto smem = [&](int stages) {
    return smem_of(p->kr, 3 * p->units, stages, rth, tm, p->splits,
                   p->cluster, p->share);
  };
  int stages = chunks + 1;
  if (smem(stages) > kSmemOptin) {
    stages = chunks > kMaxStages ? kMaxStages : chunks;
    while (stages > 2 && smem(stages) > kSmemOptin) --stages;
  }
  p->stages = stages;
  p->smem = (int)smem(stages);
  return 0;
}

struct Args {
  const float* xw;
  const float* r;
  const float* rb;
  const float* h0;
  float* hs;
  float* hT;
  float* ru;
  float* rzc;
  float* cand;
  int T, N, H;
};

// What the kernel takes of the plan (units and column threads are
// template parameters).
struct Geo {
  int cluster, rows, tiles, rth, splits, stages, kr, groups, share, vec;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared through L2 (never a stale L1 line: other
// blocks write h during this launch), zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zeros where !ok (read-only inputs only)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The shared::cluster address of p (in this block's shared memory) in the
// shared memory of cluster rank `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory; their arrival completes
// 16 bytes of the transaction count of the mbarrier at `bar` there
__device__ __forceinline__ void st_async(unsigned addr, const float4& v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// this thread's arrival, expecting `bytes` more of transactions
__device__ __forceinline__ void mbar_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the phase of parity `parity` to complete; a wait that does not
// end within ~2^24 tries traps (a launch error, not a hung card)
__device__ __forceinline__ void mbar_wait(void* bar, unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0 .. kMaxStages - 2) commit groups are pending
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// What the gates of cell (n, j) read besides its sums: xw_t's three
// values, h_{t-1} and rb's three values.
__device__ __forceinline__ void load_cell(const Args& a, const float* xw_t,
                                          const float* h_prev, int n, int j,
                                          float (&in)[7]) {
  const int H = a.H;
  const float* x = xw_t + (size_t)n * 3 * H + j;
  in[0] = __ldg(x);
  in[1] = __ldg(x + H);
  in[2] = __ldg(x + 2 * H);
  in[3] = __ldcg(h_prev + (size_t)n * H + j);
  in[4] = __ldg(a.rb + j);
  in[5] = __ldg(a.rb + H + j);
  in[6] = __ldg(a.rb + 2 * H + j);
}

// The gates of cell (n, j) from its three sums s and load_cell's values,
// as the reference computes them; writes h (and, with kSave, the
// residuals; else hT at the last step).
template <bool kSave>
__device__ __forceinline__ void finish_cell(const Args& a, int t, int n,
                                            int j, const float (&s)[3],
                                            const float (&in)[7]) {
  const int H = a.H;
  const size_t nh = (size_t)a.N * H;
  const size_t cell = (size_t)n * H + j;
  const float rz_c = s[2] + in[6];
  const float rg = sigmoid(in[0] + (s[0] + in[4]));
  const float ug = sigmoid(in[1] + (s[1] + in[5]));
  const float c = tanhf(in[2] + rg * rz_c);
  const float h = ug * in[3] + (1.0f - ug) * c;
  if constexpr (kSave) {
    float* ru_t = a.ru + (size_t)t * a.N * 2 * H + (size_t)n * 2 * H + j;
    ru_t[0] = rg;
    ru_t[H] = ug;
    a.rzc[(size_t)t * nh + cell] = rz_c;
    a.cand[(size_t)t * nh + cell] = c;
  } else {
    if (t == a.T - 1) a.hT[cell] = h;
  }
  a.hs[(size_t)t * nh + cell] = h;
}

// The whole recurrence. TM rows per thread, U units a block; kSave: write
// ru, rz_c and cand for the backward instead of hT.
template <int TM, int U, bool kSave>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_seq_kernel(Args a, Geo p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = 3 * U, CTH = C / 4;   // columns, column threads
  // a stage's row slot: the TM rows rt, rt + rth, ... of one thread
  constexpr int RSTR = TM * kChunk + 4;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // rows fastest: a warp spans 8 (or 4, or 1) rows x 4 (or 8, or 32)
  // column groups, so its h loads are broadcasts within a row
  const int rt = tid % p.rth, ct = (tid / p.rth) % CTH,
            ks = tid / (CTH * p.rth);
  const int CL = p.cluster;
  const int H = a.H, N = a.N;
  const int rank = (int)cluster.block_rank();
  const int slices = (H + U - 1) / U;
  const int cl_id = blockIdx.x / CL;
  const int j0 = (cl_id % slices) * U, group = cl_id / slices;
  const size_t three_h = 3 * (size_t)H, nh = (size_t)N * H;
  const int KR = p.kr, kb = rank * KR, ke = min(H, kb + KR);
  const int chunks = (KR + kChunk - 1) / kChunk;
  const int RTP = p.rth * TM, S = p.stages, SST = p.rth * RSTR;
  float* const r_s = smem;                        // [KR][C]
  float* const ring = r_s + (size_t)KR * C;       // [S][SST]
  float* const recv =                             // [CL][3][share]
      ring + max(S * SST, p.splits * RTP * C);
  void* const recv_bar = recv + (size_t)CL * 3 * p.share;

  // R[kb + k, g*H + j0 + u] -> r_s[k * C + g * U + u], zeros past ke and H;
  // kept for the whole sequence
  if (p.vec) {
    const int c4 = C / 4;
    for (int i = tid; i < KR * c4; i += nthreads) {
      const int k = i / c4, col = (i % c4) * 4, j = j0 + col % U;
      const bool ok = kb + k < ke && j < H;
      cp_async16(r_s + k * C + col,
                 ok ? a.r + (size_t)(kb + k) * three_h +
                          (size_t)(col / U) * H + j
                    : a.r,
                 ok);
    }
  } else {
    for (int i = tid; i < KR * C; i += nthreads) {
      const int k = i / C, col = i % C, j = j0 + col % U;
      const bool ok = kb + k < ke && j < H;
      cp_async4(r_s + i,
                ok ? a.r + (size_t)(kb + k) * three_h +
                         (size_t)(col / U) * H + j
                   : a.r,
                ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  // the ranks' sums arrive by st.async, counted on recv_bar (one arrival
  // a phase: this block's expectation of their bytes)
  if (CL > 1 && tid == 0) {
    mbar_init(recv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (CL > 1)
    cluster.sync();
  else
    __syncthreads();
  unsigned phase = 0;

  for (int t = 0; t < a.T; ++t) {
    const float* h_prev = t == 0 ? a.h0 : a.hs + (size_t)(t - 1) * nh;
    const float* xw_t = a.xw + (size_t)t * N * three_h;
    for (int tile = group; tile < p.tiles; tile += p.groups) {
      const int n0 = tile * p.rows, nrows = min(p.rows, N - n0);
      // chunks c0 .. c0+n-1 of this rank's k-range of h_{t-1}, rows n0 ..
      // n0+RTP-1 (zeros past nrows and ke), into ring stages s0 .. s0+n-1:
      // row slot + rth * i of a stage at slot * RSTR + i * kChunk. One loop
      // over all n chunks, so that every thread issues its share at once.
      auto load_h = [&](int c0, int n, int s0) {
        if (p.vec) {
          constexpr int Q = kChunk / 4, SQ = TM * Q;
          for (int i = tid; i < n * RTP * Q; i += nthreads) {
            const int c = i / (RTP * Q), ci = i % (RTP * Q);
            const int slot = ci / SQ, rem = ci % SQ;
            const int row = slot + p.rth * (rem / Q), kk = (rem % Q) * 4;
            const int k = kb + (c0 + c) * kChunk + kk;
            const bool ok = row < nrows && k < ke;
            cp_async16(ring + (s0 + c) * SST + slot * RSTR +
                           (rem / Q) * kChunk + kk,
                       ok ? h_prev + (size_t)(n0 + row) * H + k : h_prev, ok);
          }
        } else {
          constexpr int SQ = TM * kChunk;
#pragma unroll 4
          for (int i = tid; i < n * RTP * kChunk; i += nthreads) {
            const int c = i / (RTP * kChunk), ci = i % (RTP * kChunk);
            const int slot = ci / SQ, rem = ci % SQ;
            const int row = slot + p.rth * (rem / kChunk), kk = rem % kChunk;
            const int k = kb + (c0 + c) * kChunk + kk;
            const bool ok = row < nrows && k < ke;
            ring[(s0 + c) * SST + slot * RSTR + rem / kChunk * kChunk + kk] =
                ok ? __ldcg(h_prev + (size_t)(n0 + row) * H + k) : 0.f;
          }
        }
      };
      // every chunk in flight at once where they fit: one commit group,
      // one wait, no barrier between chunks; else a ring: chunk c + S - 1
      // refills the stage of chunk c - 1 once every thread is past it
      const bool resident = chunks < S;
      if (resident) {
        load_h(0, chunks, 0);
        cp_async_commit();
      } else {
        for (int s = 0; s < S - 1; ++s) {
          if (s < chunks) load_h(s, 1, s);
          cp_async_commit();
        }
      }
      // the cells this rank finalises: e = row * U + u in [e0, e1)
      const int cells = nrows * U;
      const int share = round4(cdiv(cells, CL));
      const int e0 = min(cells, rank * share), e1 = min(cells, e0 + share);
      // what their gates read, into registers now: it arrives during the
      // sums
      float pre[kCells][7] = {};
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        const int e = e0 + tid + i * nthreads;
        if (e < e1 && j0 + e % U < H)
          load_cell(a, xw_t, h_prev, n0 + e / U, j0 + e % U, pre[i]);
      }

      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
      if (resident) {
        cp_async_wait<0>();
        __syncthreads();
      }
      // 4 k of the products: h rows from hq, R's columns from wq, both at
      // compile-time offsets
      auto fma4 = [&](const float* hq, const float* wq) {
        float4 hv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          hv[i] = *reinterpret_cast<const float4*>(hq + i * kChunk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w = *reinterpret_cast<const float4*>(wq + kk * C);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float hk = lane4(hv[i], kk);
            acc[i][0] = fmaf(hk, w.x, acc[i][0]);
            acc[i][1] = fmaf(hk, w.y, acc[i][1]);
            acc[i][2] = fmaf(hk, w.z, acc[i][2]);
            acc[i][3] = fmaf(hk, w.w, acc[i][3]);
          }
        }
      };
      if (resident) {   // one loop over the whole k-range, chunk c in stage c
#pragma unroll 2
        for (int q = ks; q < KR / 4; q += p.splits)
          fma4(ring + (q / (kChunk / 4)) * SST + rt * RSTR +
                   4 * (q % (kChunk / 4)),
               r_s + (size_t)4 * q * C + 4 * ct);
      } else {
        int use = 0, fill = S - 1;   // the stages of chunks c, c + S - 1
        for (int c = 0; c < chunks; ++c) {
          cp_async_wait_upto(S - 2);
          __syncthreads();   // chunk c landed; every thread is past c - 1
          if (c + S - 1 < chunks) load_h(c + S - 1, 1, fill);
          cp_async_commit();
          const float* hsm = ring + use * SST + rt * RSTR;
          const float* rs = r_s + (size_t)c * kChunk * C + 4 * ct;
          const int qn = min(kChunk, KR - c * kChunk) / 4;
          use = use + 1 == S ? 0 : use + 1;
          fill = fill + 1 == S ? 0 : fill + 1;
          for (int q = ks; q < qn; q += p.splits)
            fma4(hsm + 4 * q, rs + 4 * q * C);
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // the ring is free: the splits' sums go over it

      float* part = ring;   // [splits][RTP][C]
#pragma unroll
      for (int i = 0; i < TM; ++i)
        *reinterpret_cast<float4*>(
            part + ((size_t)ks * RTP + rt + p.rth * i) * C + 4 * ct) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      __syncthreads();
      // each cell's sum over the splits (in split order) into the shared
      // memory of the rank that finalises it, at this rank's slot: by
      // st.async, whose bytes the owner's recv_bar counts
      if (CL > 1 && tid == 0)
        mbar_expect(recv_bar, (unsigned)(CL * 3 * (e1 - e0) * 4));
      const int c4n = C / 4;
      for (int idx = tid; idx < nrows * c4n; idx += nthreads) {
        const int row = idx / c4n, col = (idx % c4n) * 4;
        // the splits added in order, loaded four at a time
        const float* ps = part + (size_t)row * C + col;
        const size_t sstr = (size_t)RTP * C;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < p.splits; s += 4) {
          float4 w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (s + i < p.splits)
              w[i] = *reinterpret_cast<const float4*>(ps + (s + i) * sstr);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (s + i < p.splits) {
              v.x += w[i].x;
              v.y += w[i].y;
              v.z += w[i].z;
              v.w += w[i].w;
            }
        }
        const int e = row * U + col % U, owner = e / share;
        float* slot =
            recv + ((size_t)rank * 3 + col / U) * share + e - owner * share;
        if (CL > 1)
          st_async(cluster_addr(slot, owner), v,
                   cluster_addr(recv_bar, owner));
        else
          *reinterpret_cast<float4*>(slot) = v;
      }
      if (CL > 1) {   // every rank's sums have reached this rank
        mbar_wait(recv_bar, phase & 1);
        ++phase;
      } else {
        __syncthreads();
      }

      // the rank's cells: the CL sums in rank order, then the gates
      auto sums = [&](int e, float (&z)[3]) {
        z[0] = z[1] = z[2] = 0.0f;
        for (int q = 0; q < CL; ++q)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            z[g] += recv[((size_t)q * 3 + g) * share + e - e0];
      };
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        const int e = e0 + tid + i * nthreads;
        const int j = j0 + e % U;
        if (e < e1 && j < H) {
          float z[3];
          sums(e, z);
          finish_cell<kSave>(a, t, n0 + e / U, j, z, pre[i]);
        }
      }
      for (int e = e0 + tid + kCells * nthreads; e < e1; e += nthreads) {
        const int n = n0 + e / U, j = j0 + e % U;
        if (j >= H) continue;
        float z[3], in[7];
        sums(e, z);
        load_cell(a, xw_t, h_prev, n, j, in);
        finish_cell<kSave>(a, t, n, j, z, in);
      }
      // the next row tile's sums must not reach this rank before it has
      // read these
      if (tile + p.groups < p.tiles) {
        if (CL > 1)
          cluster.sync();
        else
          __syncthreads();
      }
    }
    if (t + 1 < a.T) grid.sync();
  }
}

using Kernel = void (*)(Args, Geo);

template <int TM, bool kSave>
Kernel kernel_of_units(int units) {
  return units == 32   ? gru_seq_kernel<TM, 32, kSave>
         : units == 16 ? gru_seq_kernel<TM, 16, kSave>
                       : gru_seq_kernel<TM, 8, kSave>;
}

template <bool kSave>
Kernel kernel_of(const Plan& pl) {
  return pl.tm == 8   ? kernel_of_units<8, kSave>(pl.units)
         : pl.tm == 4 ? kernel_of_units<4, kSave>(pl.units)
                      : kernel_of_units<1, kSave>(pl.units);
}

// The launch configuration of a plan: the cooperative attribute (grid
// barrier) and, for clusters of more than one block, the cluster's size.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];

  Launch(const Plan& pl, cudaStream_t st, bool cooperative) : cfg{} {
    cfg.gridDim = dim3(pl.blocks);
    cfg.blockDim = dim3(pl.threads);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = st;
    int n = 0;
    if (pl.cluster > 1) {
      attr[n].id = cudaLaunchAttributeClusterDimension;
      attr[n].val.clusterDim.x = pl.cluster;
      attr[n].val.clusterDim.y = 1;
      attr[n].val.clusterDim.z = 1;
      ++n;
    }
    if (cooperative) {
      attr[n].id = cudaLaunchAttributeCooperative;
      attr[n].val.cooperative = 1;
      ++n;
    }
    cfg.attrs = attr;
    cfg.numAttrs = n;
  }
};

// The plan this device launches at batch N and width H: make_plan for its
// SM count, with the next smaller cluster where the card cannot hold all
// of the plan's blocks at once. 0, -1 (shared memory), -2 (no co-resident
// grid), -3 (an empty dimension) or a cudaError_t.
template <bool kSave>
int device_plan(int N, int H, Plan* pl) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int smem_optin = 0, sms = 0, coop = 0;
  cudaDeviceGetAttribute(&smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  int rc = -1;
  for (int mc = kMaxCluster; mc >= 1; mc /= 2) {
    const int got = make_plan(N, H, sms, mc, pl);
    if (got == -3) return got;
    if (got != 0 || pl->smem > smem_optin || !coop) {
      if (got == -2 || (got == 0 && !coop)) rc = -2;
      continue;
    }
    const Kernel k = kernel_of<kSave>(*pl);
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, pl->smem);
    if (err != cudaSuccess) return err;
    long resident = 0;
    if (pl->cluster > 1) {
      Launch l(*pl, nullptr, false);
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, k, &l.cfg);
      if (err != cudaSuccess) return err;
      resident = (long)clusters * pl->cluster;
    } else {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, k, pl->threads, pl->smem);
      if (err != cudaSuccess) return err;
      resident = (long)per_sm * sms;
    }
    if (resident >= pl->blocks) return 0;
    rc = -2;
  }
  return rc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// With `dry`, only the checks: 0 where the launch would go ahead.
template <bool kSave>
int run(const Args& a, cudaStream_t st, bool dry) {
  if (a.T < 1 || a.N < 1 || a.H < 1) return -3;
  Plan pl;
  const int rc = device_plan<kSave>(a.N, a.H, &pl);
  if (rc != 0 || dry) return rc;
  const Geo geo{pl.cluster, pl.rows,   pl.tiles,  pl.rth, pl.splits,
                pl.stages,  pl.kr,     pl.groups, pl.share,
                a.H % 4 == 0 && aligned16(a.r) && aligned16(a.h0) &&
                    aligned16(a.hs)};
  Launch l(pl, st, true);
  const cudaError_t err =
      cudaLaunchKernelEx(&l.cfg, kernel_of<kSave>(pl), a, geo);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for R's slices in shared memory on this device;
// -2: the grid cannot be made co-resident for a cooperative launch;
// -3: an empty dimension.
extern "C" int gru_seq_infer_f32(const float* xw, const float* r,
                                 const float* rb, const float* h0,
                                 float* hs, float* hT, int T, int N, int H,
                                 void* stream) {
  const Args a{xw, r, rb, h0, hs, hT, nullptr, nullptr, nullptr, T, N, H};
  return run<false>(a, (cudaStream_t)stream, false);
}

// The training forward: hs, ru [T,N,2H], rz_c and cand [T,N,H]; same
// codes.
extern "C" int gru_seq_fwd_f32(const float* xw, const float* r,
                               const float* rb, const float* h0, float* hs,
                               float* ru, float* rzc, float* cand, int T,
                               int N, int H, void* stream) {
  const Args a{xw, r, rb, h0, hs, nullptr, ru, rzc, cand, T, N, H};
  return run<true>(a, (cudaStream_t)stream, false);
}

// Whether gru_seq_infer_f32 (save = 0) or gru_seq_fwd_f32 (save = 1) would
// launch at batch N and width H on the current device: the same checks,
// and nothing launched. 0 if it would, else the code it would return. The
// wrappers choose the route with it, before any launch.
extern "C" int gru_seq_fits(int N, int H, int save) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, 1, N, H};
  return save ? run<true>(a, nullptr, true) : run<false>(a, nullptr, true);
}

// The launch plan at batch N and width H, nothing launched: with sms > 0,
// make_plan for a card of `sms` SMs (kernels/gru.py gru_seq_plan mirrors
// it); with sms <= 0, the plan the current device launches for save = 0
// (inference) or 1 (training forward), smaller clusters included.
// out[15]: units, cluster, rows, tiles, rows_per_thread, row_threads,
// col_threads, splits, threads, stages, smem_bytes, blocks, k_per_rank,
// groups, share. 0, or the codes above.
extern "C" int gru_seq_plan(int N, int H, int save, int sms, int* out) {
  Plan p;
  const int rc = sms > 0 ? make_plan(N, H, sms, kMaxCluster, &p)
                 : save  ? device_plan<true>(N, H, &p)
                         : device_plan<false>(N, H, &p);
  if (rc != 0) return rc;
  const int v[kPlanFields] = {p.units,  p.cluster, p.rows,    p.tiles,
                              p.tm,     p.rth,     p.cth,     p.splits,
                              p.threads, p.stages, p.smem,    p.blocks,
                              p.kr,     p.groups,  p.share};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* gru_seq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
