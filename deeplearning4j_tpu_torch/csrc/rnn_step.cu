// The step route of the LSTM and GRU (reset-after) recurrences for Hopper,
// sm_90a: one launch per time step, for the hidden widths whose
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
//   it. Layouts, gate order and the pointwise math are theirs:
//     LSTM  z = xw_t + h_{t-1} R;  c = f c + i g;  h = o tanh(c)
//     GRU   rz = h_{t-1} R + rb;  r, u = sigmoid(xw_ru + rz_ru)
//           cand = tanh(xw_c + r rz_c);  h = u h_{t-1} + (1 - u) cand
// - rnn_step_bwd_{lstm,gru}_f32: the reverse sweep of the backward
//   (_bwd_kernel); dR (and the GRU's drb) then come from the persistent
//   sources' fixed-order dR passes (lstm_seq_bwd_dr_f32,
//   gru_seq_bwd_dr_f32), which take any H.
//
// What bounds it on this card. Each forward step is a small-M float32
// product [N, H] x [H, G*H] (G = 4 gates for the LSTM, 3 for the GRU) and
// each backward step [N, G*H] x [G*H, H] (dz R^T), both with a pointwise
// epilogue, and each step needs the previous one's h (or dz). R is
// 50.3 MB for the GRU at H=2048, about the 50 MB of L2, so at serving
// batches the steps' R reads bound it (4*G*H^2 bytes a step at 3.35
// TB/s); at N=64 the 2*N*H*G*H multiply-adds on the plain f32 pipe (67
// TFLOP/s) do; at the LSTM's H=512 a step is ~1 us of arithmetic and the
// latency from one step to the next bounds it.
//
// Design (make_plan; kernels/rnn_step.py step_plan mirrors it):
// - A block owns a slice of U hidden units (G*U columns of R forward, U
//   rows of R backward) and every batch row: rows come in tiles of at most
//   64 (N > 64 loops over balanced row tiles inside the block, staging its
//   slice of R again for each), so at N <= 64 R is read once a step.
// - The reduction (K = H forward, G*H backward) is split across a thread
//   block cluster of CL = 1, 2 or 4 blocks that share the slice. U and CL
//   give the most blocks not above the card's SM count; among those, the
//   smallest cluster whose ranks sum at most 1024 of K, else the shortest
//   sum a rank (both rules measured on an H100). Each rank adds its split
//   groups' sums and stores each cell's sum into the shared memory of the
//   rank that finalises the cell (distributed shared memory: stores do not
//   wait for a round trip, as loads would); after barrier.cluster each
//   rank adds its cells' CL sums in rank order and runs their pointwise
//   epilogue. No atomics, no second pass: two runs give the same bits.
// - Each thread keeps a micro-tile of TM rows x 4 columns in registers
//   (TM = 8, 4 or 1 by the row count), read from shared memory as float4:
//   per 4 k, TM + 4 16-byte loads for 16*TM FMAs. A warp spans 8 (or 4)
//   rows x 4 (or 8) column groups, so each load is one shared-memory
//   wavefront. Up to 16 thread groups split each staged chunk's k, as many
//   as 256 threads allow (384 forward: one block an SM; 256 keep two).
// - Chunks of 64 k of R and of h (or dz) reach shared memory through a
//   cp.async ring of 16-byte copies (4-byte copies where H is not a
//   multiple of 4 or a pointer is not 16-byte aligned): three stages, or
//   two where only two let a block of 256 threads share its SM with the
//   next step's.
// - Steps are chained by programmatic dependent launch: every step after
//   the first is launched with cudaLaunchKernelEx and programmatic stream
//   serialisation. A block issues its first R stages (constant over the
//   sequence) and an L2 prefetch of its epilogue's inputs that the
//   previous step does not write (xw_t; the forward's residuals and dh_t
//   backward) before griddepcontrol.wait, then h_{t-1} (or dz_{t+1}), then
//   griddepcontrol.launch_dependents: the next step's blocks become
//   resident and prefetch while this step computes. The first step waits
//   for the stream as any launch does.
// The backward's launch for step t forms the carry dz_{t+1} R^T, then
// step t's dz; one more launch after t = 0 writes dh0. The LSTM's c and
// the GRU's dh*u carry live in [N,H] buffers read and written by the
// cell's owner, one launch at a time. Any N, H >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;         // k (or jg) per staged chunk
constexpr int kPad = kChunk + 4;   // row stride of the h, dz and R^T tiles
constexpr int kStages = 3;         // the ring's stages, or 2 (make_plan)
constexpr int kSmemPerSM = 233472; // bytes an H100 SM gives its blocks
// Most threads a block: 256 keep two blocks (two steps) on an SM; the
// forward takes up to 384, one block an SM, where a plan needs more
// (splits = 2 at N = 33..64 for the GRU at U = 32)
constexpr int kPairThreads = 256;
constexpr int kFwdThreads = 384;
constexpr int kMaxRows = 64;       // rows per row tile
constexpr int kMaxCluster = 4;
constexpr int kPlanFields = 13;
// a rank's share of the reduction below which a smaller cluster is taken
constexpr long kRankK = 1024;

// The launch plan. units: hidden units per block; cluster: blocks sharing
// a slice (the reduction split); rows: rows per row tile (the last may
// hold fewer); tiles: row tiles; tm: rows per thread; rth, cth: row and
// column threads (4 columns each); splits: thread groups splitting each
// chunk's k; kr: k per cluster rank, a multiple of kChunk.
struct Plan {
  int units, cluster, rows, tiles, tm, rth, cth, splits, threads, stages,
      smem, blocks, kr;
};

// The plan of a step launch: G gates, the backward or a forward, at batch
// N and width H on a card of `sms` SMs. 0, or -3 for an empty dimension.
int make_plan(int G, bool bwd, int N, int H, int sms, Plan* p) {
  if (N < 1 || H < 1 || sms < 1) return -3;
  const long K = bwd ? (long)G * H : H;
  static const int kUnits[] = {16, 32, 64};
  const int n_units = bwd ? 3 : 2;   // forward blocks hold G*U columns
  // the most blocks not above the SM count, each rank of a cluster
  // summing >= 2 chunks and none idle; among those, the smallest cluster
  // whose ranks sum at most kRankK of k, else the shortest sum a rank
  int best_u = 0, best_cl = 0;
  long best_blocks = 0, best_score = 0;
  for (int a = 0; a < n_units; ++a)
    for (int cl = 1; cl <= kMaxCluster; cl *= 2) {
      const int u = kUnits[a];
      const long blocks = (long)((H + u - 1) / u) * cl;
      const long rank_k = (K + cl - 1) / cl;
      const long kr = (rank_k + kChunk - 1) / kChunk * kChunk;
      if (blocks > sms ||
          (cl > 1 && (K < 2L * kChunk * cl || (cl - 1) * kr >= K)))
        continue;
      const long score = rank_k <= kRankK ? -cl : -kRankK - rank_k;
      if (blocks > best_blocks ||
          (blocks == best_blocks && score > best_score)) {
        best_u = u;
        best_cl = cl;
        best_blocks = blocks;
        best_score = score;
      }
    }
  if (best_blocks == 0) {   // wider than one wave: the widest slices
    best_u = kUnits[n_units - 1];
    best_cl = 1;
    best_blocks = (H + best_u - 1) / best_u;
  }
  p->units = best_u;
  p->cluster = best_cl;
  p->blocks = (int)best_blocks;
  p->tiles = (N + kMaxRows - 1) / kMaxRows;
  p->rows = (N + p->tiles - 1) / p->tiles;
  p->tm = p->rows >= 32 ? 8 : p->rows >= 4 ? 4 : 1;
  p->rth = (p->rows + p->tm - 1) / p->tm;
  p->cth = (bwd ? 1 : G) * best_u / 4;
  int ks = kChunk / 4;
  const int max_threads = bwd ? kPairThreads : kFwdThreads;
  while (ks > 1 && p->rth * p->cth * ks > max_threads) ks /= 2;
  p->splits = ks;
  p->threads = p->rth * p->cth * ks;
  const long kr = (K + best_cl - 1) / best_cl;
  p->kr = (int)((kr + kChunk - 1) / kChunk * kChunk);
  const long rt = (long)p->rth * p->tm;
  const long cols = (bwd ? 1 : G) * best_u;
  const long part = ks * rt * cols;   // the partial tile, over the ring
  const long recv = rt * cols;        // [cluster][cols / U][share]
  // three stages, or two where only two let a block of kPairThreads
  // share its SM with the next step's
  const long stage = (bwd ? best_u * (long)kPad : kChunk * cols) + rt * kPad;
  auto smem_of = [&](int stages) {
    const long ring = stages * stage;
    return (int)(4 * ((ring > part ? ring : part) + recv));
  };
  auto pairs = [&](int smem) { return 2 * (smem + 1024) <= kSmemPerSM; };
  p->stages = p->threads <= kPairThreads && !pairs(smem_of(kStages)) &&
                      pairs(smem_of(2))
                  ? 2
                  : kStages;
  p->smem = smem_of(p->stages);
  return 0;
}

// What the kernels take of the plan.
struct Geo {
  int units, cluster, rows, tiles, rth, cth, splits, kr, stages, vec;
};

struct FwdArgs {
  const float* xw;
  const float* r;
  const float* rb;
  const float* h0;
  const float* c0;
  float* hs;
  float* c_state;
  float* gates;
  float* cs;
  float* rzc;
  float* cand;
  int t, N, H;
};

struct BwdArgs {
  const float* dz_next;   // [N, G*H] of step t+1, null at t = T-1
  const float* r;
  const float* dhs;
  const float* dhT;
  const float* res0;      // LSTM gates / GRU ru
  const float* res1;      // LSTM cs / GRU rz_c
  const float* res2;      // GRU cand
  const float* hs;
  const float* h0;
  const float* c0;
  float* dxw;
  float* drz;
  float* carry;           // LSTM dc / GRU dh*u, per cell
  float* dh0;
  int t, N, H;
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes global -> shared, zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// programmatic dependent launch: wait for the previous grid's completion
// and memory; let the next grid's blocks start
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// L2 prefetch of the lines of p[0 .. n-1]
__device__ __forceinline__ void prefetch_run(const float* p, int n) {
  for (int o = 0; o < n; o += 32)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + o));
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + n - 1));
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A [rt x kChunk] tile of a row-major [*, ld] matrix (rows n0 .. n0 +
// nrows - 1, columns k0 .. k0 + kChunk - 1, zeros from column kend and row
// nrows on) into dst at row stride kPad, by the block's threads.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t ld, int n0, int nrows,
                                          int rt, int k0, int kend, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rt * (kChunk / 4); e += blockDim.x) {
      const int row = e / (kChunk / 4), kk = (e % (kChunk / 4)) * 4;
      const bool ok = row < nrows && k0 + kk < kend;
      cp_async16(dst + row * kPad + kk,
                 ok ? src + (size_t)(n0 + row) * ld + k0 + kk : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rt * kChunk; e += blockDim.x) {
      const int row = e / kChunk, kk = e % kChunk;
      const bool ok = row < nrows && k0 + kk < kend;
      cp_async4(dst + row * kPad + kk,
                ok ? src + (size_t)(n0 + row) * ld + k0 + kk : src, ok);
    }
  }
}

// The step's pointwise math for cell (n, j) from z[g] = (h_{t-1} R)[n,
// g*H + j], as the persistent forwards do it.
template <int G, bool kSave>
__device__ __forceinline__ void fwd_cell(const FwdArgs& a, int n, int j,
                                         const float (&z)[G],
                                         const float* h_prev) {
  const int H = a.H, t = a.t;
  const int gh = G * H;
  const size_t nh = (size_t)a.N * H;
  const size_t cell = (size_t)n * H + j;
  const float* x = a.xw + (size_t)t * a.N * gh + (size_t)n * gh + j;
  float h;
  if constexpr (G == 4) {
    const float ig = sigmoid(x[0] + z[0]);
    const float fg = sigmoid(x[H] + z[1]);
    const float gg = tanhf(x[2 * H] + z[2]);
    const float og = sigmoid(x[3 * H] + z[3]);
    const float c_prev = kSave ? (t == 0 ? a.c0[cell]
                                         : a.cs[(size_t)(t - 1) * nh + cell])
                               : a.c_state[cell];
    const float c = fg * c_prev + ig * gg;
    h = og * tanhf(c);
    if constexpr (kSave) {
      float* gt = a.gates + (size_t)t * a.N * gh + (size_t)n * gh + j;
      gt[0] = ig;
      gt[H] = fg;
      gt[2 * H] = gg;
      gt[3 * H] = og;
      a.cs[(size_t)t * nh + cell] = c;
    } else {
      a.c_state[cell] = c;
    }
  } else {
    const float rz_c = z[2] + a.rb[2 * H + j];
    const float rg = sigmoid(x[0] + (z[0] + a.rb[j]));
    const float ug = sigmoid(x[H] + (z[1] + a.rb[H + j]));
    const float c = tanhf(x[2 * H] + rg * rz_c);
    h = ug * h_prev[cell] + (1.0f - ug) * c;
    if constexpr (kSave) {
      float* ru = a.gates + (size_t)t * a.N * 2 * H + (size_t)n * 2 * H + j;
      ru[0] = rg;
      ru[H] = ug;
      a.rzc[(size_t)t * nh + cell] = rz_c;
      a.cand[(size_t)t * nh + cell] = c;
    }
  }
  a.hs[(size_t)t * nh + cell] = h;
}

// After a row tile's sum: adds the splits of each of the tile's cells (in
// split order) from part [splits][RT][GC*U], and stores the sum into the
// shared memory of the rank that finalises the cell (cells e = row*U + u
// in ranges of `share`): recv [CL][GC][share] there, at this rank's slot.
// Stores to the other ranks do not wait for a round trip, as loads would.
__device__ __forceinline__ void push_partials(cg::cluster_group& cluster,
                                              const float* part, float* recv,
                                              int nrows, int RT, int U, int GC,
                                              int splits, int share,
                                              int rank) {
  const int C = GC * U, c4n = C / 4;
  for (int idx = threadIdx.x; idx < nrows * c4n; idx += blockDim.x) {
    const int row = idx / c4n, col = (idx % c4n) * 4;
    float4 v = *reinterpret_cast<const float4*>(part + (size_t)row * C + col);
    for (int s = 1; s < splits; ++s) {
      const float4 w = *reinterpret_cast<const float4*>(
          part + ((size_t)s * RT + row) * C + col);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int e = row * U + col % U, owner = e / share;
    float* dst = cluster.map_shared_rank(recv, owner);
    *reinterpret_cast<float4*>(
        dst + ((size_t)rank * GC + col / U) * share + e - owner * share) = v;
  }
}

// One forward step t. G = 4 (LSTM) or 3 (GRU); TM rows per thread; at
// most kThreads threads (kPairThreads: two blocks an SM).
template <int G, int TM, bool kSave, int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == kPairThreads ? 2 : 1)
step_fwd_kernel(FwdArgs a, Geo p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // rows fastest: a warp spans 8 (or 4) rows x 4 (or 8) column groups, so
  // its h and R loads are one shared-memory wavefront each
  const int rt = tid % p.rth, ct = (tid / p.rth) % p.cth,
            ks = tid / (p.cth * p.rth);
  const int U = p.units, C = G * U, CL = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int j0 = (blockIdx.x / CL) * U;
  const int H = a.H, N = a.N;
  const int gh = G * H;
  const int RT = p.rth * TM;
  const int kb = rank * p.kr, ke = min(H, kb + p.kr);
  const int chunks = ke > kb ? (ke - kb + kChunk - 1) / kChunk : 0;
  const int stage = kChunk * C + RT * kPad;   // floats: R chunk, h chunk
  // the sums this rank finalises, past the ring (and the partial tile)
  const int S = p.stages;
  float* const recv = smem + max(S * stage, p.splits * RT * C);
  const float* h_prev =
      a.t == 0 ? a.h0 : a.hs + (size_t)(a.t - 1) * N * H;

  // R's rows k0 .. k0 + kChunk - 1, columns g*H + j0 .. + U-1 of each gate
  // g, as [kChunk][C] with column g*U + u: this thread copies 4 columns
  // (lcol) of rows lk, lk + lstep, ... (the thread count is a multiple of
  // C/4, the column threads)
  const int lcol = 4 * (tid % p.cth), lk = tid / p.cth,
            lstep = nthreads / p.cth;
  const int lj = j0 + lcol % U;
  const float* rcol = a.r + (lcol / U) * H + lj;
  auto load_r = [&](int c, int s) {
    float* dst = smem + s * stage + lcol;
    const int k0 = kb + c * kChunk;
    for (int kk = lk; kk < kChunk; kk += lstep) {
      const float* src = rcol + (size_t)(k0 + kk) * gh;
      const bool row_ok = k0 + kk < ke;
      if (p.vec) {
        cp_async16(dst + kk * C, row_ok && lj < H ? src : a.r,
                   row_ok && lj < H);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = row_ok && lj + i < H;
          cp_async4(dst + kk * C + i, ok ? src + i : a.r, ok);
        }
      }
    }
  };

  for (int tile = 0; tile < p.tiles; ++tile) {
    const int n0 = tile * p.rows;
    const int nrows = min(p.rows, N - n0);
    auto load_h = [&](int c, int s) {
      load_rows(smem + s * stage + kChunk * C, h_prev, H, n0, nrows, RT,
                kb + c * kChunk, ke, p.vec);
    };
    // this rank's share of the tile's cells, rows r0 .. r1
    const int cells = nrows * U;
    const int share = (cells + CL - 1) / CL;
    const int e0 = rank * share, e1 = min(cells, e0 + share);
    const int r0 = e0 / U, r1 = (e1 - 1) / U;
    // R and xw_t do not depend on the previous step: R's first stages
    // (which join the first h stage's commit group) and an L2 prefetch of
    // the share's xw_t rows are issued before the wait
    for (int s = 0; s < S - 1; ++s)
      if (s < chunks) load_r(s, s);
    for (int i = tid; e0 < e1 && i < (r1 - r0 + 1) * G; i += nthreads)
      prefetch_run(a.xw + ((size_t)a.t * N + n0 + r0 + i / G) * gh +
                       (i % G) * H + j0,
                   min(U, H - j0));
    if (tile == 0) griddep_wait();
    for (int s = 0; s < S - 1; ++s) {
      if (s < chunks) load_h(s, s);
      cp_async_commit();
    }
    if (tile == 0) griddep_launch_dependents();

    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    int use = 0, fill = S - 1;   // the stages of chunks c and c + S - 1
    for (int c = 0; c < chunks; ++c) {
      if (S == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();   // chunk c landed; every thread is past chunk c-1
      if (c + S - 1 < chunks) {
        load_r(c + S - 1, fill);
        load_h(c + S - 1, fill);
      }
      cp_async_commit();
      const float* rs = smem + use * stage;
      use = use + 1 == S ? 0 : use + 1;
      fill = fill + 1 == S ? 0 : fill + 1;
      const float* hsm = rs + kChunk * C;
      for (int q = ks; q < kChunk / 4; q += p.splits) {
        float4 hv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          hv[i] = *reinterpret_cast<const float4*>(
              hsm + (rt + p.rth * i) * kPad + 4 * q);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 w = *reinterpret_cast<const float4*>(
              rs + (4 * q + kk) * C + 4 * ct);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float hk = lane4(hv[i], kk);
            acc[i][0] = fmaf(hk, w.x, acc[i][0]);
            acc[i][1] = fmaf(hk, w.y, acc[i][1]);
            acc[i][2] = fmaf(hk, w.z, acc[i][2]);
            acc[i][3] = fmaf(hk, w.w, acc[i][3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free: the partial tile goes over it

    float* part = smem;   // [splits][RT][C]
#pragma unroll
    for (int i = 0; i < TM; ++i)
      *reinterpret_cast<float4*>(part + ((size_t)ks * RT + rt + p.rth * i) *
                                            C + 4 * ct) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    push_partials(cluster, part, recv, nrows, RT, U, G, p.splits, share,
                  rank);
    cluster.sync();   // every rank's sums have reached their owners

    // the share's cells, summed over the ranks in order
    for (int e = e0 + tid; e < e1; e += nthreads) {
      const int row = e / U, u = e % U, j = j0 + u;
      if (j >= H) continue;
      float z[G];
#pragma unroll
      for (int g = 0; g < G; ++g) z[g] = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < CL)
#pragma unroll
          for (int g = 0; g < G; ++g)
            z[g] += recv[((size_t)q * G + g) * share + e - e0];
      fwd_cell<G, kSave>(a, n0 + row, j, z, h_prev);
    }
    // the next row tile's sums must not reach this rank before it has
    // read these
    if (tile + 1 < p.tiles) cluster.sync();
  }
}

// The backward's pointwise math for cell (n, k) from the recurrent sum
// acc = (dz_{t+1} R^T)[n, k], as the persistent backward does it.
template <int G>
__device__ __forceinline__ void bwd_cell(const BwdArgs& a, int n, int k,
                                         float acc) {
  const int H = a.H, t = a.t;
  const int gh = G * H;
  const size_t nh = (size_t)a.N * H;
  const size_t cell = (size_t)n * H + k;
  float carry;
  if (a.dz_next == nullptr) {
    carry = a.dhT[cell];
  } else if constexpr (G == 4) {
    carry = acc;
  } else {
    carry = a.carry[cell] + acc;
  }
  if (t < 0) {
    a.dh0[cell] = carry;
    return;
  }
  const float dh = a.dhs[(size_t)t * nh + cell] + carry;
  const size_t zrow = (size_t)t * a.N * gh + (size_t)n * gh + k;
  if constexpr (G == 4) {
    const float* gt = a.res0 + zrow;
    const float ig = gt[0], fg = gt[H], gg = gt[2 * H], og = gt[3 * H];
    const float c_prev =
        t == 0 ? a.c0[cell] : a.res1[(size_t)(t - 1) * nh + cell];
    const float tc = tanhf(a.res1[(size_t)t * nh + cell]);
    const float d_o = dh * tc;
    const float dc = a.carry[cell] + dh * og * (1.0f - tc * tc);
    float* dz = a.dxw + zrow;
    dz[0] = dc * gg * ig * (1.0f - ig);
    dz[H] = dc * c_prev * fg * (1.0f - fg);
    dz[2 * H] = dc * ig * (1.0f - gg * gg);
    dz[3 * H] = d_o * og * (1.0f - og);
    a.carry[cell] = dc * fg;
  } else {
    const float* ru =
        a.res0 + (size_t)t * a.N * 2 * H + (size_t)n * 2 * H + k;
    const float rg = ru[0], ug = ru[H];
    const float hp = t == 0 ? a.h0[cell] : a.hs[(size_t)(t - 1) * nh + cell];
    const float cd = a.res2[(size_t)t * nh + cell];
    const float dcand = dh * (1.0f - ug);
    const float du = dh * (hp - cd);
    const float dc_pre = dcand * (1.0f - cd * cd);
    const float dr = dc_pre * a.res1[(size_t)t * nh + cell] * rg * (1.0f - rg);
    const float d_u = du * ug * (1.0f - ug);
    a.dxw[zrow] = dr;
    a.dxw[zrow + H] = d_u;
    a.dxw[zrow + 2 * H] = dc_pre;
    a.drz[zrow] = dr;
    a.drz[zrow + H] = d_u;
    a.drz[zrow + 2 * H] = dc_pre * rg;
    a.carry[cell] = dh * ug;
  }
}

// L2 prefetch of what bwd_cell reads for row n, units k0 .. k0+len-1,
// that the previous backward step does not write
template <int G>
__device__ __forceinline__ void bwd_prefetch(const BwdArgs& a, int n, int k0,
                                             int len) {
  const int H = a.H, t = a.t;
  const size_t nh = (size_t)a.N * H, cell = (size_t)n * H + k0;
  prefetch_run(a.dhs + t * nh + cell, len);
  if constexpr (G == 4) {
    const float* gt = a.res0 + ((size_t)t * a.N + n) * 4 * H + k0;
    for (int g = 0; g < 4; ++g) prefetch_run(gt + g * H, len);
    prefetch_run(a.res1 + t * nh + cell, len);
    prefetch_run(t == 0 ? a.c0 + cell : a.res1 + (t - 1) * nh + cell, len);
  } else {
    const float* ru = a.res0 + ((size_t)t * a.N + n) * 2 * H + k0;
    prefetch_run(ru, len);
    prefetch_run(ru + H, len);
    prefetch_run(a.res1 + t * nh + cell, len);
    prefetch_run(a.res2 + t * nh + cell, len);
    prefetch_run(t == 0 ? a.h0 + cell : a.hs + (t - 1) * nh + cell, len);
  }
}

// One backward launch: step t's carry dz_{t+1} R^T (dhT at t = T-1), then
// step t's dz; t = -1 only writes dh0 = the carry. LSTM: carry = dz_next
// R^T; GRU: carry = dhu + dz_next R^T, dhu = dh_{t+1} u_{t+1} per cell.
template <int G, int TM>
__global__ void __launch_bounds__(kPairThreads, 2)
step_bwd_kernel(BwdArgs a, Geo p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rt = tid % p.rth, ct = (tid / p.rth) % p.cth,
            ks = tid / (p.cth * p.rth);
  const int U = p.units, CL = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int k0 = (blockIdx.x / CL) * U;   // this slice's units of k
  const int H = a.H, N = a.N;
  const int gh = G * H;
  const int RT = p.rth * TM;
  const int jb = rank * p.kr, je = min(gh, jb + p.kr);
  const bool has_dz = a.dz_next != nullptr;
  const int chunks =
      has_dz && je > jb ? (je - jb + kChunk - 1) / kChunk : 0;
  const int stage = (U + RT) * kPad;   // floats: R^T chunk, dz chunk
  const int S = p.stages;
  float* const recv = smem + max(S * stage, p.splits * RT * U);

  // R[k0 .. k0+U-1, jg .. jg+31] as [U][kPad]: R^T's chunk, k by row
  auto load_r = [&](int c, int s) {
    load_rows(smem + s * stage, a.r, gh, k0, min(U, H - k0), U,
              jb + c * kChunk, je, p.vec);
  };

  for (int tile = 0; tile < p.tiles; ++tile) {
    const int n0 = tile * p.rows;
    const int nrows = min(p.rows, N - n0);
    auto load_dz = [&](int c, int s) {
      load_rows(smem + s * stage + U * kPad, a.dz_next, gh, n0, nrows, RT,
                jb + c * kChunk, je, p.vec);
    };
    const int cells = nrows * U;
    const int share = (cells + CL - 1) / CL;
    const int e0 = rank * share, e1 = min(cells, e0 + share);
    const int r0 = e0 / U, r1 = (e1 - 1) / U;
    for (int s = 0; s < S - 1; ++s)
      if (s < chunks) load_r(s, s);
    if (a.t >= 0)   // the forward's residuals and dh_t of the share's rows
      for (int row = r0 + tid; e0 < e1 && row <= r1; row += nthreads)
        bwd_prefetch<G>(a, n0 + row, k0, min(U, H - k0));
    if (tile == 0) griddep_wait();
    for (int s = 0; s < S - 1; ++s) {
      if (s < chunks) load_dz(s, s);
      cp_async_commit();
    }
    if (tile == 0) griddep_launch_dependents();

    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    int use = 0, fill = S - 1;   // the stages of chunks c and c + S - 1
    for (int c = 0; c < chunks; ++c) {
      if (S == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      if (c + S - 1 < chunks) {
        load_r(c + S - 1, fill);
        load_dz(c + S - 1, fill);
      }
      cp_async_commit();
      const float* rts = smem + use * stage;
      use = use + 1 == S ? 0 : use + 1;
      fill = fill + 1 == S ? 0 : fill + 1;
      const float* dzs = rts + U * kPad;
      for (int q = ks; q < kChunk / 4; q += p.splits) {
        float4 dv[TM], wv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          dv[i] = *reinterpret_cast<const float4*>(
              dzs + (rt + p.rth * i) * kPad + 4 * q);
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          wv[c4] = *reinterpret_cast<const float4*>(
              rts + (ct + p.cth * c4) * kPad + 4 * q);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            float s = acc[i][c4];
            s = fmaf(dv[i].x, wv[c4].x, s);
            s = fmaf(dv[i].y, wv[c4].y, s);
            s = fmaf(dv[i].z, wv[c4].z, s);
            acc[i][c4] = fmaf(dv[i].w, wv[c4].w, s);
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    float* part = smem;   // [splits][RT][U]
    if (has_dz) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          part[((size_t)ks * RT + rt + p.rth * i) * U + ct + p.cth * c4] =
              acc[i][c4];
      __syncthreads();
      push_partials(cluster, part, recv, nrows, RT, U, 1, p.splits, share,
                    rank);
      cluster.sync();
    }

    for (int e = e0 + tid; e < e1; e += nthreads) {
      const int row = e / U, u = e % U, k = k0 + u;
      if (k >= H) continue;
      float sum = 0.0f;
      if (has_dz)
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)
          if (q < CL) sum += recv[(size_t)q * share + e - e0];
      bwd_cell<G>(a, n0 + row, k, sum);
    }
    if (has_dz && tile + 1 < p.tiles) cluster.sync();
  }
}

Geo geo_of(const Plan& pl, bool vec) {
  return Geo{pl.units, pl.cluster, pl.rows,   pl.tiles, pl.rth,
             pl.cth,   pl.splits,  pl.kr,     pl.stages, vec ? 1 : 0};
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// The plan for this launch, on the current device.
int device_plan(int G, bool bwd, int N, int H, Plan* pl) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return make_plan(G, bwd, N, H, sms, pl);
}

// One step's launch: the plan's grid and cluster, programmatic stream
// serialisation for every step after the first. Returns the launch's
// cudaError_t.
template <typename Args>
int launch(void (*kern)(Args, Geo), const Plan& pl, bool pdl,
           cudaStream_t st, const Args& args, const Geo& geo) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.blocks);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args, geo);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// Dynamic shared memory past 48 KB, and the largest carveout, so that two
// blocks that need up to 110 KB each can share an SM.
int set_smem(const void* kern, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int G, int TM, bool kSave>
int fwd_steps(FwdArgs a, const Plan& pl, bool vec, int T, cudaStream_t st) {
  void (*kern)(FwdArgs, Geo) =
      pl.threads > kPairThreads ? step_fwd_kernel<G, TM, kSave, kFwdThreads>
                                : step_fwd_kernel<G, TM, kSave, kPairThreads>;
  const int err = set_smem((const void*)kern, pl.smem);
  if (err != 0) return err;
  const Geo geo = geo_of(pl, vec);
  for (int t = 0; t < T; ++t) {
    a.t = t;
    const int rc = launch(kern, pl, t > 0, st, a, geo);
    if (rc != 0) return rc;
  }
  return 0;
}

template <int G, int TM>
int bwd_steps(BwdArgs a, const Plan& pl, bool vec, int T, cudaStream_t st) {
  void (*kern)(BwdArgs, Geo) = step_bwd_kernel<G, TM>;
  const int err = set_smem((const void*)kern, pl.smem);
  if (err != 0) return err;
  const Geo geo = geo_of(pl, vec);
  const size_t zstep = (size_t)a.N * G * a.H;
  // the recurrent-side dz: dxw itself for the LSTM, drz for the GRU
  const float* dz = G == 4 ? a.dxw : a.drz;
  for (int t = T - 1; t >= -1; --t) {
    a.t = t;
    a.dz_next = t == T - 1 ? nullptr : dz + (size_t)(t + 1) * zstep;
    const int rc = launch(kern, pl, t < T - 1, st, a, geo);
    if (rc != 0) return rc;
  }
  return 0;
}

template <int G, bool kSave>
int fwd_by_rows(const FwdArgs& a, int T, cudaStream_t st) {
  Plan pl;
  const int rc = device_plan(G, false, a.N, a.H, &pl);
  if (rc != 0) return rc;
  const bool vec = a.H % 4 == 0 && aligned16(a.r) && aligned16(a.h0) &&
                   aligned16(a.hs);
  switch (pl.tm) {
    case 8: return fwd_steps<G, 8, kSave>(a, pl, vec, T, st);
    case 4: return fwd_steps<G, 4, kSave>(a, pl, vec, T, st);
    default: return fwd_steps<G, 1, kSave>(a, pl, vec, T, st);
  }
}

template <int G>
int bwd_by_rows(const BwdArgs& a, int T, cudaStream_t st) {
  Plan pl;
  const int rc = device_plan(G, true, a.N, a.H, &pl);
  if (rc != 0) return rc;
  const bool vec = a.H % 4 == 0 && aligned16(a.r) &&
                   aligned16(G == 4 ? a.dxw : a.drz);
  switch (pl.tm) {
    case 8: return bwd_steps<G, 8>(a, pl, vec, T, st);
    case 4: return bwd_steps<G, 4>(a, pl, vec, T, st);
    default: return bwd_steps<G, 1>(a, pl, vec, T, st);
  }
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
  const FwdArgs a{xw, r, nullptr, h0, c0, hs, c_state, gates, cs,
                  nullptr, nullptr, 0, N, H};
  cudaStream_t st = (cudaStream_t)stream;
  return save ? fwd_by_rows<4, true>(a, T, st)
              : fwd_by_rows<4, false>(a, T, st);
}

// The GRU forward: save = 0 writes hs; save = 1 also ru, rz_c and cand.
extern "C" int rnn_step_fwd_gru_f32(const float* xw, const float* r,
                                    const float* rb, const float* h0,
                                    float* hs, float* ru, float* rzc,
                                    float* cand, int save, int T, int N,
                                    int H, void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  const FwdArgs a{xw, r, rb, h0, nullptr, hs, nullptr, ru, nullptr,
                  rzc, cand, 0, N, H};
  cudaStream_t st = (cudaStream_t)stream;
  return save ? fwd_by_rows<3, true>(a, T, st)
              : fwd_by_rows<3, false>(a, T, st);
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
  const BwdArgs a{nullptr, r, dhs, dhT, gates, cs, nullptr, nullptr,
                  nullptr, c0, dxw, nullptr, dc_state, dh0, 0, N, H};
  return bwd_by_rows<4>(a, T, (cudaStream_t)stream);
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
  const BwdArgs a{nullptr, r, dhs, dhT, ru, rzc, cand, hs,
                  h0, nullptr, dxw, drz, dhu, dh0, 0, N, H};
  return bwd_by_rows<3>(a, T, (cudaStream_t)stream);
}

// The launch plan of a step kernel, nothing launched: cell 0 (LSTM) or 1
// (GRU); kind 0 (inference forward), 1 (training forward) or 2 (backward);
// at batch N and width H on a card of `sms` SMs. out[13]: units, cluster,
// rows, tiles, rows_per_thread, row_threads, col_threads, splits, threads,
// stages, smem_bytes, blocks, k_per_rank. 0, -3 for an empty dimension,
// -4 for an unknown cell or kind.
extern "C" int rnn_step_plan(int cell, int kind, int N, int H, int sms,
                             int* out) {
  if (cell < 0 || cell > 1 || kind < 0 || kind > 2) return -4;
  Plan p;
  const int rc = make_plan(cell == 0 ? 4 : 3, kind == 2, N, H, sms, &p);
  if (rc != 0) return rc;
  const int v[kPlanFields] = {p.units, p.cluster, p.rows,   p.tiles,
                              p.tm,    p.rth,     p.cth,    p.splits,
                              p.threads, p.stages, p.smem,  p.blocks,
                              p.kr};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* rnn_step_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
