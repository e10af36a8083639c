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
// that is 40.3 GFLOP of f32 FMA each, 0.60 ms on the non-tensor f32 pipe
// (67 TFLOP/s), against 0.36 GB of inputs and outputs read or written
// once, 0.11 ms at 3.35 TB/s: operations bound it. At N <= 32 the T
// serial steps do, each one a grid-wide barrier. The sweep also reads
// drz_{t+1} from L2 once per unit slice each step: N*3H*H/U floats.
//
// Design (two kernels on one stream; launch plans make_plan and
// make_dr_plan, mirrored by kernels/gru.py gru_seq_bwd_plan and
// gru_bwd_dr_plan; scripts/gru_seq_bwd_ab.py measured each choice on an
// H100, PERF.md section 6):
//
// 1. The sweep, one cooperative launch walking t downwards. Each step is
//    the product drz_{t+1} [N,3H] x R^T [3H,H] plus the gates. A block of
//    16 warps owns U = 8, 16 or 20 hidden units k, and a thread-block
//    cluster of CL = 1 or 2 blocks shares the unit slice and splits the
//    sum over j (3H): rank q keeps R's rows of the slice over its j-range
//    [q JR, (q+1) JR) in shared memory, unit-major ([U][JR], 96 KiB at
//    H=1024), for the whole sweep, and reads only that j-range of each
//    drz_{t+1} row. At H=1024 the plan takes 128 blocks of 16 units in
//    clusters of 2: each SM reads 64 rows x 1536 j a step from L2, half
//    of what the kernel before read (8 units and every j a block, two
//    blocks an SM); U = 20 keeps the widths up to H=1205 that it took.
//    The plan takes the most blocks not above the SM count whose shared
//    memory fits, then the most units; where the card cannot hold the
//    plan's clusters at once the launch takes a cluster of 1.
//    - Each warp owns RW rows (1, 2 or 4 by N; a row tile is 16 RW rows)
//      and its lanes split the rank's j in runs of 4 (j = 4 lane + 128 i,
//      float4): a lane reads its RW drz_{t+1} values straight from L2
//      (__ldcg: other blocks wrote them during this launch; no row is
//      read twice on an SM) and the slice's R values from shared memory,
//      and keeps RW x U sums. Staging drz in shared memory instead (the
//      forward's cp.async ring, a register tile of 8 rows x 4 units) was
//      measured: the copies alone took ~10 us a step at N=64 and did not
//      overlap the products (~15-18 us alone at 8 warps an SM), against
//      ~17 us a step for the whole of the kernel before; 8 rows x 8 units
//      a lane (the half warps sharing each load) spilled and ran slower.
//      At 512 threads a thread has 128 registers: the 4-row kernels spill
//      ~100 bytes; loading the cells' inputs before the sums (as the 1- and
//      2-row kernels do) or a second j run in flight spilled more there.
//    - A reduce-scatter butterfly of warp shuffles adds the 32 lanes'
//      sums in a fixed order, then each sum goes by st.async to the rank
//      that finalises its cell (rank q the units [q U/CL, (q+1) U/CL)),
//      whose mbarrier counts the bytes; it adds the CL sums in rank order.
//    - Each cell (n, k) is finalised by one thread of one rank for the
//      whole sweep, so the carry dh u lives in dh0 (read and written only
//      by its owner) and needs no exchange. One more pass after t = 0 adds
//      drz_0 R^T into dh0. Steps are separated by the grid barrier.
//    What holds it at N=64 (block 0's clock stamps): the products, ~14 us
//    of a ~19 us step (R's values come from shared memory at 4 wavefronts
//    a load for 16 FMAs a lane, as in the kernel before), and the grid
//    barrier, ~2 us.
// 2. dR and drb: the product hprev^T [H, M] x drz [M, 3H], M = T*N (hprev
//    is h0 for t = 0, hs[t-1] after). A block owns a 128 x 128 tile of dR,
//    each of its 256 threads an 8 x 8 register tile, and sums over its
//    chunk of M in steps of 16 through a six-stage cp.async ring (one
//    barrier a step; 128 registers at two blocks an SM, no spills). The
//    plan splits M into `splits` chunks (1, 2 or 4) so that tiles x splits
//    fill the card's block slots evenly (at H=1024 192 tiles x 4 = 768
//    blocks, 2.9 waves of 264); the blocks of one tile form a cluster,
//    leave their partial tiles in shared memory and each rank adds its
//    rows' partials in rank order through distributed shared memory. The
//    blocks of the first row of tiles also sum their drz columns from the
//    staged tiles into drb, in the same fixed order.
//
// No atomics anywhere: every sum runs in a fixed order, so two runs give
// the same bits. Plain f32 FMA; tensor cores are left alone (f32 parity).
// The ragged edges in N, H and j are masked; no shape alignment is needed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "warp_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;                // a block's warps
constexpr int kThreads = kWarps * 32;     // one block an SM
constexpr int kMaxCluster = 2;
constexpr int kSmemOptin = 232448;        // bytes a block may opt into (H100)
constexpr int kMaxSums = 64;              // sums a lane keeps (padded)
constexpr int kPlanFields = 9;

// The sweep's launch plan. units: hidden units per block; cluster: blocks
// sharing a unit slice (the j split); rw: rows per warp; tiles: row tiles
// of kWarps * rw rows; threads: the block; smem: dynamic shared memory
// bytes; blocks: the grid; jr: j per cluster rank (a multiple of 4);
// groups: blocks with the same units and rank that split the row tiles.
struct Plan {
  int units, cluster, rw, tiles, threads, smem, blocks, jr, groups;
};

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round4(int a) { return (a + 3) & ~3; }
// the sums a lane keeps: rw x units, padded to a power of two for the
// warp's reduce-scatter
__host__ __device__ constexpr int padded_sums(int rw, int u) {
  return rw * u <= 8    ? 8
         : rw * u <= 16 ? 16
         : rw * u <= 32 ? 32
         : rw * u <= 64 ? 64
                        : 128;
}

// Rows per warp at batch N for u units a block: 1 up to kWarps rows, 2 up
// to 2 kWarps, else 4, as long as a lane's sums fit in kMaxSums.
int rows_per_warp(int N, int u) {
  int rw = N <= kWarps ? 1 : N <= 2 * kWarps ? 2 : 4;
  while (rw > 1 && padded_sums(rw, u) > kMaxSums) rw /= 2;
  return rw;
}

// bytes: R's slice [u][jr], then the ranks' sums [cl][kWarps][rw][u / cl]
// and the mbarrier that counts their arrival (16 bytes)
long smem_of(int jr, int u, int rw) {
  return 4 * ((long)u * jr + (long)kWarps * rw * u) + 16;
}

// The plan at batch N, width H, on `sms` SMs, with clusters of at most
// max_cluster blocks. 0; -1 where no R slice fits in shared memory; -2
// where one fits but needs more blocks than SMs; -3 for an empty dimension.
int make_plan(int N, int H, int sms, int max_cluster, Plan* p) {
  if (N < 1 || H < 1 || sms < 1) return -3;
  const int J = 3 * H;
  static const int kUnitChoices[] = {8, 16, 20};
  int rc = -1;
  for (int a = 0; a < 3; ++a)
    for (int cl = 1; cl <= max_cluster; cl *= 2) {
      const int u = kUnitChoices[a];
      const long blocks = (long)cdiv(H, u) * cl;
      const int jr = round4(cdiv(J, cl));
      if (cl > 1 && (long)(cl - 1) * jr >= J) continue;   // an idle rank
      const int rw = rows_per_warp(N, u);
      if (smem_of(jr, u, rw) > kSmemOptin) continue;
      if (blocks > sms) {
        if (rc == -1) rc = -2;
        continue;
      }
      // the most blocks, then the most units (the least of drz read)
      if (rc == 0 && (blocks < p->blocks ||
                      (blocks == p->blocks && u <= p->units)))
        continue;
      rc = 0;
      p->units = u;
      p->cluster = cl;
      p->rw = rw;
      p->blocks = (int)blocks;
      p->jr = jr;
    }
  if (rc != 0) return rc;
  p->tiles = cdiv(N, kWarps * p->rw);
  int groups = sms / p->blocks;
  if (groups > p->tiles) groups = p->tiles;
  p->groups = groups;
  p->blocks *= groups;
  p->threads = kThreads;
  p->smem = (int)smem_of(p->jr, p->units, p->rw);
  return 0;
}

struct Args {
  const float* dhs;
  const float* dhT;
  const float* ru;
  const float* rzc;
  const float* cand;
  const float* hs;
  const float* r;
  const float* h0;
  float* dxw;
  float* drz;
  float* dh0;
  int T, N, H;
};

// What the kernel takes of the plan (units, rows per warp and the
// vector width are template parameters).
struct Geo {
  int cluster, tiles, jr, groups;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared through L2, zeros where !ok
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zeros where !ok
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

// The shared::cluster address of p (in this block's shared memory) in the
// shared memory of cluster rank `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// 4 bytes into another block's shared memory; their arrival completes 4
// bytes of the transaction count of the mbarrier at `bar` there
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// 16 bytes of another cluster rank's shared memory
__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// every thread of the cluster: this one's shared-memory writes are seen by
// the others after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// What the gates of cell (n, k) at step t read besides its sum: dhs_t,
// the carry (dhT at T-1, else dh0, which only this thread writes), r, u,
// cand, rz_c and h_prev.
__device__ __forceinline__ void load_cell(const Args& a, int t, int n, int k,
                                          float (&in)[7]) {
  const int H = a.H;
  const size_t nh = (size_t)a.N * H;
  const size_t cell = (size_t)n * H + k;
  const float* ru_t = a.ru + (size_t)t * a.N * 2 * H + (size_t)n * 2 * H + k;
  in[0] = __ldg(a.dhs + (size_t)t * nh + cell);
  in[1] = t == a.T - 1 ? __ldg(a.dhT + cell) : a.dh0[cell];
  in[2] = __ldg(ru_t);
  in[3] = __ldg(ru_t + H);
  in[4] = __ldg(a.cand + (size_t)t * nh + cell);
  in[5] = __ldg(a.rzc + (size_t)t * nh + cell);
  in[6] = t == 0 ? __ldg(a.h0 + cell)
                 : __ldg(a.hs + (size_t)(t - 1) * nh + cell);
}

// The gates of cell (n, k) from its sum s (drz_{t+1} R^T, 0 at T-1) and
// load_cell's values, as the reference computes them: writes dxw_t and
// drz_t, and the carry's local part dh u into dh0.
__device__ __forceinline__ void finish_cell(const Args& a, int t, int n,
                                            int k, float s,
                                            const float (&in)[7]) {
  const int H = a.H;
  const float dh = in[0] + (t == a.T - 1 ? in[1] : in[1] + s);
  const float rg = in[2], ug = in[3], c = in[4], rz_c = in[5], hp = in[6];
  const float dcand = dh * (1.0f - ug);
  const float du = dh * (hp - c);
  const float dc = dcand * (1.0f - c * c);
  const float dr = dc * rz_c * rg * (1.0f - rg);
  const float dU = du * ug * (1.0f - ug);
  const size_t row = ((size_t)t * a.N + n) * 3 * H + k;
  a.dxw[row] = dr;
  a.dxw[row + H] = dU;
  a.dxw[row + 2 * H] = dc;
  a.drz[row] = dr;
  a.drz[row + H] = dU;
  a.drz[row + 2 * H] = dc * rg;
  a.dh0[(size_t)n * H + k] = dh * ug;
}

// The whole reverse sweep. RW rows per warp, U units a block, VEC
// consecutive j per lane and load (4 where H % 4 == 0 and the pointers
// are aligned, so that drz rows and R rows are read as float4).
template <int RW, int U, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_sweep_kernel(Args a, Geo p) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int C = RW * U;                  // sums a lane keeps
  constexpr int CP = padded_sums(RW, U);     // padded for the reduction
  constexpr int kSpread = CP >= 32 ? 1 : 32 / CP;   // lanes holding a sum
  constexpr int kCellsPerLane = cdiv(C, 32);
  // measured per kernel (scripts/gru_seq_bwd_ab.py, PERF.md): at 4 rows a
  // warp, 64 sums a lane leave no registers for the cell inputs before the
  // sums nor for a second j run in flight (either spills); at 1 row a warp
  // the unrolled loop is faster
  constexpr bool kPreload = RW < 4;
  constexpr int kUnroll = RW == 1 ? 2 : 1;
  using VecT = typename std::conditional<VEC == 4, float4, float>::type;
  static_assert(CP <= kMaxSums && U % 2 == 0, "sums");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int CL = p.cluster, UO = U / CL;   // units a rank finalises
  const int H = a.H, N = a.N, J = 3 * H;
  const int rank = (int)cluster.block_rank();
  const int slices = (H + U - 1) / U;
  const int cl_id = blockIdx.x / CL;
  const int k0 = (cl_id % slices) * U, group = cl_id / slices;
  const size_t n3h = (size_t)N * J;
  const int JR = p.jr, jb = rank * JR, je = min(J, jb + JR);
  float* const r_s = smem;                           // [U][JR]
  float* const recv = r_s + (size_t)U * JR;          // [CL][kWarps][RW][UO]
  void* const recv_bar = recv + kWarps * RW * U;

  // r_s[u * JR + j] = R[k0 + u, jb + j], zeros past je and H; kept for the
  // whole sweep
  for (int i = tid; i < U * (JR / VEC); i += kThreads) {
    const int u = i / (JR / VEC), j = (i % (JR / VEC)) * VEC, k = k0 + u;
    VecT v{};
    if (k < H && jb + j < je)
      v = __ldg(reinterpret_cast<const VecT*>(a.r + (size_t)k * J + jb + j));
    *reinterpret_cast<VecT*>(r_s + (size_t)u * JR + j) = v;
  }
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

  // t = T-1 .. 0 are the steps; t = -1 only adds drz_0 R^T into dh0
  for (int t = a.T - 1; t >= -1; --t) {
    const bool have_next = t + 1 < a.T;   // drz_{t+1} exists
    const float* d_next = a.drz + (size_t)(t + 1) * n3h;
    for (int tile = group; tile < p.tiles; tile += p.groups) {
      const int n0 = tile * kWarps * RW;
      const int nb = n0 + warp * RW;   // this warp's first row
      // what the gates of this lane's first cell read, into registers now:
      // it arrives during the sums
      float pre[7] = {};
      if (kPreload && t >= 0 && lane < RW * UO) {
        const int n = nb + lane / UO, k = k0 + rank * UO + lane % UO;
        if (n < N && k < H) load_cell(a, t, n, k, pre);
      }
      float acc[CP];
#pragma unroll
      for (int i = 0; i < CP; ++i) acc[i] = 0.0f;
      if (have_next && nb < N) {   // warp-uniform
        // the lanes split this rank's j in runs of VEC; acc[r U + u] sums
        // drz_{t+1}[nb + r, j] R[k0 + u, j] over this lane's j (16 warps an
        // SM cover the loads' latency where the loop is not unrolled)
#pragma unroll kUnroll
        for (int j = VEC * lane; j < JR; j += 32 * VEC) {
          float d[RW][VEC];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            VecT x{};
            if (nb + r < N && jb + j < je)
              x = __ldcg(reinterpret_cast<const VecT*>(
                  d_next + (size_t)(nb + r) * J + jb + j));
            if constexpr (VEC == 4) {
              d[r][0] = x.x; d[r][1] = x.y; d[r][2] = x.z; d[r][3] = x.w;
            } else {
              d[r][0] = x;
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const VecT w =
                *reinterpret_cast<const VecT*>(r_s + (size_t)u * JR + j);
            float wv[VEC];
            if constexpr (VEC == 4) {
              wv[0] = w.x; wv[1] = w.y; wv[2] = w.z; wv[3] = w.w;
            } else {
              wv[0] = w;
            }
#pragma unroll
            for (int r = 0; r < RW; ++r)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[r * U + u] = fmaf(d[r][e], wv[e], acc[r * U + u]);
          }
        }
      }
      if (have_next) {
        warp_reduce_scatter<CP>(acc, lane);
        // each sum into the shared memory of the rank that finalises its
        // cell, at this rank's slot: by st.async, whose bytes the owner's
        // recv_bar counts (every sum, zeros past N and H included)
        if (CL > 1 && tid == 0)
          mbar_expect(recv_bar, (unsigned)(CL * kWarps * RW * UO * 4));
        auto push = [&](int x, float s) {
          if (x >= C) return;
          const int r = x / U, u = x % U, owner = u / UO;
          float* slot = recv +
                        ((size_t)(rank * kWarps + warp) * RW + r) * UO + u -
                        owner * UO;
          if (CL > 1)
            st_async(cluster_addr(slot, owner), s,
                     cluster_addr(recv_bar, owner));
          else
            *slot = s;
        };
        if constexpr (CP == 64) {
          push(2 * lane, acc[0]);
          push(2 * lane + 1, acc[1]);
        } else {
          if (lane % kSpread == 0) push(lane / kSpread, acc[0]);
        }
        if (CL > 1) {   // every rank's sums have reached this rank
          mbar_wait(recv_bar, phase & 1);
          ++phase;
        } else {
          __syncthreads();
        }
      }

      // this warp's cells on this rank: RW rows x UO units, lane l taking
      // c = l, l + 32; the CL sums in rank order, then the gates (at t = -1
      // the last carry)
#pragma unroll
      for (int i = 0; i < kCellsPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c >= RW * UO) continue;
        const int r = c / UO, uu = c % UO;
        const int n = nb + r, k = k0 + rank * UO + uu;
        if (n >= N || k >= H) continue;
        float z = 0.0f;
        if (have_next)
          for (int q = 0; q < CL; ++q)
            z += recv[((size_t)(q * kWarps + warp) * RW + r) * UO + uu];
        const size_t cell = (size_t)n * H + k;
        if (t < 0) {
          a.dh0[cell] = a.dh0[cell] + z;
        } else if (kPreload && i == 0) {
          finish_cell(a, t, n, k, z, pre);
        } else {
          float in[7];
          load_cell(a, t, n, k, in);
          finish_cell(a, t, n, k, z, in);
        }
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
    if (t >= 0) grid.sync();
  }
}

using SweepKernel = void (*)(Args, Geo);

template <int RW, int VEC>
SweepKernel kernel_of_units(int units) {
  if constexpr (RW == 4)   // 20 units take at most 2 rows a warp
    return units == 16 ? gru_bwd_sweep_kernel<4, 16, VEC>
                       : gru_bwd_sweep_kernel<4, 8, VEC>;
  else
    return units == 20   ? gru_bwd_sweep_kernel<RW, 20, VEC>
           : units == 16 ? gru_bwd_sweep_kernel<RW, 16, VEC>
                         : gru_bwd_sweep_kernel<RW, 8, VEC>;
}

template <int VEC>
SweepKernel kernel_of_rows(const Plan& pl) {
  return pl.rw == 4   ? kernel_of_units<4, VEC>(pl.units)
         : pl.rw == 2 ? kernel_of_units<2, VEC>(pl.units)
                      : kernel_of_units<1, VEC>(pl.units);
}

SweepKernel kernel_of(const Plan& pl, bool vec) {
  return vec ? kernel_of_rows<4>(pl) : kernel_of_rows<1>(pl);
}

// The launch configuration: the cooperative attribute (grid barrier) and,
// for clusters of more than one block, the cluster's size.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];

  Launch(int blocks, int threads, int smem, int cluster, cudaStream_t st,
         bool cooperative)
      : cfg{} {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    int n = 0;
    if (cluster > 1) {
      attr[n].id = cudaLaunchAttributeClusterDimension;
      attr[n].val.clusterDim.x = cluster;
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

struct Device {
  int smem_optin = 0, sms = 0, coop = 0;
};

cudaError_t device_of(Device* d) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&d->smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&d->coop, cudaDevAttrCooperativeLaunch, dev);
  return cudaSuccess;
}

// The sweep plan this device launches at batch N and width H: make_plan
// for its SM count, with the next smaller cluster where the card cannot
// hold all of the plan's blocks at once. 0, -1 (shared memory), -2 (no
// co-resident grid), -3 (an empty dimension) or a cudaError_t. (Both
// vector widths of a kernel use the same resources.)
int device_plan(int N, int H, Plan* pl) {
  Device d;
  cudaError_t err = device_of(&d);
  if (err != cudaSuccess) return err;
  int rc = -1;
  for (int mc = kMaxCluster; mc >= 1; mc /= 2) {
    const int got = make_plan(N, H, d.sms, mc, pl);
    if (got == -3) return got;
    if (got != 0 || pl->smem > d.smem_optin || !d.coop) {
      if (got == -2 || (got == 0 && !d.coop)) rc = -2;
      continue;
    }
    for (int vec = 0; vec < 2; ++vec) {
      err = cudaFuncSetAttribute(kernel_of(*pl, vec),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 pl->smem);
      if (err != cudaSuccess) return err;
    }
    const SweepKernel k = kernel_of(*pl, true);
    long resident = 0;
    if (pl->cluster > 1) {
      Launch l(pl->blocks, pl->threads, pl->smem, pl->cluster, nullptr,
               false);
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, k, &l.cfg);
      if (err != cudaSuccess) return err;
      resident = (long)clusters * pl->cluster;
    } else {
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, k, pl->threads, pl->smem);
      if (err != cudaSuccess) return err;
      resident = (long)per_sm * d.sms;
    }
    if (resident >= pl->blocks) return 0;
    rc = -2;
  }
  return rc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// The reverse sweep, or with `dry` only its checks; codes as below.
int sweep(const Args& a, cudaStream_t st, bool dry) {
  if (a.T < 1 || a.N < 1 || a.H < 1) return -3;
  Plan pl;
  const int rc = device_plan(a.N, a.H, &pl);
  if (rc != 0 || dry) return rc;
  const Geo geo{pl.cluster, pl.tiles, pl.jr, pl.groups};
  const bool vec = a.H % 4 == 0 && aligned16(a.r) && aligned16(a.drz);
  Launch l(pl.blocks, pl.threads, pl.smem, pl.cluster, st, true);
  const cudaError_t err =
      cudaLaunchKernelEx(&l.cfg, kernel_of(pl, vec), a, geo);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// ---------------------------------------------------------------------------
// dR and drb
// ---------------------------------------------------------------------------

constexpr int kDrBM = 128;   // rows of a dR tile (k)
constexpr int kDrBN = 128;   // columns (j)
constexpr int kDrBK = 16;    // m per step
constexpr int kDrThreads = 256;
constexpr int kDrStages = 6;
constexpr int kDrPerSm = 2;  // blocks an SM (the launch bounds)
constexpr int kDrMaxSplits = 4;
constexpr int kDrReduceSteps = 4;   // the cluster's sum, counted in steps
constexpr int kDrStageFloats = kDrBK * (kDrBM + kDrBN);
// a split's partial tile goes over the ring once the sums are done
static_assert(kDrStages * kDrStageFloats >= kDrBM * kDrBN, "ring");
constexpr int kDrPlanFields = 5;

// tiles: dR tiles; splits: chunks of M (the blocks of one tile, a
// cluster); chunk: m a split sums (a multiple of kDrBK); blocks: the
// grid; smem: dynamic shared memory bytes.
struct DrPlan {
  int tiles, splits, chunk, blocks, smem;
};

// The dR pass's plan for M = T * N rows on `sms` SMs: the splits of M
// (1, 2 or 4) that give the least time counted as waves of kDrPerSm
// blocks an SM times the steps of 16 m a block sums (plus the cluster's
// sum), the fewer splits where two tie. 0, or -3 for an empty dimension.
int make_dr_plan(int T, int N, int H, int sms, DrPlan* p) {
  if (T < 1 || N < 1 || H < 1 || sms < 1) return -3;
  const long M = (long)T * N;
  const int tiles = cdiv(H, kDrBM) * cdiv(3 * H, kDrBN);
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
  p->smem = (kDrStages * kDrStageFloats + kDrBN) * 4;
  return 0;
}

// dR[k, j] = sum over m = t*N + n of hprev[m, k] * drz[m, j], where
// hprev[m] is h0[n] for t = 0 and hs[t-1][n] after; drb[j] = sum over m
// of drz[m, j]. Block b is split b % splits (its cluster rank) of tile
// b / splits, and sums m in [split * chunk, (split + 1) * chunk). Thread
// (ty, tx) of 16 x 16 owns rows {4 ty + i, 64 + 4 ty + i} and columns
// {4 tx + i, 64 + 4 tx + i} of the tile. kVec: 16-byte copies (H % 4 == 0
// and aligned pointers).
template <bool kVec>
__global__ void __launch_bounds__(kDrThreads, kDrPerSm)
gru_bwd_dr_kernel(const float* __restrict__ hs,
                  const float* __restrict__ h0,
                  const float* __restrict__ drz, float* __restrict__ dr,
                  float* __restrict__ drb, int M, int N, int H, int splits,
                  int chunk) {
  extern __shared__ __align__(16) float dsm[];
  float* const bias_s = dsm + kDrStages * kDrStageFloats;   // [kDrBN]
  const int three_h = 3 * H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int split = blockIdx.x % splits, tile = blockIdx.x / splits;
  const int tiles_j = cdiv(three_h, kDrBN);
  const int k0 = (tile / tiles_j) * kDrBM, j0 = (tile % tiles_j) * kDrBN;
  const int m_begin = min(M, split * chunk), m_end = min(M, m_begin + chunk);
  const int steps = cdiv(m_end - m_begin, kDrBK);
  const bool sums_bias = k0 == 0 && tid < kDrBN;

  // step s's rows m of hprev (columns k0 ..) and drz (columns j0 ..) into
  // stage st: a_s [kDrBK][kDrBM], then b_s [kDrBK][kDrBN]; zeros past
  // m_end, H and 3H
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
        const bool oka = okm && kg < H, okb = okm && j < three_h;
        const float* pa = m < N ? h0 + (size_t)m * H + kg
                                : hs + (size_t)(m - N) * H + kg;
        cp_async16(a_s + row * kDrBM + col, oka ? pa : h0, oka);
        cp_async16(b_s + row * kDrBN + col,
                   okb ? drz + (size_t)m * three_h + j : drz, okb);
      }
    } else {
#pragma unroll
      for (int l = 0; l < kDrBK * kDrBM / kDrThreads; ++l) {
        const int e = tid + kDrThreads * l;
        const int row = e / kDrBM, col = e % kDrBM;
        const int m = m0 + row, kg = k0 + col, j = j0 + col;
        const bool okm = m < m_end;
        const bool oka = okm && kg < H, okb = okm && j < three_h;
        const float* pa = m < N ? h0 + (size_t)m * H + kg
                                : hs + (size_t)(m - N) * H + kg;
        cp_async4(a_s + row * kDrBM + col, oka ? pa : h0, oka);
        cp_async4(b_s + row * kDrBN + col,
                  okb ? drz + (size_t)m * three_h + j : drz, okb);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  float bias_acc = 0.0f;

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
    if (sums_bias) {
#pragma unroll
      for (int mm = 0; mm < kDrBK; ++mm) bias_acc += b_s[mm * kDrBN + tid];
    }
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
        if (j < three_h) dr[(size_t)kg * three_h + j] = acc[i][c];
      }
    }
    if (sums_bias && j0 + tid < three_h) drb[j0 + tid] = bias_acc;
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
  if (sums_bias) bias_s[tid] = bias_acc;
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
    float* out = dr + (size_t)kg * three_h + j0 + col;
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + col + c < three_h) out[c] = vals[c];
  }
  if (sums_bias && split == 0) {
    float b = 0.0f;
    for (int q = 0; q < splits; ++q)
      b += ld_cluster(cluster_addr(bias_s + tid, q));
    if (j0 + tid < three_h) drb[j0 + tid] = b;
  }
  // no block leaves while another rank still reads its shared memory
  cluster_barrier();
}

// The dR pass on stream st; 0 or a cudaError_t.
int launch_dr(const float* hs, const float* h0, const float* drz, float* dr,
              float* drb, int T, int N, int H, cudaStream_t st) {
  Device d;
  cudaError_t err = device_of(&d);
  if (err != cudaSuccess) return err;
  DrPlan pl;
  const int rc = make_dr_plan(T, N, H, d.sms, &pl);
  if (rc != 0) return rc;
  const bool vec = H % 4 == 0 && aligned16(hs) && aligned16(h0) &&
                   aligned16(drz);
  auto kernel = vec ? gru_bwd_dr_kernel<true> : gru_bwd_dr_kernel<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  Launch l(pl.blocks, kDrThreads, pl.smem, pl.splits, st, false);
  err = cudaLaunchKernelEx(&l.cfg, kernel, hs, h0, drz, dr, drb, T * N, N, H,
                           pl.splits, pl.chunk);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: H too large for the R slices in shared memory on this device;
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
  const Args a{dhs, dhT, ru, rzc, cand, hs, r, h0, dxw, drz, dh0, T, N, H};
  const int rc = sweep(a, st, false);
  if (rc != 0) return rc;
  return launch_dr(hs, h0, drz, dr, drb, T, N, H, st);
}

// Whether gru_seq_bwd_f32 would launch at batch N and width H on the
// current device: the sweep's checks, and nothing launched. 0 if it
// would, else the code it would return. The wrappers choose the route
// with it, before any launch.
extern "C" int gru_seq_bwd_fits(int N, int H) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, nullptr, 1, N, H};
  return sweep(a, nullptr, true);
}

// The dR, drb pass alone, from a drz that gru_seq_bwd_f32 (or the step
// route's sweep) wrote: the step route's dR, and lets a measurement time
// the two passes apart. Same codes.
extern "C" int gru_seq_bwd_dr_f32(const float* hs, const float* h0,
                                  const float* drz, float* dr, float* drb,
                                  int T, int N, int H, void* stream) {
  if (T < 1 || N < 1 || H < 1) return -3;
  return launch_dr(hs, h0, drz, dr, drb, T, N, H, (cudaStream_t)stream);
}

// The sweep's launch plan at batch N and width H, nothing launched: with
// sms > 0, make_plan for a card of `sms` SMs (kernels/gru.py
// gru_seq_bwd_plan mirrors it); with sms <= 0, the plan the current device
// launches, a smaller cluster included. out[9]: units, cluster,
// rows_per_warp, tiles, threads, smem_bytes, blocks, j_per_rank, groups.
// 0, or the codes above.
extern "C" int gru_seq_bwd_plan(int N, int H, int sms, int* out) {
  Plan p;
  const int rc = sms > 0 ? make_plan(N, H, sms, kMaxCluster, &p)
                         : device_plan(N, H, &p);
  if (rc != 0) return rc;
  const int v[kPlanFields] = {p.units,   p.cluster, p.rw,
                              p.tiles,   p.threads, p.smem,
                              p.blocks,  p.jr,      p.groups};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
  return 0;
}

// The dR pass's plan for T steps at batch N and width H on a card of
// `sms` SMs (sms <= 0: the current device's), nothing launched
// (kernels/gru.py gru_bwd_dr_plan mirrors it). out[5]: tiles, splits,
// chunk, blocks, smem_bytes. 0, -3, or a cudaError_t.
extern "C" int gru_seq_bwd_dr_plan(int T, int N, int H, int sms, int* out) {
  if (sms <= 0) {
    Device d;
    const cudaError_t err = device_of(&d);
    if (err != cudaSuccess) return err;
    sms = d.sms;
  }
  DrPlan p;
  const int rc = make_dr_plan(T, N, H, sms, &p);
  if (rc != 0) return rc;
  const int v[kDrPlanFields] = {p.tiles, p.splits, p.chunk, p.blocks, p.smem};
  for (int i = 0; i < kDrPlanFields; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* gru_seq_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
