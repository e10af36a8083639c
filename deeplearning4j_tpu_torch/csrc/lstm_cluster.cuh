// What csrc/lstm_seq_infer.cu (the forward, rows 1-2) and
// csrc/lstm_seq_bwd.cu (the backward's sweep, row 3) share: the launch
// plan of a recurrence whose row groups are thread-block clusters that
// hold R (mirrored by kernels/lstm.py _plan), and the cluster machinery
// their steps use (distributed shared memory, mbarriers, cp.async).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kSmemOptin = 232448;  // bytes a block may opt into (H100)
constexpr int kMaxRows = 64;        // rows a cluster may take
constexpr int kMinThreads = 128;    // a block's floor where one row allows
constexpr int kClusterOrder[5] = {8, 16, 4, 2, 1};   // by preference
constexpr int kPlanFields = 13;
constexpr int kMaxDevices = 64;

// Cells (row, unit) a thread finalises, and splits of the reduction:
// the forward's cells hold c and 4 inputs in registers, the sweep's the
// dc carry and 7; the forward sums over KH units (split at most 8 ways),
// the sweep over 4 KH columns of dz (at most 32).
constexpr int max_cells(bool bwd) { return bwd ? 2 : 4; }
constexpr int max_splits(bool bwd) { return bwd ? 32 : 8; }

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int round4(int a) { return (a + 3) & ~3; }

// caps[] holds the clusters of 1, 2, 4, 8, 16 blocks the card holds
int cap_index(int c) {
  return c == 1 ? 0 : c == 2 ? 1 : c == 4 ? 2 : c == 8 ? 3 : 4;
}

// The launch plan. cluster: blocks a row group (C); units: hidden units a
// block (U, a multiple of 4); k_pad: C U, the units the cluster covers;
// rows: batch rows a cluster (the last may hold fewer); tiles: clusters
// launched; rows_per_thread (TM) and row_threads: row slots of TM rows;
// splits and k_per_split (kr): the reduction (KH forward, 4 KH sweep)
// split into ranges (a multiple of 4); threads: the block; smem: dynamic
// shared memory bytes; blocks: the grid; resident: clusters of this size
// the card holds at once.
struct Plan {
  int cluster, units, k_pad, rows, tiles, tm, rth, splits, kr, threads,
      smem, blocks, resident;
};

// The block's layout for `rc` rows with clusters of c blocks of u units:
// TM from rc, then the most splits of the reduction (up to max_splits, at
// least 16 each unless more are needed for threads enough to finalise the
// cells, at most 512 threads, 256 where TM = 8) whose shared memory fits.
// Forward: R's slice [KS KR][4U], h [2][RCP][KS KR + 4], the splits'
// partial sums [KS][RCP][4U], the block's h_t [RCP][U]; sweep: R's slice
// [KS KR][U], dz [2][RCP][KS KR + 4], partial sums [KS][RCP][U], the
// block's dz_t [RCP][4][U]; two mbarriers. False where none fits, or a
// thread would finalise more than max_cells cells.
template <bool kBwd>
bool layout(int c, int u, int rc, Plan* p) {
  const int kh = c * u, ncol = kBwd ? u : 4 * u, kd = kBwd ? 4 * kh : kh;
  const int cq = ncol / 4, cells = max_cells(kBwd);
  const int tm = rc >= 8 ? 8 : rc >= 3 ? 4 : rc;
  const int rth = cdiv(rc, tm), rcp = rth * tm;
  const int cap = tm == 8 ? 256 : 512;
  if (cq * rth > cap) return false;
  int ks = cap / (cq * rth);
  if (ks > max_splits(kBwd)) ks = max_splits(kBwd);
  const int by_len = cdiv(kd, 16), by_cells = cdiv(rc * u, cells * cq * rth);
  if (ks > by_len && ks > by_cells) ks = by_len > by_cells ? by_len : by_cells;
  for (;; --ks) {
    const int kr = round4(cdiv(kd, ks));
    const int s = cdiv(kd, kr);   // no idle split
    const long kp = (long)s * kr;
    const long floats = kp * ncol + 2L * rcp * (kp + 4) +
                        (long)s * rcp * ncol + (long)rcp * (kBwd ? 4 * u : u) +
                        4;
    const int threads = cq * rth * s;
    if (4 * floats <= kSmemOptin && (long)rc * u <= (long)cells * threads) {
      p->cluster = c;
      p->units = u;
      p->k_pad = kh;
      p->rows = rc;
      p->tm = tm;
      p->rth = rth;
      p->splits = s;
      p->kr = kr;
      p->threads = threads;
      p->smem = (int)(4 * floats);
      return true;
    }
    if (ks == 1) return false;
  }
}

// The batches the sweep takes at width H on a card of `sms` SMs: every
// batch to H = 300; past it, only those the sweep before the cluster
// redesign took, whose row tiles (8 rows to H = 360, 4 to 400, 2 to 423,
// beside R's [32, 4H] slice in one SM's shared memory) of ceil(H/32)
// blocks each fit one wave of one block an SM. Past them the sweep's
// clusters hold 2 to 4 rows and run in waves, and the step route
// (csrc/rnn_step.cu) takes the backward in less time
// (scripts/lstm_seq_ab.py's route timings; the forward, whose clusters
// hold more rows, stays faster than the step route at every batch).
constexpr bool sweep_takes(int N, int H, int sms) {
  if (H <= 300) return true;
  const int rows = H <= 360 ? 8 : H <= 400 ? 4 : H <= 423 ? 2 : 0;
  return N <= rows * (sms / cdiv(H, 32));
}

// A layout for `rc` rows with at least `floor` threads.
template <bool kBwd>
bool layout_of(int c, int u, int rc, int floor, Plan* p) {
  return layout<kBwd>(c, u, rc, p) && p->threads >= floor;
}

// The plan at batch N, width H, given the clusters of each size the card
// holds (caps; caps[0], the clusters of one block, is its SM count). The
// cluster size: the first of 8, 16, 4, 2, 1 whose slice of R fits in
// shared memory with no rank past H, else the first that fits. Its most
// rows a cluster (rmax) whose layout keeps kMinThreads threads a block
// (or as many as one row's layout has: more rows leave less shared
// memory for the splits, and a block of 2 or 3 warps takes longer over
// its rows than more clusters in waves take over theirs); then rows =
// ceil(N / (waves x resident)) for the fewest waves with rows <= rmax
// (more where that many have no such layout). 0; -1 where no slice fits
// in shared memory, or (sweep) the step route takes the batch
// (sweep_takes); -2 where a slice fits but the card holds no cluster of
// its size; -3 for an empty dimension.
template <bool kBwd>
int make_plan(int N, int H, const int* caps, Plan* p) {
  if (N < 1 || H < 1) return -3;
  if (kBwd && !sweep_takes(N, H, caps[0])) return -1;
  int rc = -1;
  for (int pass = 0; pass < 2; ++pass)
    for (int c : kClusterOrder) {
      const int u = round4(cdiv(H, c));
      const bool idle = (long)(c - 1) * u >= H;   // a rank past H
      if (idle != (pass == 1)) continue;
      if (!layout<kBwd>(c, u, 1, p)) continue;
      const int floor = p->threads < kMinThreads ? p->threads : kMinThreads;
      int rmax = 0;
      for (int r = kMaxRows; r >= 1 && !rmax; --r)
        if (layout_of<kBwd>(c, u, r, floor, p)) rmax = r;
      const int cap = caps[cap_index(c)];
      if (cap < 1) {
        rc = -2;
        continue;
      }
      const int waves = cdiv(N, rmax * cap);
      int rows = cdiv(N, waves * cap);
      while (!layout_of<kBwd>(c, u, rows, floor, p)) ++rows;
      p->tiles = cdiv(N, rows);
      p->blocks = p->tiles * c;
      p->resident = cap;
      return 0;
    }
  return rc;
}

// The plan's fields in the order of kernels/lstm.py PLAN_FIELDS.
void plan_out(const Plan& p, int* out) {
  const int v[kPlanFields] = {p.cluster, p.units,   p.k_pad, p.rows,
                              p.tiles,   p.tm,      p.rth,   p.splits,
                              p.kr,      p.threads, p.smem,  p.blocks,
                              p.resident};
  for (int i = 0; i < kPlanFields; ++i) out[i] = v[i];
}

// A launch configuration in clusters of `cluster` blocks.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  Launch(int blocks, int threads, int smem, int cluster, cudaStream_t st)
      : cfg{} {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The kernel's attributes for a launch of `smem` bytes in clusters of c.
template <typename K>
cudaError_t prepare(K k, int smem, int c) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && c > 8)
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The clusters of 1, 2, 4, 8 and 16 blocks of kernel k (512 threads) the
// current device holds at once at one block an SM
// (cudaOccupancyMaxActiveClusters, asked once per device; a size the card
// refuses counts 0). 0 or a cudaError_t.
template <typename K>
int device_caps(K k, int* caps) {
  static int cached[kMaxDevices][5];
  static bool have[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && have[dev]) {
    for (int i = 0; i < 5; ++i) caps[i] = cached[dev][i];
    return 0;
  }
  int smem_optin = 0;
  cudaDeviceGetAttribute(&smem_optin,
                         cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int i = 0; i < 5; ++i) {
    const int c = 1 << i;
    caps[i] = 0;
    if (prepare(k, smem_optin, c) != cudaSuccess) {
      cudaGetLastError();
      continue;
    }
    Launch l(c, 512, smem_optin, c, nullptr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, k, &l.cfg) == cudaSuccess)
      caps[i] = n;
    else
      cudaGetLastError();
  }
  if (dev < kMaxDevices) {
    for (int i = 0; i < 5; ++i) cached[dev][i] = caps[i];
    have[dev] = true;
  }
  return 0;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// every thread of the cluster: this one's shared-memory writes are seen by
// the others after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

// 16 bytes into a cluster rank's shared memory; their arrival completes
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
