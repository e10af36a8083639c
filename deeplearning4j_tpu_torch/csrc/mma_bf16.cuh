// bf16 tensor-core building blocks for Hopper (sm_90a): mma.sync
// m16n8k16 with f32 accumulators, ldmatrix fragment loads and cp.async
// staging (the bf16 flash kernels stage with the last, through
// csrc/flash_tc.cuh), and the block-level product of
// csrc/fused_bottleneck.cu.
//
// The block product. 256 threads (8 warps) compute an mb x nb tile of
// A[M, K] B[K, N] (bf16 in, f32 sums in registers). Each warp owns 32 rows
// x 64 columns: two m16 tiles by eight n8 tiles, 64 accumulators a thread.
// The warps stand wm x wn (wn = 4, 2 or 1 by N, wm = 8 / wn), so a narrow
// N (a bottleneck's F = 64) still keeps all eight warps busy on rows.
// B streams through shared memory in chunks of 32 rows, two buffers deep
// (cp.async); the A operand comes from a source object: a staged copy of a
// global matrix (in the same two buffers' rhythm) or a matrix already in
// shared memory, whose rows a source may shift and mask.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): a thread of lane l
// holds A rows l/4 and l/4 + 8 (registers 0, 2 and 1, 3), columns
// 2(l%4), +1 and +8; B (k x n) columns l/4, rows 2(l%4), +1 (register 0)
// and +8 (register 1); C rows l/4 and l/4 + 8, columns 2(l%4), +1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kKChunk = 32;          // rows of B per pipeline stage
constexpr int kAStride = kKChunk + 8;  // a staged A row, bf16 (80 bytes)

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Warp layout of the block tile for an output of N columns.
struct Tile {
  int wn, wm, nb, mb;
  __host__ __device__ explicit Tile(int n) {
    wn = n > 128 ? 4 : n > 64 ? 2 : 1;
    wm = 8 / wn;
    nb = 64 * wn;
    mb = 32 * wm;
  }
};

// Shared memory (bytes) of the B ring for tiles up to nb columns.
__host__ __device__ inline int b_ring_bytes(int nb) {
  return 2 * kKChunk * (nb + 8) * (int)sizeof(bf16);
}

// Shared memory (bytes) of a staged A ring of mb rows.
__host__ __device__ inline int a_ring_bytes(int mb) {
  return 2 * mb * kAStride * (int)sizeof(bf16);
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !pred (src unread).
__device__ inline void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lane l gives the address of row l%8 of matrix l/8.
__device__ inline void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ inline void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ inline void mma16816(float c[4], const uint32_t a[4],
                                const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of the m16 tile whose first row is `row0` of a row-major
// bf16 matrix in shared memory (stride `ld` elements, a multiple of 8),
// columns k0..k0+15.
__device__ inline void load_a(uint32_t a[4], const bf16* base, int ld,
                              int row0, int k0, int lane) {
  ldsm_x4(a, base + (size_t)(row0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}

// Where this thread's warp sits in the block tile.
struct WarpPos {
  int warp, lane, row, col;   // first row and column of the warp's tile
  __device__ WarpPos(const Tile& t) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    row = (warp / t.wn) * 32;
    col = (warp % t.wn) * 64;
  }
};

// A staged from a global row-major matrix A[., lda]: the rows of the
// block tile come from `row_of(i)` (a global row, or -1 for a zero row),
// streamed in the B ring's rhythm. `valid[mt]` says whether an m16 tile
// of this warp has any real row (a warp skips the products of one that
// has none).
template <class RowOf>
struct StagedA {
  const bf16* a;
  int lda, K;
  bf16* ring;   // two buffers of mb x kAStride
  RowOf row_of;
  bool valid[2];

  __device__ void load(const Tile& t, int chunk, int buf) const {
    const int k0 = chunk * kKChunk;
    bf16* dst = ring + buf * t.mb * kAStride;
    for (int s = threadIdx.x; s < t.mb * (kKChunk / 8); s += kThreads) {
      const int r = s / (kKChunk / 8), c = (s % (kKChunk / 8)) * 8;
      const long long g = row_of(r);
      const bool ok = g >= 0 && k0 + c < K;
      cp_async16(dst + r * kAStride + c,
                 ok ? a + (size_t)g * lda + k0 + c : a, ok);
    }
  }

  __device__ void frag(uint32_t f[2][4], const Tile& t, const WarpPos& w,
                       int buf, int kk, int /*k*/) const {
    const bf16* src = ring + buf * t.mb * kAStride;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (valid[mt]) load_a(f[mt], src, kAStride, w.row + 16 * mt, kk * 16,
                            w.lane);
  }
};

// The block product: acc = A[tile rows, 0:K] B[0:K, n0:n0+nb], columns from
// N on left at zero. Every thread of the block calls it (it synchronises).
template <class ASrc>
__device__ void block_gemm(float acc[2][8][4], const ASrc& asrc,
                           const bf16* __restrict__ b, int ldb, int K,
                           int n0, int N, const Tile& t, const WarpPos& w,
                           bf16* b_ring) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int bs = t.nb + 8;   // B ring row stride, elements
  const int segs = t.nb / 8;
  auto load = [&](int chunk, int buf) {
    const int k0 = chunk * kKChunk;
    bf16* dst = b_ring + buf * kKChunk * bs;
    for (int s = threadIdx.x; s < kKChunk * segs; s += kThreads) {
      const int r = s / segs, c = (s % segs) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(dst + r * bs + c,
                 ok ? b + (size_t)(k0 + r) * ldb + n0 + c : b, ok);
    }
    asrc.load(t, chunk, buf);
    cp_async_commit();
  };

  const int chunks = (K + kKChunk - 1) / kKChunk;
  load(0, 0);
  for (int chunk = 0; chunk < chunks; ++chunk) {
    if (chunk + 1 < chunks) {
      load(chunk + 1, (chunk + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = chunk & 1;
    const bf16* bsrc = b_ring + buf * kKChunk * bs;
#pragma unroll
    for (int kk = 0; kk < kKChunk / 16; ++kk) {
      const int k = chunk * kKChunk + kk * 16;
      if (k >= K) break;
      uint32_t af[2][4];
      asrc.frag(af, t, w, buf, kk, k);
#pragma unroll
      for (int np = 0; np < 4; ++np) {   // n8 tiles in pairs
        const int col = w.col + np * 16;
        if (n0 + col >= N) continue;   // N is a multiple of 16
        uint32_t bfr[4];
        ldsm_x4_t(bfr, bsrc + (size_t)(kk * 16 + (w.lane % 8) +
                                       ((w.lane / 8) % 2) * 8) * bs +
                           col + (w.lane / 16) * 8);
        const uint32_t b0[2] = {bfr[0], bfr[1]};
        const uint32_t b1[2] = {bfr[2], bfr[3]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (!asrc.valid[mt]) continue;
          mma16816(acc[mt][2 * np], af[mt], b0);
          mma16816(acc[mt][2 * np + 1], af[mt], b1);
        }
      }
    }
    __syncthreads();
  }
}

// Calls fn(row, col, v0, v1) for each pair of neighbouring columns of the
// warp's accumulators (row and col relative to the block tile's origin).
template <class Fn>
__device__ inline void for_each_pair(float acc[2][8][4], const WarpPos& w,
                                     Fn fn) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        fn(w.row + 16 * mt + w.lane / 4 + 8 * half,
           w.col + 8 * nt + 2 * (w.lane % 4), acc[mt][nt][2 * half],
           acc[mt][nt][2 * half + 1]);
}

}  // namespace mma_bf16
