// One ResNet bottleneck in one kernel, on Hopper's bf16 tensor cores
// (sm_90a: wgmma fed by TMA), in the six variants of the repo's Pallas
// probes.
//
// Replaces (variant: Pallas body, launch site):
//   kBlock4d  tools/probe_fused_block.py _fused_kernel :62   (call :95)
//   kBlock2d  tools/probe_fused_block.py _fused_kernel2d :123 (call :161)
//   kMatmuls  tools/probe_fused_parts.py k_matmuls :38       (call :128)
//   kPad      tools/probe_fused_parts.py k_pad :47           (call :128)
//   kMask     tools/probe_fused_parts.py k_mask :62          (call :128)
//   kFolded   tools/probe_fused_parts.py k_folded :82        (call :181)
//
// All work on flat NHWC rows, r = (img*h + y)*h + x, of x [n*h*h, C] bf16,
// with w1 [C, F], w2 [9, F, F], w3 [F, C] bf16, and compute
//
//   y1 = epi1(x w1);  y2 = epi2(sum over taps t of shift_t(y1) w2[t]);
//   out = epi3(y2 w3, x)
//
// with f32 sums of bf16 products, where the variant fixes:
// - the shift of tap t = 3 ky + kx: row r reads y1 row r + (ky-1) h +
//   (kx-1) (kMatmuls: no shift, every tap reads row r). The Pallas kernels
//   stage y1 of a group of g images in a scratch padded with h+1 zero rows
//   at each end, so a read outside the group's g h h rows is zero and a
//   read inside it is real data, even across an image's border;
// - the masks: the exact variants (kBlock4d, kBlock2d, kMask) zero a tap
//   whose (y+ky-1, x+kx-1) leaves the image (a SAME 3x3 conv, so g does
//   not change their result); kFolded zeroes the kx = 0 taps of rows with
//   x = 0 and the kx = 2 taps of rows with x = h-1, and nothing in y, so
//   at g > 1 the top and bottom rows of an image read the neighbouring
//   image's rows (as k_folded does); kPad and kMatmuls mask nothing;
// - the epilogues: kBlock* apply f32 affines (a multiply, then an add, no
//   contraction) and ReLU, and add x in f32 before the last ReLU; kFolded
//   rounds to bf16 where k_folded does (bf16 bias add, bf16 ReLU, (y3 +
//   b3) + x as two bf16 roundings); the others only round to bf16.
//
// What bounds it on this card. 2 n h^2 (CF + 9F^2 + FC) operations; x and
// out are read and written once. At s2 (h, C, F = 14, 1024, 256; n = 256)
// 111.8 GFLOP: 0.113 ms at 989 TFLOP/s, against 205.5 MB, 0.061 ms at
// 3.35 TB/s, so operations; at s0 (56, 256, 64) the same operations face
// 822 MB, 0.245 ms, so bytes.
//
// Design (the mma.sync kernel this one replaced ran from a two-deep
// cp.async ring with two block-wide barriers every 32 of K, one block of
// 8 warps an SM, and a weight tile fed 64 rows; 3-5% of the bf16 peak):
// - A block is 2 warpgroups (256 threads, up to 255 registers a thread:
//   with a third, producer warp ptxas sized the block as three warpgroups,
//   168 registers, and spilled). It walks work items (a band of R rows of
//   one group; band-major, so that short last bands come last) in a
//   persistent grid: block b takes items b, b + grid, ...
// - Thread 0 (of warp 0) also produces: it keeps TMA loads in flight
//   through a ring of 4 stages (3 where a fourth would cut the band below
//   128 rows, 2 where 3 leave no room for a band: the plan's) under a full
//   and an empty mbarrier each: the weight tiles ([64 k, 64 n] boxes,
//   128-byte swizzled, read as they lie through wgmma's transpose-B
//   immediate) and conv1's A, 128 rows of x a stage. When warp 0 frees a
//   stage, thread 0 loads the stage a ring's depth ahead into its slot,
//   and first waits until each of the 8 warps has freed it. So warp 0,
//   and through the .aligned wgmma its warpgroup, waits once a stage for
//   the other warpgroup to finish the stage before: the price of a
//   producer inside a consumer warp (a producer warp of its own, with
//   setmaxnreg moving registers to the consumers, is not tried yet).
// - Both warpgroups read every stage: warpgroup w computes rows
//   64w..64w+63 of a 128-row tile, so each weight tile feeds 128 rows. A
//   warpgroup whose 64 rows lie past the work skips its products and only
//   frees the stage.
// - conv1 (SS wgmma, A = x by TMA) writes y1 for the band and its h+1 halo
//   rows on each side into shared memory (row stride F + 8, so ldmatrix at
//   any row is free of bank conflicts), 0 outside the group as the padded
//   scratch holds; a row of x outside the group is a real row or TMA's
//   zero fill, and its y1 is written 0 all the same.
// - conv2's A is y1 at rows shifted by the tap, any number of rows, which
//   a swizzled descriptor cannot start at: it is ldmatrix at the shifted
//   row into registers, the tap's mask applied to the fragment, and the
//   register-A wgmma; the fragments of two stages alternate, so a stage's
//   loads overlap the previous stage's products. A row past the band reads
//   the band's last row (its result is never stored), so y1 holds just the
//   band and its halo.
// - y2 never lies in shared memory: conv2's accumulators (a warpgroup's
//   64 rows by F, in passes of N2 columns) go through epi2 and are packed
//   to bf16 as register-A fragments of conv3, which runs on them at once
//   (N3 columns of C at a time); epi3 adds x, read 16 values at a time
//   through the read-only path. The band is bounded by y1 alone. The
//   affines are copied into shared memory at the start where they fit
//   (else the epilogues read them from global memory).
// - Templated on the width class FM of F (64, 128, 256, 512, and 1024 for
//   any F past 512) for the register arrays; the variant is a launch
//   argument (masks and epilogues only). Past 512, y2 is made 256 columns
//   of F at a time, and conv3 sums the chunks for each 64 columns of C, so
//   conv2 is computed again for each 64 columns of C: slow, but F past 512
//   lies outside the probes' stages.
// What an H100 showed (PERF.md): 1.5-1.9x the mma.sync kernel, faster
// than the cuBLAS + cuDNN block at s0-s2, slower at s3; in the F >= 128
// kernels (255 registers, spilling) ptxas waits for each product before
// the next, and conv3's epilogue takes about half of s2's time.
// Numerics as the mma.sync kernel's: f32 sums of bf16 products, the epilogues'
// order of roundings, no atomics (a result repeats bit for bit).

#include "hopper_bf16.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

enum Variant { kBlock4d, kBlock2d, kMatmuls, kPad, kMask, kFolded,
               kVariants };

constexpr int kBK = 64;            // k of a ring stage: one swizzled row
constexpr int kMaxStages = 4;      // the ring: 4 stages, or 3 or 2 (plan)
constexpr int kConsumers = 2;      // warpgroups, 64 rows each
constexpr int kTile = 64 * kConsumers;
constexpr int kThreads = 128 * kConsumers;
constexpr int kABytes = kTile * kBK * 2;   // conv1's A: 128 rows of x
constexpr int kBox = 64 * kBK * 2;         // one [64 k, 64 n] weight box
constexpr int kMaxBand = 1024;
constexpr int kSync = 1;           // named barrier of the 256 threads

// Diagnostics for scripts/bottleneck_ab.py, off unless defined at build
// time (their results are wrong; only their times are read):
// FB_DIAG_NO_MMA skips the products, FB_DIAG_NO_LOADS the TMA loads (a
// stage is marked full with nothing in it), FB_DIAG_PHASES = a mask of
// the products kept (1 conv1, 2 conv2, 4 conv3), loads and all.
#ifdef FB_DIAG_NO_MMA
constexpr bool kMma = false;
#else
constexpr bool kMma = true;
#endif
#ifdef FB_DIAG_NO_LOADS
constexpr bool kLoads = false;
#else
constexpr bool kLoads = true;
#endif
#ifdef FB_DIAG_PHASES
constexpr int kPhases = FB_DIAG_PHASES;
#else
constexpr int kPhases = 7;
#endif

// The widths of a class FM of F: conv1's, conv2's and conv3's N, and the
// columns of y2 held in registers at once (all of F up to 512).
__host__ __device__ constexpr int n1_of(int fm) { return fm < 128 ? fm : 128; }
__host__ __device__ constexpr int n2_of(int fm) {
  return fm >= 512 ? 64 : fm < 128 ? fm : 128;
}
__host__ __device__ constexpr int n3_of(int fm) { return fm >= 512 ? 64 : 128; }
__host__ __device__ constexpr int chunk_of(int fm) {
  return fm > 512 ? 256 : fm;
}

template <int FM>
struct Widths {
  static constexpr int n1 = n1_of(FM), n2 = n2_of(FM), n3 = n3_of(FM);
  static constexpr int chunk = chunk_of(FM);
  static constexpr bool wide = FM > chunk;   // y2 in chunks
};

__host__ __device__ constexpr int max_i(int a, int b) { return a > b ? a : b; }

// Bytes of a ring stage: conv1's [x tile | w1 boxes] or one product's
// w2 or w3 boxes.
__host__ __device__ constexpr int stage_bytes(int fm) {
  return max_i(kABytes + n1_of(fm) * kBK * 2,
               max_i(n2_of(fm), n3_of(fm)) * kBK * 2);
}

struct Args {
  const bf16* x;
  const float *s1, *b1, *s2, *b2, *s3, *b3;
  bf16* out;
  int variant, h, C, F;
  int G;       // rows of a group: g h h
  int R;       // band rows
  int bands;   // bands of a group
  int halo;    // h + 1, or 0 without shifts
  int ypad;    // rows of y1 in shared memory: R + 2 halo
  int items;   // groups x bands
  int stages;  // ring stages
  int aff;     // 1: the affines copied into shared memory
};

struct Plan {
  int fm, stages, R, bands, halo, ypad, smem, items, grid, aff;
};

__device__ __forceinline__ float relu(float v) { return v > 0.0f ? v : 0.0f; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Two floats as bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// The affines a variant reads: s1, b1, s2, b2 (F each), s3, b3 (C each)
// for kBlock*; b1, b2, b3 for kFolded. Copied into shared memory at the
// start where the plan leaves room (from global memory, each read was a
// trip to L2: with ~228 KB of shared memory a block keeps ~28 KB of L1,
// which the streamed x evicts), else read where they lie.
struct Affines {
  const float* a;   // the copy in shared memory, or null
  const Args& p;
  bool scales;      // kBlock*: s and b; kFolded: b only
  __device__ const float* s(int k) const {   // s1, s2, s3 for k = 0, 1, 2
    if (!a) return k == 0 ? p.s1 : k == 1 ? p.s2 : p.s3;
    return a + 2 * p.F * k;
  }
  __device__ const float* b(int k) const {   // b1, b2, b3
    if (!a) return k == 0 ? p.b1 : k == 1 ? p.b2 : p.b3;
    return scales ? a + 2 * p.F * k + (k < 2 ? p.F : p.C) : a + p.F * k;
  }
};

__host__ __device__ inline int affine_floats(int variant, int C, int F) {
  return variant == kBlock4d || variant == kBlock2d ? 4 * F + 2 * C
         : variant == kFolded                       ? 2 * F + C
                                                    : 0;
}

// epi1 and epi2 on one f32 sum of column c.
__device__ __forceinline__ float mid_epilogue(int v, float a, const float* s,
                                              const float* b, int c) {
  if (v == kBlock4d || v == kBlock2d)
    return relu(__fadd_rn(__fmul_rn(a, s[c]), b[c]));
  if (v == kFolded)
    return relu(round_bf16(__fadd_rn(round_bf16(a), round_bf16(b[c]))));
  return a;
}

// epi3 on one f32 sum of column c, with x's value there.
__device__ __forceinline__ float out_epilogue(int v, const float* s3,
                                              const float* b3, float a,
                                              float xv, int c) {
  if (v == kBlock4d || v == kBlock2d)
    return relu(__fadd_rn(__fadd_rn(__fmul_rn(a, s3[c]), b3[c]), xv));
  if (v == kFolded)
    return relu(round_bf16(__fadd_rn(
        round_bf16(__fadd_rn(round_bf16(a), round_bf16(b3[c]))), xv)));
  return a;
}

// The taps a row at image position (yy, xx) keeps, one bit a tap.
__device__ __forceinline__ uint32_t tap_mask(int v, int h, int yy, int xx) {
  uint32_t m = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    bool ok = true;
    if (v == kBlock4d || v == kBlock2d || v == kMask)
      ok = (unsigned)(yy + dy) < (unsigned)h &&
           (unsigned)(xx + dx) < (unsigned)h;
    else if (v == kFolded)
      ok = dx < 0 ? xx > 0 : dx > 0 ? xx < h - 1 : true;
    m |= (ok ? 1u : 0u) << t;
  }
  return m;
}

// A ring position: stage and the parity of its current phase.
struct Ring {
  int s = 0;
  uint32_t phase = 0;
  int n = kMaxStages;   // stages
  __device__ void next() {
    if (++s == n) {
      s = 0;
      phase ^= 1;
    }
  }
};

// One work item: a band of one group.
struct Item {
  int r0, reff;      // the band's first group row and its rows
  int first;         // global row of y1 row 0: group row r0 - halo
  int y1rows;        // y1 rows it needs: reff + 2 halo
  long long gbase;   // global row of the group's first row
  // Items are band-major (band b of every group, then band b + 1), so
  // that a group's short last band comes last in the persistent walk
  // rather than in every block's share.
  __device__ void set(const Args& p, int item) {
    const int groups = p.items / p.bands;
    const int band = item / groups, group = item % groups;
    r0 = band * p.R;
    reff = min(p.R, p.G - r0);
    gbase = (long long)group * p.G;
    first = (int)(gbase + r0 - p.halo);
    y1rows = reff + 2 * p.halo;
  }
};

__device__ __forceinline__ uint64_t desc_b(const uint8_t* st, int kk) {
  // MN-major B of 64-wide boxes: 8 k-rows a core group, 8 KB a box
  return wgmma_desc(smem_u32(st) + 2048 * kk, kBox, 1024);
}

// Inlines a lambda where it is called: one that holds a register array by
// reference and is left a function of its own puts the array in local
// memory.
#define FB_INLINE __attribute__((always_inline))

// Calls f(Int<I>{}) for I = 0 .. N-1. Indices into register arrays must be
// compile-time constants; #pragma unroll of a large body does not promise
// that, and the arrays it leaves indexed at run time go to local memory.
template <int I>
struct Int {
  static constexpr int value = I;
};

template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(Int<I>{});
    static_for<I + 1, N>(f);
  }
}

// The four descriptors of a stage's products, and their accumulate flags,
// computed before the warpgroup fence: a descriptor computed between two
// products made ptxas fence again and wait for the product before (every
// HGMMA of a stage was followed by a wait for it).
template <bool kA>
struct StageDescs {
  uint64_t a[kA ? 4 : 1], b[4];
  int acc[4];
  __device__ __forceinline__ void pin() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      asm volatile("" : "+l"(b[kk]), "+r"(acc[kk])::"memory");
      if constexpr (kA) asm volatile("" : "+l"(a[kk])::"memory");
    }
  }
};

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (*a)[4]) {
#pragma unroll
  for (int t = 0; t < N; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[t][i])::"memory");
}

// The producer: thread 0 issues every load, in the consumers' order, one
// ring stage ahead of each stage its warpgroup frees (after p.stages loads
// at the start). The cursor walks the consumers' loops: per item, conv1's
// (128-row chunks of y1, n1 columns of F, 64 of C a stage), then per
// 128-row tile and per group of conv3's columns (all of C, or n3 columns
// past F = 512), per chunk of y2's columns (all of F up to 512, else 256):
// conv2's (n2 columns of the chunk, 9 taps, 64 of F a stage) and conv3's
// (n3 columns of the group, 64 of the chunk a stage).
// The cursor lives in shared memory (after the barriers), so that no
// thread but the producer spends registers on it.
struct Cursor {
  Item it;
  int item, phase, m, n0, tap, kc;   // phase 0, 1, 2: conv1, conv2, conv3
  int cg, c0, fc;   // conv3's column group and column, y2's chunk
  Ring r;
};
constexpr int kCursorBytes = 128;
static_assert(sizeof(Cursor) <= kCursorBytes, "the cursor's room");

template <int FM>
struct Producer {
  using W = Widths<FM>;
  static constexpr int kStage = stage_bytes(FM);
  const Args& p;
  Cursor& c;

  // The first enabled phase of an item (past the last item: nothing).
  __device__ void start_item() {
    c.n0 = c.tap = c.kc = c.m = 0;
    if (c.item >= p.items) return;
    c.it.set(p, c.item);
    c.phase = 0;
    if (!(kPhases & 1)) start_tile();
  }

  // The tile at m's first column group, or the next item.
  __device__ void start_tile() {
    c.cg = 0;
    if (c.m < c.it.reff && (kPhases & 6)) {
      start_group();
      return;
    }
    c.item += gridDim.x;
    start_item();
  }

  // The column group at cg's first chunk of y2.
  __device__ void start_group() {
    c.fc = 0;
    start_chunk();
  }

  // The chunk at fc: conv2's first stage (or conv3's).
  __device__ void start_chunk() {
    c.n0 = c.fc;
    c.c0 = c.cg;
    c.tap = c.kc = 0;
    c.phase = (kPhases & 2) ? 1 : 2;
  }

  // After a chunk's conv3: the next chunk, column group, tile or item.
  __device__ void end_chunk() {
    if ((c.fc += W::chunk) < p.F) {
      start_chunk();
      return;
    }
    if (W::wide && (c.cg += W::n3) < p.C) {
      start_group();
      return;
    }
    c.m += kTile;
    start_tile();
  }

  __device__ void advance() {
    const int kcf = (p.F + kBK - 1) / kBK;
    if (c.phase == 0) {
      if (++c.kc < (p.C + kBK - 1) / kBK) return;
      c.kc = 0;
      if ((c.n0 += W::n1) < p.F) return;
      c.n0 = 0;
      if ((c.m += kTile) < c.it.y1rows) return;
      c.m = 0;
      start_tile();
      return;
    }
    if (c.phase == 1) {
      if (++c.kc < kcf) return;
      c.kc = 0;
      if (++c.tap < 9) return;
      c.tap = 0;
      if ((c.n0 += W::n2) < min(c.fc + W::chunk, p.F)) return;
      if (kPhases & 4) {
        c.phase = 2;
        return;
      }
      end_chunk();
      return;
    }
    if (++c.kc < (min(W::chunk, p.F - c.fc) + kBK - 1) / kBK) return;
    c.kc = 0;
    if ((c.c0 += W::n3) < (W::wide ? c.cg + W::n3 : p.C)) return;
    end_chunk();
  }

  // Loads the cursor's stage into the next ring slot once every warp has
  // freed it, then moves on; nothing past the last item.
  __device__ void load(uint8_t* ring, uint64_t* full, uint64_t* empty,
                       const CUtensorMap* tx, const CUtensorMap* t1,
                       const CUtensorMap* t2, const CUtensorMap* t3) {
    if (c.item >= p.items) return;
    const int s = c.r.s;
    const int bytes = c.phase == 0 ? kABytes + W::n1 * kBK * 2
                      : c.phase == 1 ? W::n2 * kBK * 2 : W::n3 * kBK * 2;
    mbar_wait(&empty[s], c.r.phase ^ 1);
    c.r.next();
    if (!kLoads) {
      mbar_arrive(&full[s]);
      advance();
      return;
    }
    mbar_expect_tx(&full[s], bytes);
    uint8_t* st = ring + s * kStage;
    if (c.phase == 0) {
      tma_load_2d(st, tx, &full[s], c.kc * kBK, c.it.first + c.m);
#pragma unroll
      for (int j = 0; j < W::n1 / 64; ++j)
        tma_load_2d(st + kABytes + j * kBox, t1, &full[s], c.n0 + 64 * j,
                    c.kc * kBK);
    } else if (c.phase == 1) {
#pragma unroll
      for (int j = 0; j < W::n2 / 64; ++j)
        tma_load_2d(st + j * kBox, t2, &full[s], c.n0 + 64 * j,
                    c.tap * p.F + c.kc * kBK);
    } else {
#pragma unroll
      for (int j = 0; j < W::n3 / 64; ++j)
        tma_load_2d(st + j * kBox, t3, &full[s], c.c0 + 64 * j,
                    c.fc + c.kc * kBK);
    }
    advance();
  }
};

template <int FM>
__global__ void __launch_bounds__(kThreads, 1)
fused_bottleneck_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap t1,
                        const __grid_constant__ CUtensorMap t2,
                        const __grid_constant__ CUtensorMap t3,
                        const __grid_constant__ Args p) {
  using W = Widths<FM>;
  constexpr int kStage = stage_bytes(FM);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* y1 = reinterpret_cast<bf16*>(ring + p.stages * kStage);
  const int ld = p.F + 8;
  uint64_t* full = reinterpret_cast<uint64_t*>(y1 + (size_t)p.ypad * ld);
  uint64_t* empty = full + p.stages;
  Cursor& cursor = *reinterpret_cast<Cursor*>(empty + p.stages);
  float* aff = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(&cursor) +
                                        kCursorBytes);
  const bool scales = p.variant == kBlock4d || p.variant == kBlock2d;
  const Affines am{p.aff ? aff : nullptr, p, scales};
  if (p.aff && affine_floats(p.variant, p.C, p.F) > 0) {
    const float* src[6] = {p.s1, p.b1, p.s2, p.b2, p.s3, p.b3};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int n = k < 2 ? p.F : p.C;
      float* s = aff + 2 * p.F * k;
      float* b = scales ? s + n : aff + p.F * k;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        if (scales) s[i] = src[2 * k][i];
        b[i] = src[2 * k + 1][i];
      }
    }
  }

  const bool producer = threadIdx.x == 0;
  auto load = [&]() {
    Producer<FM>{p, cursor}.load(ring, full, empty, &tx, &t1, &t2, &t3);
  };
  if (producer) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_fence_init();
    cursor.r = Ring{0, 0, p.stages};
    cursor.item = blockIdx.x;
    Producer<FM>{p, cursor}.start_item();
  }
  __syncthreads();
  if (producer)
    for (int s = 0; s < p.stages; ++s) load();
  __syncwarp();

  const int wg = threadIdx.x / 128;

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int kc1 = (p.C + kBK - 1) / kBK, kcf = (p.F + kBK - 1) / kBK;
  const int v = p.variant;
  const bool shift = v != kMatmuls;
  const bool residual = v == kBlock4d || v == kBlock2d || v == kFolded;
  Ring r{0, 0, p.stages};
  int prev = -1;
  // frees the stage of the previous step once its products are done: one
  // arrival from each warp, after the whole warp has seen the stage full
  // (were one thread a warpgroup to free it, a warpgroup without products
  // could have its slot refilled, and the full barrier's parity flip back,
  // while its other warps still poll it). The producer then loads the
  // stage that takes the slot; its lane 0 may wait there for the other
  // warps, so the warp meets again before the next .aligned instruction
  // (wgmma, ldmatrix, bar.sync), which needs it whole.
  auto free_prev = [&]() {
    if (prev >= 0 && lane == 0) {
      mbar_arrive(&empty[prev]);
      if (producer) load();
    }
    __syncwarp();
  };
  auto release = [&]() {
    free_prev();
    prev = r.s;
    r.next();
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    free_prev();
    prev = -1;
  };
  // this thread's accumulator rows in its warpgroup's 64
  const int row_a = 16 * warp + lane / 4;
  // y2 (a chunk of its columns) as conv3's register-A fragments
  uint32_t y2f[W::chunk / 16][4];

  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    Item it;
    it.set(p, item);

    // 1. y1 for the band and its halo: rows r0 - halo + j, j < y1rows
    for (int m = 0; (kPhases & 1) && m < it.y1rows; m += kTile) {
      const int sub = m + 64 * wg;   // this warpgroup's first y1 row
      const int g0 = it.r0 - p.halo + sub;   // its first group row
      const bool rows = sub < it.y1rows;
      const bool active = rows && g0 < p.G && g0 + 64 > 0;
      for (int n0 = 0; n0 < p.F; n0 += W::n1) {
        float acc[W::n1 / 2];
        for (int kc = 0; kc < kc1; ++kc) {
          mbar_wait(&full[r.s], r.phase);
          __syncwarp();
          if (active && kMma) {
            const uint8_t* st = ring + r.s * kStage;
            const uint32_t a = smem_u32(st) + wg * (64 * 128);
            StageDescs<true> d;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              d.a[kk] = wgmma_desc(a + 32 * kk, 16, 1024);
              d.b[kk] = desc_b(st + kABytes, kk);
              d.acc[kk] = kc > 0 || kk > 0;
            }
            d.pin();
            fence_regs<W::n1 / 2>(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64k16<W::n1, 1>(acc, d.a[kk], d.b[kk], d.acc[kk]);
            wgmma_commit();
          }
          wgmma_wait<1>();
          fence_regs<W::n1 / 2>(acc);
          release();
        }
        drain();
        fence_regs<W::n1 / 2>(acc);
        // the previous item's conv2 reads of y1 are done in both
        // warpgroups before the first write of this item's y1
        if (m == 0 && n0 == 0) {
          __syncwarp();
          named_sync(kSync, 128 * kConsumers);
        }
        if (!rows) continue;
        // per row a base address, per column block an immediate offset;
        // a column test only in a chunk that crosses F
        const int c0 = n0 + 2 * (lane % 4);
        const bool full_f = n0 + W::n1 <= p.F;
        const float* s1 = am.s(0) + c0;
        const float* b1 = am.b(0) + c0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int yr = sub + row_a + 8 * hh;
          const int gr = it.r0 - p.halo + yr;
          if (yr >= p.ypad) continue;
          const bool in = active && gr >= 0 && gr < p.G;
          uint32_t* dst =
              reinterpret_cast<uint32_t*>(y1 + (size_t)yr * ld + c0);
#pragma unroll
          for (int j = 0; j < W::n1 / 8; ++j) {
            if (!full_f && c0 + 8 * j >= p.F) continue;
            const float* a = acc + 4 * j + 2 * hh;
            dst[4 * j] =
                in ? pack2(mid_epilogue(v, a[0], s1, b1, 8 * j),
                           mid_epilogue(v, a[1], s1, b1, 8 * j + 1))
                   : 0u;
          }
        }
      }
    }
    __syncwarp();
    named_sync(kSync, 128 * kConsumers);   // y1 is whole

    // 2-3. per 128-row tile: y2 = epi2(the 9 taps over y1) in registers,
    // then out = epi3(y2 w3, x)
    for (int m = 0; (kPhases & 6) && m < it.reff; m += kTile) {
      const int sub = m + 64 * wg;   // this warpgroup's first band row
      const bool active = sub < it.reff;
      uint32_t keep[2];   // taps kept by rows row_a and row_a + 8
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pos = (it.r0 + sub + row_a + 8 * hh) % (p.h * p.h);
        keep[hh] = tap_mask(v, p.h, pos / p.h, pos % p.h);
      }
      // ldmatrix rows of this lane: y1 row of band row sub + 16 warp +
      // lane % 16 (a row past the band: the band's last), before the
      // tap's shift
      const bf16* a_lane =
          y1 + (size_t)(min(sub + 16 * warp + lane % 16, it.reff - 1) +
                        p.halo) * ld + (lane / 16) * 8;
      const int steps = 9 * kcf;

      // y2's columns fc .. fc + chunk into y2f
      auto conv2 = [&](int fc) FB_INLINE {
        static_for<0, W::chunk / W::n2>([&](auto pass) FB_INLINE {
          constexpr int n0r = decltype(pass)::value * W::n2;
          const int n0 = fc + n0r;
          if (!(kPhases & 2)) return;
          if (n0 >= p.F) {   // columns past F: conv3 multiplies their zeros
#pragma unroll
            for (int j = 0; j < W::n2 / 16; ++j)
#pragma unroll
              for (int q = 0; q < 4; ++q) y2f[n0r / 16 + j][q] = 0u;
            return;
          }
          float acc[W::n2 / 2];
          uint32_t af[2][4][4];
          auto step = [&](int i, uint32_t (*f)[4]) FB_INLINE {
            mbar_wait(&full[r.s], r.phase);
            __syncwarp();
            if (active) {
              const int tap = i / kcf, kc = i % kcf;
              const int off = shift ? (tap / 3 - 1) * p.h + tap % 3 - 1 : 0;
              const bf16* src = a_lane + (ptrdiff_t)off * ld + kc * kBK;
              const bool ka = (keep[0] >> tap) & 1, kb = (keep[1] >> tap) & 1;
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                if (kc * kBK + 16 * kk < p.F) {
                  asm volatile(
                      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                      "{%0,%1,%2,%3}, [%4];\n"
                      : "=r"(f[kk][0]), "=r"(f[kk][1]), "=r"(f[kk][2]),
                        "=r"(f[kk][3])
                      : "r"(smem_u32(src + 16 * kk)));
                  if (!ka) f[kk][0] = f[kk][2] = 0u;
                  if (!kb) f[kk][1] = f[kk][3] = 0u;
                } else {   // past F (a ragged last chunk): A is zero
                  f[kk][0] = f[kk][1] = f[kk][2] = f[kk][3] = 0u;
                }
              }
              const uint8_t* st = ring + r.s * kStage;
              StageDescs<false> d;
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                d.b[kk] = desc_b(st, kk);
                d.acc[kk] = i > 0 || kk > 0;
              }
              d.pin();
              fence_regs<W::n2 / 2>(acc);
              wgmma_fence();
              // the stage's four products in one unbroken chain: a branch
              // between them made ptxas wait for each product to finish
              if constexpr (kMma) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  wgmma_m64k16_rs<W::n2, 1>(acc, f[kk], d.b[kk], d.acc[kk]);
              }
              wgmma_commit();
            }
            wgmma_wait<1>();
            fence_regs<W::n2 / 2>(acc);
            fence_u32<4>(af[0]);
            fence_u32<4>(af[1]);
            release();
          };
          for (int i = 0; i < steps; i += 2) {
            step(i, af[0]);
            if (i + 1 < steps) step(i + 1, af[1]);
          }
          drain();
          fence_regs<W::n2 / 2>(acc);
          fence_u32<4>(af[0]);
          fence_u32<4>(af[1]);
          // epi2, packed: n8 block j of this pass is k16 step
          // (n0r/8 + j)/2 of the chunk
          const int c0 = n0 + 2 * (lane % 4);
          const bool full_f = n0 + W::n2 <= p.F;
          const float* s2 = am.s(1) + c0;
          const float* b2 = am.b(1) + c0;
#pragma unroll
          for (int j = 0; j < W::n2 / 8; ++j) {
            const int cb = n0r / 8 + j;
            float e[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              e[q] = full_f || c0 + 8 * j + (q & 1) < p.F
                         ? mid_epilogue(v, acc[4 * j + q], s2, b2,
                                        8 * j + (q & 1))
                         : 0.0f;
            y2f[cb / 2][(cb % 2) * 2] = pack2(e[0], e[1]);
            y2f[cb / 2][(cb % 2) * 2 + 1] = pack2(e[2], e[3]);
          }
        });
      };

      // acc (+)= y2's chunk at fc times w3's rows there, columns n0
      auto conv3 = [&](float* acc, int fc) FB_INLINE {
        static_for<0, W::chunk / kBK>([&](auto kci) FB_INLINE {
          constexpr int kc = decltype(kci)::value;
          if (!(kPhases & 4) || fc + kc * kBK >= p.F) return;
          mbar_wait(&full[r.s], r.phase);
          __syncwarp();
          if (active) {
            const uint8_t* st = ring + r.s * kStage;
            StageDescs<false> d;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              d.b[kk] = desc_b(st, kk);
              d.acc[kk] = fc > 0 || kc > 0 || kk > 0;
            }
            d.pin();
            fence_regs<W::n3 / 2>(acc);
            wgmma_fence();
            if constexpr (kMma) {   // one unbroken chain, as in conv2
#pragma unroll
              for (int kk = 0; kk < 4; ++kk)
                wgmma_m64k16_rs<W::n3, 1>(acc, y2f[4 * kc + kk], d.b[kk],
                                          d.acc[kk]);
            }
            wgmma_commit();
          }
          wgmma_wait<1>();
          fence_regs<W::n3 / 2>(acc);
          fence_u32<W::chunk / 16>(y2f);
          release();
        });
        drain();
        fence_regs<W::n3 / 2>(acc);
        fence_u32<W::chunk / 16>(y2f);
      };

      // out's columns n0 .. n0 + n3 = epi3(acc, x)
      auto epi3 = [&](const float* acc, int n0) FB_INLINE {
        if (!active || !(kPhases & 4)) return;
        // per row a base address (a row past the band reads the band's
        // last row and stores nothing), per column block an immediate
        // offset, a column test only in a chunk that crosses C; x for 8
        // column blocks at a time, the reads in flight together
        const int c0 = n0 + 2 * (lane % 4);
        const bool full_c = n0 + W::n3 <= p.C;
        const float* s3 = am.s(2) + c0;
        const float* b3 = am.b(2) + c0;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = sub + row_a + 8 * hh;
          const bool row_ok = i < it.reff;
          const size_t at =
              (size_t)(it.gbase + it.r0 + min(i, it.reff - 1)) * p.C + c0;
          const uint32_t* xs = reinterpret_cast<const uint32_t*>(p.x + at);
          uint32_t* os = reinterpret_cast<uint32_t*>(p.out + at);
#pragma unroll
          for (int j0 = 0; j0 < W::n3 / 8; j0 += 8) {
            uint32_t xv[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              xv[j] = residual && (full_c || c0 + 8 * (j0 + j) < p.C)
                          ? __ldg(xs + 4 * (j0 + j))
                          : 0u;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int jj = j0 + j;
              const float* a = acc + 4 * jj + 2 * hh;
              const float x0 = __uint_as_float(xv[j] << 16);
              const float x1 = __uint_as_float(xv[j] & 0xffff0000u);
              const uint32_t o =
                  pack2(out_epilogue(v, s3, b3, a[0], x0, 8 * jj),
                        out_epilogue(v, s3, b3, a[1], x1, 8 * jj + 1));
              if (row_ok && (full_c || c0 + 8 * jj < p.C)) os[4 * jj] = o;
            }
          }
        }
      };

      if constexpr (!W::wide) {   // y2 whole in registers: conv2 once
        conv2(0);
        for (int n0 = 0; (kPhases & 4) && n0 < p.C; n0 += W::n3) {
          float acc[W::n3 / 2];
          conv3(acc, 0);
          epi3(acc, n0);
        }
      } else {   // y2 in chunks: conv2 again for each n3 columns of C
        for (int n0 = 0; n0 < p.C; n0 += W::n3) {
          float acc[W::n3 / 2];
          for (int fc = 0; fc < p.F; fc += W::chunk) {
            conv2(fc);
            conv3(acc, fc);
          }
          epi3(acc, n0);
        }
      }
    }
  }
}

int f_class(int F) {
  return F <= 64 ? 64 : F <= 128 ? 128 : F <= 256 ? 256 : F <= 512 ? 512
                                                                  : 1024;
}

// Shared memory (bytes) of ypad rows of y1, with the affines or not.
int smem_bytes(int variant, int stages, int fm, int ypad, int C, int F,
               bool aff) {
  return 1024 + stages * stage_bytes(fm) + ypad * (F + 8) * 2 +
         2 * stages * 8 + kCursorBytes +
         (aff ? 4 * affine_floats(variant, C, F) : 0);
}

// The launch's plan, or a negative code (see the entries). `limit` is the
// opt-in shared memory of a block, `sms` the card's SMs.
int plan(int variant, int n, int h, int C, int F, int g, int sms, int limit,
         Plan* p) {
  if (variant < 0 || variant >= kVariants) return -5;
  if (n < 1 || h < 1 || C < 1 || F < 1 || g < 1) return -3;
  if (C % 16 || F % 16) return -1;
  if (n % g) return -2;
  p->fm = f_class(F);
  const int G = g * h * h;
  p->halo = variant == kMatmuls ? 0 : h + 1;
  // the widest band that fits beside a ring of the given depth: whole
  // 64-row tiles, or below 64 rows any number (0: none)
  auto widest = [&](int stages, bool aff) {
    int rmax = 0;
    for (int r = 1; r <= kMaxBand; r += r < 64 ? 1 : 64)
      if (smem_bytes(variant, stages, p->fm, r + 2 * p->halo, C, F, aff) <=
          limit)
        rmax = r;
    return rmax;
  };
  // the affines in shared memory where a band fits beside them; four
  // stages while the band keeps 128 rows (or the whole group), three while
  // it keeps 64: the loads' lead is worth more than a wider band down to
  // there; else two
  int rmax = 0;
  for (int aff = 1; aff >= 0 && rmax == 0; --aff) {
    p->aff = aff;
    p->stages = widest(kMaxStages, aff) >= (G < 128 ? G : 128) ? kMaxStages
                : widest(3, aff) >= (G < 64 ? G : 64)              ? 3
                                                                   : 2;
    rmax = widest(p->stages, aff);
  }
  if (rmax == 0) return -4;
  p->R = G < rmax ? G : rmax;
  p->bands = (G + p->R - 1) / p->R;
  p->ypad = p->R + 2 * p->halo;
  p->smem = smem_bytes(variant, p->stages, p->fm, p->ypad, C, F, p->aff);
  p->items = (n / g) * p->bands;
  p->grid = p->items < sms ? p->items : sms;
  return 0;
}

int device_limits(int* sms, int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

template <int FM>
int launch(const Args& a, const bf16* w1, const bf16* w2, const bf16* w3,
           int rows, const Plan& pl, cudaStream_t st) {
  CUtensorMap tx, t1, t2, t3;
  int rc = encode_bf16_2d(&tx, a.x, rows, a.C, kTile, kBK);
  if (rc == 0) rc = encode_bf16_2d(&t1, w1, a.C, a.F, kBK, 64);
  if (rc == 0) rc = encode_bf16_2d(&t2, w2, 9 * a.F, a.F, kBK, 64);
  if (rc == 0) rc = encode_bf16_2d(&t3, w3, a.F, a.C, kBK, 64);
  if (rc != 0) return rc == kNoEncodeEntry ? -6 : rc == kEncodeRefused ? -7
                                                                       : rc;
  auto kernel = fused_bottleneck_kernel<FM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, kThreads, pl.smem, st>>>(tx, t1, t2, t3, a);
  return cudaGetLastError();
}

}  // namespace

// Return codes of both entries: 0 on success, a cudaError_t (> 0) from the
// runtime, or -1: C or F not a multiple of 16; -2: n not a multiple of g;
// -3: an empty dimension; -4: no band's y1 fits in shared memory; -5: no
// such variant; -6: no cuTensorMapEncodeTiled entry point;
// -7: it refused a tensor map. The variants: 0 kBlock4d, 1 kBlock2d,
// 2 kMatmuls, 3 kPad, 4 kMask, 5 kFolded.

// The launch's plan on the current device, launching nothing: out[0..10]
// = band rows R, bands per group, halo rows, y1 rows, shared memory bytes,
// ring stages, threads, F's width class, work items, grid, 1 where the
// affines are copied into shared memory.
extern "C" int fused_bottleneck_plan(int variant, int n, int h, int C,
                                     int F, int g, int* out) {
  int sms = 0, limit = 0;
  int rc = device_limits(&sms, &limit);
  if (rc != 0) return rc;
  Plan pl;
  rc = plan(variant, n, h, C, F, g, sms, limit, &pl);
  if (rc != 0) return rc;
  const int vals[11] = {pl.R,      pl.bands, pl.halo,  pl.ypad,
                        pl.smem,   pl.stages, kThreads, pl.fm,
                        pl.items,  pl.grid,  pl.aff};
  for (int i = 0; i < 11; ++i) out[i] = vals[i];
  return 0;
}

// x [n h h, C], w1 [C, F], w2 [9, F, F], w3 [F, C], out [n h h, C] bf16,
// each 16-byte aligned; s*, b* f32 of F or C values (null where the
// variant reads none: s* and b* for kMatmuls, kPad, kMask; s* for
// kFolded).
extern "C" int fused_bottleneck_run(
    int variant, const bf16* x, const bf16* w1, const float* s1,
    const float* b1, const bf16* w2, const float* s2, const float* b2,
    const bf16* w3, const float* s3, const float* b3, bf16* out, int n,
    int h, int C, int F, int g, void* stream) {
  int sms = 0, limit = 0;
  int rc = device_limits(&sms, &limit);
  if (rc != 0) return rc;
  Plan pl;
  rc = plan(variant, n, h, C, F, g, sms, limit, &pl);
  if (rc != 0) return rc;
  Args a{};
  a.x = x;
  a.s1 = s1;
  a.b1 = b1;
  a.s2 = s2;
  a.b2 = b2;
  a.s3 = s3;
  a.b3 = b3;
  a.out = out;
  a.variant = variant;
  a.h = h;
  a.C = C;
  a.F = F;
  a.G = g * h * h;
  a.R = pl.R;
  a.bands = pl.bands;
  a.halo = pl.halo;
  a.ypad = pl.ypad;
  a.items = pl.items;
  a.stages = pl.stages;
  a.aff = pl.aff;
  const int rows = n * h * h;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pl.fm) {
    case 64: return launch<64>(a, w1, w2, w3, rows, pl, st);
    case 128: return launch<128>(a, w1, w2, w3, rows, pl, st);
    case 256: return launch<256>(a, w1, w2, w3, rows, pl, st);
    case 512: return launch<512>(a, w1, w2, w3, rows, pl, st);
    default: return launch<1024>(a, w1, w2, w3, rows, pl, st);
  }
}

extern "C" const char* fused_bottleneck_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
