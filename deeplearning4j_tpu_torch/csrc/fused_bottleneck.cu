// One ResNet bottleneck in one kernel, on Hopper's bf16 tensor cores
// (sm_90a), in the six variants of the repo's Pallas probes.
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
// Design. The TPU kernels keep a whole group resident in VMEM (at stage s2
// with g = 4, y1 alone is 417 KB); an H100 block has 227 KB of shared
// memory. Here a block owns a band of R flat rows of one group and
// recomputes y1 for its h+1 halo rows on each side (clipped to the group:
// beyond it y1 is zero, as in the padded scratch). y1 (band + halo) and
// y2 (band) stay in shared memory in bf16; the weights stream through a
// two-deep cp.async ring in chunks of 32 rows; every product runs on
// mma.sync m16n8k16 (csrc/mma_bf16.cuh), 8 warps of 32 x 64 tiles. A tap's
// rows are one ldmatrix at a shifted row of y1, and a mask zeroes the A
// fragment's registers of a masked row. R is the largest band whose
// buffers fit (at most 512 rows), then evened out over the group's bands
// (fused_bottleneck_plan).
//
// What bounds it on this card. 2 n h^2 (CF + 9F^2 + FC) operations; x and
// out are read and written once. At s2 (h, C, F = 14, 1024, 256; n = 256)
// 111.8 GFLOP: 0.113 ms at 989 TFLOP/s, against 205.5 MB, 0.061 ms at
// 3.35 TB/s, so operations; at s0 (56, 256, 64) the same operations face
// 822 MB, 0.245 ms, so bytes. The halo's recompute makes the first
// product ypad / R times its share (ypad: R + 2h + 2 rounded up to 16):
// at s0 with g = 4, R = 465 and ypad = 608, 1.31x of conv1, ~7% more
// operations than the block needs. mma.sync, one block per SM and a
// two-deep ring are a first, simple design; wgmma and TMA are later work.

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

enum Variant { kBlock4d, kBlock2d, kMatmuls, kPad, kMask, kFolded,
               kVariants };

template <int V>
struct Traits {
  static constexpr bool affine = V == kBlock4d || V == kBlock2d;
  static constexpr bool exact = affine || V == kMask;
  static constexpr bool folded = V == kFolded;
  static constexpr bool shift = V != kMatmuls;
};

struct Args {
  const bf16 *x, *w1, *w2, *w3;
  const float *s1, *b1, *s2, *b2, *s3, *b3;
  bf16* out;
  int h, C, F;
  int G;       // rows of a group: g h h
  int R;       // band rows
  int bands;   // bands of a group
  int halo;    // h + 1, or 0 without shifts
  int rpad;    // rows of y2 in shared memory: R up to 16
  int ypad;    // rows of y1: rpad + 2 halo up to 16
};

constexpr int kMaxBand = 512;

__device__ inline float relu(float v) { return v > 0.0f ? v : 0.0f; }

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// epi1 and epi2 on one f32 sum of column c.
template <int V>
__device__ inline float mid_epilogue(float v, const float* s,
                                     const float* b, int c) {
  if constexpr (Traits<V>::affine)
    return relu(__fadd_rn(__fmul_rn(v, s[c]), b[c]));
  else if constexpr (Traits<V>::folded)
    return relu(round_bf16(__fadd_rn(round_bf16(v), round_bf16(b[c]))));
  else
    return v;
}

// epi3 on one f32 sum of column c, with x's value there.
template <int V>
__device__ inline float out_epilogue(float v, float xv, const Args& p,
                                     int c) {
  if constexpr (Traits<V>::affine)
    return relu(__fadd_rn(__fadd_rn(__fmul_rn(v, p.s3[c]), p.b3[c]), xv));
  else if constexpr (Traits<V>::folded)
    return relu(round_bf16(__fadd_rn(
        round_bf16(__fadd_rn(round_bf16(v), round_bf16(p.b3[c]))), xv)));
  else
    return v;
}

// The rows of x behind a tile of y1 rows: tile row r is y1 row first + r
// of the group (group-local), real where it lies inside the group.
struct GroupRows {
  long long gbase;   // global row of the group's first row
  int first, G, count;
  __device__ long long operator()(int r) const {
    const int gr = first + r;
    return r < count && gr >= 0 && gr < G ? gbase + gr : -1;
  }
};

// y1 in shared memory, read at the tap's shifted rows with its masks.
template <int V>
struct ShiftedA {
  const bf16* y1;
  int ld, F, h, halo, m0;
  int yy[2][2], xx[2][2];   // image row and column of this thread's rows
  bool valid[2];

  __device__ void load(const Tile&, int, int) const {}

  __device__ void frag(uint32_t f[2][4], const Tile&, const WarpPos& w,
                       int, int, int k) const {
    const int tap = k / F, kc = k % F;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int off = Traits<V>::shift ? dy * h + dx : 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!valid[mt]) continue;
      load_a(f[mt], y1, ld, m0 + w.row + 16 * mt + halo + off, kc, w.lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        bool ok = true;
        if constexpr (Traits<V>::exact)
          ok = (unsigned)(yy[mt][half] + dy) < (unsigned)h &&
               (unsigned)(xx[mt][half] + dx) < (unsigned)h;
        if constexpr (Traits<V>::folded)
          ok = dx < 0 ? xx[mt][half] > 0
                      : dx > 0 ? xx[mt][half] < h - 1 : true;
        if (!ok) f[mt][half] = f[mt][half + 2] = 0u;   // row l/4 (+8)
      }
    }
  }
};

// y2 in shared memory, read as it lies.
struct PlainA {
  const bf16* y2;
  int ld, m0;
  bool valid[2];

  __device__ void load(const Tile&, int, int) const {}

  __device__ void frag(uint32_t f[2][4], const Tile&, const WarpPos& w,
                       int, int, int k) const {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (valid[mt]) load_a(f[mt], y2, ld, m0 + w.row + 16 * mt, k, w.lane);
  }
};

__device__ inline void store_pair(bf16* dst, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
fused_bottleneck_kernel(const Args p) {
  extern __shared__ float4 smem4[];
  const int group = blockIdx.x / p.bands;
  const int r0 = (blockIdx.x % p.bands) * p.R;   // band's first row
  const int reff = min(p.R, p.G - r0);           // its rows
  const long long gbase = (long long)group * p.G;
  const int ld = p.F + 8;
  const Tile tf(p.F), tc(p.C);

  bf16* y1 = reinterpret_cast<bf16*>(smem4);
  bf16* y2 = y1 + p.ypad * ld;
  bf16* b_ring = y2 + p.rpad * ld;
  bf16* a_ring = b_ring + b_ring_bytes(max(tf.nb, tc.nb)) / sizeof(bf16);
  float acc[2][8][4];

  // 1. y1 for the band and its halo: rows r0 - halo + j, j < ypad
  {
    const WarpPos w(tf);
    for (int m0 = 0; m0 < p.ypad; m0 += tf.mb) {
      const int first = r0 - p.halo + m0;
      StagedA<GroupRows> a{p.x, p.C, p.C, a_ring,
                           GroupRows{gbase, first, p.G, p.ypad - m0},
                           {false, false}};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int lo = w.row + 16 * mt;
        a.valid[mt] = lo < p.ypad - m0 && first + lo < p.G &&
                      first + lo + 16 > 0;
      }
      for (int n0 = 0; n0 < p.F; n0 += tf.nb) {
        block_gemm(acc, a, p.w1, p.F, p.C, n0, p.F, tf, w, b_ring);
        for_each_pair(acc, w, [&](int r, int c, float v0, float v1) {
          const int j = m0 + r, gr = first + r;
          if (j >= p.ypad || n0 + c >= p.F) return;
          const bool in = gr >= 0 && gr < p.G;
          store_pair(y1 + j * ld + n0 + c,
                     in ? mid_epilogue<V>(v0, p.s1, p.b1, n0 + c) : 0.0f,
                     in ? mid_epilogue<V>(v1, p.s1, p.b1, n0 + c + 1)
                        : 0.0f);
        });
      }
    }
  }
  __syncthreads();

  // 2. y2 = the 9 taps over y1, for the band's rows
  {
    const WarpPos w(tf);
    for (int m0 = 0; m0 < reff; m0 += tf.mb) {
      ShiftedA<V> a{y1, ld, p.F, p.h, p.halo, m0, {}, {}, {false, false}};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a.valid[mt] = m0 + w.row + 16 * mt < reff;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int pos =
              (r0 + m0 + w.row + 16 * mt + w.lane / 4 + 8 * half) %
              (p.h * p.h);
          a.yy[mt][half] = pos / p.h;
          a.xx[mt][half] = pos % p.h;
        }
      }
      for (int n0 = 0; n0 < p.F; n0 += tf.nb) {
        block_gemm(acc, a, p.w2, p.F, 9 * p.F, n0, p.F, tf, w, b_ring);
        for_each_pair(acc, w, [&](int r, int c, float v0, float v1) {
          const int i = m0 + r;
          if (i >= p.rpad || n0 + c >= p.F) return;
          store_pair(y2 + i * ld + n0 + c,
                     mid_epilogue<V>(v0, p.s2, p.b2, n0 + c),
                     mid_epilogue<V>(v1, p.s2, p.b2, n0 + c + 1));
        });
      }
    }
  }
  __syncthreads();

  // 3. out = epi3(y2 w3, x) for the band's rows
  {
    const WarpPos w(tc);
    for (int m0 = 0; m0 < reff; m0 += tc.mb) {
      PlainA a{y2, ld, m0, {false, false}};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        a.valid[mt] = m0 + w.row + 16 * mt < reff;
      for (int n0 = 0; n0 < p.C; n0 += tc.nb) {
        block_gemm(acc, a, p.w3, p.C, p.F, n0, p.C, tc, w, b_ring);
        for_each_pair(acc, w, [&](int r, int c, float v0, float v1) {
          const int i = m0 + r;
          if (i >= reff || n0 + c >= p.C) return;
          const size_t at = (size_t)(gbase + r0 + i) * p.C + n0 + c;
          float x0 = 0.0f, x1 = 0.0f;
          if constexpr (Traits<V>::affine || Traits<V>::folded) {
            const __nv_bfloat162 xv =
                *reinterpret_cast<const __nv_bfloat162*>(p.x + at);
            x0 = __low2float(xv);
            x1 = __high2float(xv);
          }
          store_pair(p.out + at, out_epilogue<V>(v0, x0, p, n0 + c),
                     out_epilogue<V>(v1, x1, p, n0 + c + 1));
        });
      }
    }
  }
}

// Shared memory (bytes) of a band of R rows.
int smem_bytes(int R, int halo, int C, int F, int* rpad, int* ypad) {
  const Tile tf(F), tc(C);
  *rpad = round_up(R, 16);
  *ypad = round_up(*rpad + 2 * halo, 16);
  return (*rpad + *ypad) * (F + 8) * (int)sizeof(bf16) +
         b_ring_bytes(tf.nb > tc.nb ? tf.nb : tc.nb) + a_ring_bytes(tf.mb);
}

// The launch's plan, or a negative code (see the entries).
int plan(int variant, int n, int h, int C, int F, int g, Args* a,
         int* smem) {
  if (variant < 0 || variant >= kVariants) return -5;
  if (n < 1 || h < 1 || C < 1 || F < 1 || g < 1) return -3;
  if (C % 16 || F % 16) return -1;
  if (n % g) return -2;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  a->h = h;
  a->C = C;
  a->F = F;
  a->G = g * h * h;
  a->halo = variant == kMatmuls ? 0 : h + 1;
  int rmax = a->G < kMaxBand ? a->G : kMaxBand;
  while (rmax > 0 &&
         smem_bytes(rmax, a->halo, C, F, &a->rpad, &a->ypad) > limit)
    --rmax;
  if (rmax == 0) return -4;
  a->bands = (a->G + rmax - 1) / rmax;
  a->R = (a->G + a->bands - 1) / a->bands;
  *smem = smem_bytes(a->R, a->halo, C, F, &a->rpad, &a->ypad);
  return 0;
}

template <int V>
int launch(const Args& a, int blocks, int smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_bottleneck_kernel<V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_bottleneck_kernel<V><<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Return codes of both entries: 0 on success, a cudaError_t (> 0) from the
// runtime, or -1: C or F not a multiple of 16; -2: n not a multiple of g;
// -3: an empty dimension; -4: F too wide for one band's buffers; -5: no
// such variant. The variants: 0 kBlock4d, 1 kBlock2d, 2 kMatmuls, 3 kPad,
// 4 kMask, 5 kFolded.

// The launch's plan, launching nothing: out[0..5] = band rows R, bands
// per group, halo rows, y2 rows, y1 rows, shared memory bytes.
extern "C" int fused_bottleneck_plan(int variant, int n, int h, int C,
                                     int F, int g, int* out) {
  Args a{};
  int smem = 0;
  const int rc = plan(variant, n, h, C, F, g, &a, &smem);
  if (rc != 0) return rc;
  const int vals[6] = {a.R, a.bands, a.halo, a.rpad, a.ypad, smem};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

// x [n h h, C], w1 [C, F], w2 [9, F, F], w3 [F, C], out [n h h, C] bf16;
// s*, b* f32 of F or C values (null where the variant reads none: s* and
// b* for kMatmuls, kPad, kMask; s* for kFolded).
extern "C" int fused_bottleneck_run(
    int variant, const bf16* x, const bf16* w1, const float* s1,
    const float* b1, const bf16* w2, const float* s2, const float* b2,
    const bf16* w3, const float* s3, const float* b3, bf16* out, int n,
    int h, int C, int F, int g, void* stream) {
  Args a{};
  int smem = 0;
  const int rc = plan(variant, n, h, C, F, g, &a, &smem);
  if (rc != 0) return rc;
  a.x = x;
  a.w1 = w1;
  a.w2 = w2;
  a.w3 = w3;
  a.s1 = s1;
  a.b1 = b1;
  a.s2 = s2;
  a.b2 = b2;
  a.s3 = s3;
  a.b3 = b3;
  a.out = out;
  const int blocks = (n / g) * a.bands;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case kBlock4d: return launch<kBlock4d>(a, blocks, smem, st);
    case kBlock2d: return launch<kBlock2d>(a, blocks, smem, st);
    case kMatmuls: return launch<kMatmuls>(a, blocks, smem, st);
    case kPad: return launch<kPad>(a, blocks, smem, st);
    case kMask: return launch<kMask>(a, blocks, smem, st);
    default: return launch<kFolded>(a, blocks, smem, st);
  }
}

extern "C" const char* fused_bottleneck_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
