// bf16 matrix product with f32 sums on Hopper's tensor cores, sm_90a.
//
// Replaces the Pallas kernel of tools/probe_matmul.py (bench_pallas,
// pallas_call at :62, body `kern` :56):
//
//   a [M, K] bf16, b [K, N] bf16  ->  out [M, N] = bf16(a b), f32 sums.
//
// The TPU kernel walks a grid over blocks of bm rows of a, with b resident
// in VMEM; bm is a blocking knob that does not change the result.
//
// What bounds it on this card: 2MKN operations against the bytes of a, b
// and out. At the probe's largest shape (50176, 1024, 256): 26.3 GFLOP,
// 0.027 ms at 989 TFLOP/s, against 129 MB, 0.039 ms at 3.35 TB/s, so
// bytes: the job is to stream a at the memory's rate. The first kernel
// (mma.sync from ldmatrix fragments, a two-deep cp.async ring, one block of
// 8 warps per SM) ran at 13.6% of the bf16 peak there.
//
// Design (wgmma fed by TMA, warp-specialised, persistent):
// - A block owns output tiles of BM x BN: 128 x 128 (two consumer
//   warpgroups of 64 rows) where that makes at least a third as many
//   tiles as SMs, else 64 x 64 (one), chosen by shape on the host
//   (probe_matmul_plan). At (50176, 1024, 256) that is 784 tiles; tile t
//   and t + 1 share their rows of a and run at once on neighbouring
//   blocks, so a comes from memory once and again from L2. At M = 784 the
//   64 x 64 tile makes 52 tiles where 128 x 128 would make 14.
// - The grid is min(tiles, SMs); block i takes tiles i, i + grid, ...
// - One producer warp (of a last warpgroup) keeps TMA loads in flight
//   through a ring of 6 stages of a [BM, 64] tile of a and a [64, BN]
//   tile of b, 128-byte swizzled, each stage under a full and an empty
//   mbarrier. It runs ahead across tile boundaries, so one tile's
//   epilogue overlaps the next tile's loads.
// - Each consumer warpgroup runs wgmma m64nBNk16 (bf16 in, f32
//   accumulators in registers) on 64 rows: a K-major, b MN-major (b [K, N]
//   is N-contiguous; wgmma's transpose-B immediate reads it as it lies, so
//   nothing transposes b in a pass of its own). It keeps one group of
//   products in flight and frees a stage when the products reading it are
//   done.
// - The epilogue rounds the f32 sums to bf16 once into a 128-byte-swizzled
//   out tile in shared memory and writes it with TMA stores, which clip
//   rows from M and columns from N on; the warpgroup goes on to its next
//   tile while they drain. TMA loads past M, K or N arrive as zeros.
// What the H100 showed at the report shape, back to back
// (scripts/flash_matmul_ab.py and A/B copies of this file): 128 x 256
// tiles with the stores written straight from the registers, 4 bytes a
// thread, 0.066 ms, of which they held the consumers for 0.025; staged
// through shared memory with TMA, 0.051 (cuBLAS 0.050); 128 x 128 tiles
// as here, 0.049, and no slower at the 8 other probe shapes (64 x 64
// tiles are 2.4x slower there: a is read again for every 64 columns).
// Three consumer warpgroups (192 x 256) do not compile: ptxas sizes
// registers by the 512-thread launch bound (128), whatever setmaxnreg
// later grants, and m64n256 needs 128 accumulators.
//
// K and N are multiples of 16 (TMA's 16-byte stride rule), which the
// wrapper checks; a and b start 16-byte aligned (kernels/probe_matmul.py
// `aligned`). M is any size.

#include "hopper_bf16.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kBK = 64;                 // k per stage: one swizzled row of a
constexpr int kSmemBudget = 224 * 1024;  // shared bytes: ring and out tile
constexpr int kMaxStages = 6;
constexpr int kConfigs = 2;
// (consumer warpgroups, BN) by preference; BM = 64 * warpgroups
constexpr int kWarpgroups[kConfigs] = {2, 1};
constexpr int kTileN[kConfigs] = {128, 64};

struct Plan {
  int config, bm, bn, stages, threads, smem, tiles_m, tiles_n, grid;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tile for this shape: the first configuration that makes at least a
// third as many tiles as the card has SMs and is no wider than N needs;
// else the smallest.
int plan_for(int M, int K, int N, int sms, Plan* p) {
  if (M < 1 || K < 1 || N < 1 || sms < 1) return -3;
  if (K % 16 || N % 16) return -1;
  int c = 0;
  for (; c < kConfigs - 1; ++c) {
    const int tiles = ceil_div(M, 64 * kWarpgroups[c]) *
                      ceil_div(N, kTileN[c]);
    if (3 * tiles >= sms && kTileN[c] <= ceil_div(N, 64) * 64) break;
  }
  p->config = c;
  p->bm = 64 * kWarpgroups[c];
  p->bn = kTileN[c];
  const int stage = (p->bm + p->bn) * kBK * 2;
  const int out_tile = p->bm * p->bn * 2;
  const int ring = (kSmemBudget - out_tile) / stage;
  p->stages = ring < kMaxStages ? ring : kMaxStages;
  p->threads = 128 * (kWarpgroups[c] + 1);
  // the ring, the staged out tile, 1 KB to align them to 1024 bytes, and
  // a full and an empty barrier a stage
  p->smem = p->stages * stage + out_tile + 1024 + 2 * p->stages * 8;
  p->tiles_m = ceil_div(M, p->bm);
  p->tiles_n = ceil_div(N, p->bn);
  const int tiles = p->tiles_m * p->tiles_n;
  p->grid = tiles < sms ? tiles : sms;
  return 0;
}

template <int WG, int BN>
__global__ void __launch_bounds__(128 * (WG + 1), 1)
matmul_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc, int M, int K,
              int stages, int tiles_n, int tiles) {
  constexpr int BM = 64 * WG;
  constexpr int kABytes = BM * kBK * 2;
  constexpr int kStageBytes = kABytes + kBK * BN * 2;
  constexpr int kOutBytes = 64 * BN * 2;   // a warpgroup's out tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* out_s = ring + stages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + WG * kOutBytes);
  uint64_t* empty = full + stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int k_tiles = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  if (wg == WG) {
    // the producer: one thread issues every load
    if (threadIdx.x % 128 == 0) {
      int s = 0, phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          uint8_t* st = ring + s * kStageBytes;
          tma_load_2d(st, &ta, &full[s], kt * kBK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(st + kABytes + j * 64 * kBK * 2, &tb, &full[s],
                        n0 + 64 * j, kt * kBK);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of the tile
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    float acc[BN / 2];
    int s = 0, phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM, n0 = (t % tiles_n) * BN;
      int prev = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[s], phase);
        const uint32_t a = smem_u32(ring + s * kStageBytes) + wg * 64 * 128;
        const uint32_t b = smem_u32(ring + s * kStageBytes + kABytes);
        fence_regs<BN / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64k16<BN, 1>(acc, wgmma_desc(a + 32 * kk, 16, 1024),
                              wgmma_desc(b + 2048 * kk, 64 * kBK * 2, 1024),
                              kt > 0 || kk > 0);
        wgmma_commit();
        // the products of the previous stage are done: free it
        wgmma_wait<1>();
        fence_regs<BN / 2>(acc);
        if (kt > 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (tid == 0) mbar_arrive(&empty[prev]);

      // the epilogue: bf16 sums into the warpgroup's out tile in shared
      // memory, laid out as the out map's 64 x 64 boxes (128-byte
      // swizzled), then one TMA store a box; the next tile's products
      // start while the stores drain
      uint8_t* os = out_s + wg * kOutBytes;
      if (tid == 0) bulk_wait_read<0>();   // the last tile's stores read os
      named_sync(1 + wg, 128);
      const int r = (tid / 32) * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = r + 8 * h;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              os + (j / 8) * 8192 + rr * 128 + (((j % 8) ^ (rr & 7)) << 4) +
              (lane % 4) * 4) = v;
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (tid == 0 && m0 + 64 * wg < M) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_store_2d(&tc, os + j * 8192, n0 + 64 * j, m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait<0>();
  }
}

template <int WG, int BN>
int launch(const bf16* a, const bf16* b, bf16* out, int M, int K, int N,
           const Plan& p, cudaStream_t st) {
  CUtensorMap ta, tb, tc;
  int rc = encode_bf16_2d(&ta, a, M, K, 64 * WG, kBK);
  if (rc == 0) rc = encode_bf16_2d(&tb, b, K, N, kBK, 64);
  if (rc == 0) rc = encode_bf16_2d(&tc, out, M, N, 64, 64);
  if (rc != 0) return rc;
  auto kernel = matmul_kernel<WG, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.threads, p.smem, st>>>(ta, tb, tc, M, K, p.stages,
                                            p.tiles_n,
                                            p.tiles_m * p.tiles_n);
  return cudaGetLastError();
}

int device_sms(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

}  // namespace

// Return codes: 0 on success, a cudaError_t (> 0) from the runtime, or
// -1: K or N not a multiple of 16; -3: an empty dimension; -4: the driver
// has no cuTensorMapEncodeTiled; -5: it refused a tensor map.
extern "C" int probe_matmul_bf16(const bf16* a, const bf16* b, bf16* out,
                                 int M, int K, int N, void* stream) {
  int sms = 0;
  int rc = device_sms(&sms);
  if (rc != 0) return rc;
  Plan p;
  rc = plan_for(M, K, N, sms, &p);
  if (rc != 0) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  return p.config == 0 ? launch<2, 128>(a, b, out, M, K, N, p, st)
                        : launch<1, 64>(a, b, out, M, K, N, p, st);
}

// The launch plan for this shape on the current device, nothing launched:
// out = {BM, BN, stages, threads, shared bytes, tiles along M, tiles along
// N, grid}. Return codes as probe_matmul_bf16's.
extern "C" int probe_matmul_plan(int M, int K, int N, int* out) {
  int sms = 0;
  int rc = device_sms(&sms);
  if (rc != 0) return rc;
  Plan p;
  rc = plan_for(M, K, N, sms, &p);
  if (rc != 0) return rc;
  const int vals[8] = {p.bm, p.bn, p.stages, p.threads, p.smem, p.tiles_m,
                       p.tiles_n, p.grid};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

extern "C" const char* probe_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
