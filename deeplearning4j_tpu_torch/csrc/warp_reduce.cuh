// Warp-level reduce-scatter shared by the GRU kernels.
#pragma once

// Adds each of C values (a power of two, at most 64) over the warp's 32
// lanes, in a fixed order. While values remain to split, each butterfly
// level sends half of them to the partner lane and keeps the other half
// (C/2 + C/4 + ... shuffles in all, against 5 C for a plain butterfly of
// every value); the levels left over are plain butterfly levels. After it:
// - C <= 32: v[0] of lane l holds the sum of value l / (32 / C), so each
//   sum sits in 32 / C neighbouring lanes;
// - C == 64: v[0] and v[1] of lane l hold the sums of values 2 l, 2 l + 1.
template <int C>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[C], int lane) {
  static_assert(C >= 1 && C <= 64 && (C & (C - 1)) == 0, "C");
  int c = C;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (c > 1) {
      const int half = c / 2;
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        if (i < half) {
          const float send = up ? v[i] : v[i + half];
          const float keep = up ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      c = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}
