// JAX's threefry2x32 (x64, the partitionable layout) as device functions:
// the hash, the key chain's split, and the bits a draw maps. threefry.cu
// (the solver's draw kernels) and grouped_spread.cu (the spread chunk's
// loop) share them, so both draw the one stream bit for bit.
//
// The key lives in device memory as int64 words; load_key / store_key read
// and write one pair.

#ifndef KUBERNETES_TPU_THREEFRY_CUH
#define KUBERNETES_TPU_THREEFRY_CUH

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace threefry {

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ int rotation(int group, int i) {
  return (group & 1) ? (i == 0 ? 17 : i == 1 ? 29 : i == 2 ? 16 : 24)
                     : (i == 0 ? 13 : i == 1 ? 15 : i == 2 ? 26 : 6);
}

// Threefry-2x32-20: five groups of four rounds, a key injection after each.
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.k0, k.k1, k.k0 ^ k.k1 ^ 0x1BD11BDAu};
  x0 += k.k0;
  x1 += k.k1;
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(g, i));
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return {x0, x1};
}

__device__ __forceinline__ Key next_key(Key k) { return threefry(k, 0u, 0u); }
__device__ __forceinline__ Key sub_key(Key k) { return threefry(k, 0u, 1u); }

__device__ __forceinline__ Key hash_at(Key k, uint64_t i) {
  return threefry(k, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
}

__device__ __forceinline__ uint64_t bits64(Key k, uint64_t i) {
  const Key b = hash_at(k, i);
  return (static_cast<uint64_t>(b.k0) << 32) | b.k1;
}

__device__ __forceinline__ uint32_t bits32(Key k, uint64_t i) {
  const Key b = hash_at(k, i);
  return b.k0 ^ b.k1;
}

__device__ __forceinline__ Key load_key(const int64_t* w) {
  return {static_cast<uint32_t>(w[0]), static_cast<uint32_t>(w[1])};
}

__device__ __forceinline__ void store_key(int64_t* w, Key k) {
  w[0] = k.k0;
  w[1] = k.k1;
}

// uniform float64 of column `col`: the top 52 bits as the mantissa of [1, 2),
// less 1
__device__ __forceinline__ double uniform_f64(Key sub, uint64_t col) {
  const uint64_t b = (bits64(sub, col) >> 12) | 0x3FF0000000000000ull;
  return __longlong_as_double(static_cast<long long>(b)) - 1.0;
}

// randint(sub, (n_all,), 0, 1 << 20, int32) at column `col`, made into the
// unique node key r * n_all + col; `hi_key` is next_key(sub) and `lo_key`
// sub_key(sub). Every product wraps at 32 bits.
__device__ __forceinline__ int64_t node_key(Key hi_key, Key lo_key, uint64_t col,
                                            long long n_all) {
  const uint32_t span = 1u << 20;
  const uint32_t hi = bits32(hi_key, col);
  const uint32_t lw = bits32(lo_key, col);
  uint32_t mult = (1u << 16) % span;
  mult = (mult * mult) % span;
  const uint32_t r = ((hi % span) * mult + lw % span) % span;
  return static_cast<int64_t>(r) * n_all + static_cast<int64_t>(col);
}

}  // namespace threefry

#endif  // KUBERNETES_TPU_THREEFRY_CUH
