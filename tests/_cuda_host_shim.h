// The CUDA built-ins that a block body of the port's kernels uses, for the
// host: one block, or one cluster of blocks, of std::threads, __syncthreads as
// a barrier of the block, the cluster's barrier and its shared memory windows
// (cluster_sync, cluster_rank, cluster_peer: the names the kernels give
// cooperative_groups' this_cluster() calls), a warp as 32 of the threads
// exchanging values through a buffer behind a barrier of its own, atomics as
// the compiler's, the round-to-nearest intrinsics as plain IEEE operations
// (build with -ffp-contract=off). Enough to run a block body, slowly and
// exactly, in the CPU tests; no timing means anything here. A kernel whose
// blocks share a cluster keeps its per-block data in the dynamic shared
// memory (a __shared__ variable here is one for every block).

#ifndef KUBERNETES_TPU_CUDA_HOST_SHIM_H
#define KUBERNETES_TPU_CUDA_HOST_SHIM_H

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static

struct HostDim {
  int x;
};

extern thread_local HostDim threadIdx;
extern HostDim blockDim;
inline thread_local HostDim blockIdx;
inline HostDim gridDim;

namespace host_shim {
inline std::vector<std::unique_ptr<std::barrier<>>> blocks;
inline std::unique_ptr<std::barrier<>> cluster;
inline std::vector<std::unique_ptr<std::barrier<>>> warps;
inline std::vector<unsigned char*> smem;  // each block's dynamic shared memory
inline uint64_t xchg[1024][32];

inline int warp_id() { return blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); }
inline void warp_sync() { warps[warp_id()]->arrive_and_wait(); }

// runs body(block, tid) on `threads` threads a block, `nblocks` blocks, as one
// cluster whose blocks' dynamic shared memories are `shared` (may be empty)
template <typename F>
void run_cluster(int nblocks, int threads, std::vector<unsigned char*> shared, F body) {
  blocks.clear();
  warps.clear();
  for (int b = 0; b < nblocks; ++b) blocks.emplace_back(new std::barrier<>(threads));
  for (int w = 0; w < nblocks * (threads / 32); ++w) warps.emplace_back(new std::barrier<>(32));
  cluster.reset(new std::barrier<>(nblocks * threads));
  smem = std::move(shared);
  blockDim.x = threads;
  gridDim.x = nblocks;
  std::vector<std::thread> ts;
  for (int b = 0; b < nblocks; ++b) {
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([b, t, &body] {
        blockIdx.x = b;
        threadIdx.x = t;
        body(b, t);
      });
    }
  }
  for (auto& t : ts) t.join();
}

// runs body(tid) on `threads` threads as one block
template <typename F>
void run_block(int threads, F body) {
  run_cluster(1, threads, {}, [&](int, int t) { body(t); });
}
}  // namespace host_shim

inline void __syncthreads() { host_shim::blocks[blockIdx.x]->arrive_and_wait(); }

inline void cluster_sync() { host_shim::cluster->arrive_and_wait(); }
inline unsigned cluster_rank() { return blockIdx.x; }
template <typename T>
T* cluster_peer(T* p, unsigned rank) {
  const unsigned char* mine = host_shim::smem[blockIdx.x];
  return reinterpret_cast<T*>(host_shim::smem[rank] +
                              (reinterpret_cast<const unsigned char*>(p) - mine));
}

template <typename T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  const int w = host_shim::warp_id(), l = threadIdx.x & 31;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  host_shim::xchg[w][l] = bits;
  host_shim::warp_sync();
  const uint64_t got = host_shim::xchg[w][l ^ lane_mask];
  host_shim::warp_sync();
  T r;
  std::memcpy(&r, &got, sizeof(T));
  return r;
}

inline unsigned __ballot_sync(unsigned, bool p) {
  const int w = host_shim::warp_id(), l = threadIdx.x & 31;
  host_shim::xchg[w][l] = p ? 1 : 0;
  host_shim::warp_sync();
  unsigned out = 0;
  for (int i = 0; i < 32; ++i) out |= host_shim::xchg[w][i] ? (1u << i) : 0u;
  host_shim::warp_sync();
  return out;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

template <typename T>
T host_atomic_add(T* p, T v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

template <typename T, typename Better>
T host_atomic_keep(T* p, T v, Better better) {
  T old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (better(v, old) &&
         !__atomic_compare_exchange_n(p, &old, v, false, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}

inline int atomicAdd(int* p, int v) { return host_atomic_add(p, v); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return host_atomic_add(p, v);
}
inline long long atomicMax(long long* p, long long v) {
  return host_atomic_keep(p, v, [](long long a, long long b) { return a > b; });
}
inline int atomicMin(int* p, int v) {
  return host_atomic_keep(p, v, [](int a, int b) { return a < b; });
}
inline unsigned long long atomicMin(unsigned long long* p, unsigned long long v) {
  return host_atomic_keep(p, v, [](unsigned long long a, unsigned long long b) { return a < b; });
}

inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  const uint32_t s = shift & 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}

inline double __longlong_as_double(long long x) {
  double d;
  std::memcpy(&d, &x, sizeof d);
  return d;
}

inline long long __double_as_longlong(double d) {
  long long x;
  std::memcpy(&x, &d, sizeof x);
  return x;
}

inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __ll2float_rn(long long x) { return static_cast<float>(x); }
inline float __int2float_rn(int x) { return static_cast<float>(x); }

#include <math.h>

#endif  // KUBERNETES_TPU_CUDA_HOST_SHIM_H
