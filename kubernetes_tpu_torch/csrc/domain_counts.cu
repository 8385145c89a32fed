// Per-(term, domain) count aggregation for Hopper (sm_90a), with the
// per-node gather fused.
//
//   out[t, d] = sum_n cnt[t, n] * [dom[t, n] == d],   lanes with dom < 0 excluded
//   tot[t, n] = out[t, max(gdom[t, n], 0)]            (gdom defaults to dom)
//
// Replaces the TPU kernel kubernetes_tpu/ops/pallas_kernels.py:96
// (domain_counts_pallas), which builds a one-hot [512, d_pad] tile in VMEM and
// contracts it on the MXU in f32; `tot` is the gather that
// kubernetes_tpu/ops/interpod.py:61 and ops/spread.py:41 run after it. A
// segment reduction on integers wants integer adds instead: int32 atomics
// are exact and independent of order (they wrap modulo 2^32, as the plain
// version's int64 sum cast to int32 does), so the result is bit-identical to
// the reference on every run.
//
// Design: one thread-block cluster of C blocks per term row (C in 1, 2, 4, 8,
// the portable limit; the wrapper picks it). The row's d_pad-bin histogram is
// split across the cluster's shared memory -- block r owns bins
// [r*slice, (r+1)*slice), slice = ceil(d_pad / C) -- and block r reads lanes
// [r*chunk, (r+1)*chunk) of the row with 16-byte loads where the rows are
// 16-byte aligned. Each lane adds into its bin's owner with a shared atomic
// through distributed shared memory (cluster.map_shared_rank). After
// cluster.sync() each block writes its slice of bins to `out` whole, zeros
// included (every bin written once, no global atomics, no memset before the
// launch), then gathers `tot` for its lanes
// from the distributed histogram; a last cluster.sync() keeps every block's
// shared memory alive until its peers have read it. One launch can carry two
// row sets with the same n and d_pad (InterPodAffinity's `in` and `ex`
// tables): the grid walks the rows of the first, then of the second.
//
// Capacity: a cluster of 8 blocks of 227 KB (232,448 bytes opt-in on an
// H100) holds 8 * 58,112 = 464,896 bins. Beyond it the global path runs the
// same steps with the row's histogram in `out` itself: each block zeroes its
// slice of `out`, cluster.sync(), global atomics, cluster.sync(), gather from
// `out`. It takes every d_pad the reference takes.
//
// Bound: memory. The work reads T*N*8 bytes (dom, cnt), plus T*N*4 for a
// separate gather row, and writes T*d_pad*4 (out) and T*N*4 (tot); one add per
// lane. At the scan's shapes (T 8-16, N 5,120, d_pad 8,192) that is well under
// a microsecond of HBM time, so launch latency and the two cluster barriers
// set the kernel's time; one launch per aggregation, no memset and no separate
// gather launch are what the design does about it.
//
// Cluster size, measured at the main path's shape (T 16 as one two-set launch,
// N 5,120, d_pad 8,192) by chip_smoke.py on an H100 (PERF.md): about 8.9, 6.8,
// 5.6 and 5.4 us of device time for C = 1, 2, 4, 8, so the wrapper spreads a row
// over more blocks while the grid leaves SMs idle and each block keeps at
// least MIN_LANES lanes (ops/domain_counts.py). Combining a warp's
// same-domain lanes with __match_any_sync / __reduce_add_sync before the
// atomic was measured too and lost at every C (11.4 us at C = 8): the match
// costs more than the shared atomics it saves, so the lanes add directly.
//
// The kernel allocates nothing and never synchronises the device; it launches
// on the stream it is given.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

struct RowSet {
  const int32_t* dom;   // [rows, n] domain ids counted by (< 0: not counted)
  const int32_t* cnt;   // [rows, n] per-node counts
  const int32_t* gdom;  // [rows, n] domain ids gathered by (< 0 reads bin 0)
  int32_t* out;         // [rows, d_pad] domain totals, or null (shared path only)
  int32_t* tot;         // [rows, n] gathered per-node totals, or null
  int rows;
};

struct Params {
  RowSet set[2];
  long long n;
  long long chunk;  // lanes per block, a multiple of the vector width
  int d_pad;
  int slice;        // bins per block
};

// The int32 bin of domain d: in its owner's shared memory, or in `out`.
template <bool kGlobal, class Cluster>
__device__ __forceinline__ int32_t* bin_ptr(Cluster& cluster, int32_t* hist,
                                            int32_t* out_row, int slice, int d) {
  if constexpr (kGlobal) {
    return out_row + d;
  } else {
    const unsigned owner = static_cast<unsigned>(d) / static_cast<unsigned>(slice);
    return cluster.map_shared_rank(hist, static_cast<int>(owner)) +
           (d - static_cast<int>(owner) * slice);
  }
}

template <int kVec>
__device__ __forceinline__ void load(const int32_t* p, int32_t (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <bool kGlobal, int kVec>
__global__ void __launch_bounds__(kThreads)
    domain_counts_kernel(Params p) {
  extern __shared__ int32_t hist[];
  auto cluster = cg::this_cluster();
  const unsigned c = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int row = static_cast<int>(blockIdx.x / c);
  const bool second = row >= p.set[0].rows;
  const int r = second ? row - p.set[0].rows : row;
  const long long n = p.n;
  const long long base = static_cast<long long>(r) * n;
  const int32_t* dom = (second ? p.set[1].dom : p.set[0].dom) + base;
  const int32_t* cnt = (second ? p.set[1].cnt : p.set[0].cnt) + base;
  const int32_t* gdom = (second ? p.set[1].gdom : p.set[0].gdom) + base;
  int32_t* out = second ? p.set[1].out : p.set[0].out;
  int32_t* tot = second ? p.set[1].tot : p.set[0].tot;
  int32_t* out_row = out ? out + static_cast<long long>(r) * p.d_pad : nullptr;
  const int d_pad = p.d_pad;
  const int slice = p.slice;

  // 1. zero this block's slice of the row's histogram
  const int b_lo = static_cast<int>(rank) * slice;
  const int nb = max(min(slice, d_pad - b_lo), 0);
  int32_t* mine = kGlobal ? out_row + (nb ? b_lo : 0) : hist;
  for (int i = threadIdx.x; i < nb; i += kThreads) mine[i] = 0;
  if (kGlobal) __threadfence();
  cluster.sync();  // every peer zeroed and running before any add reaches it

  // 2. add this block's lanes (l_hi is a multiple of kVec, so a vector
  // that starts in the block's range ends in it)
  const long long l_lo = min(static_cast<long long>(rank) * p.chunk, n);
  const long long l_hi = min(l_lo + p.chunk, n);
  for (long long j = l_lo + static_cast<long long>(threadIdx.x) * kVec; j < l_hi;
       j += static_cast<long long>(kThreads) * kVec) {
    int32_t d[kVec], v[kVec];
    load<kVec>(dom + j, d);
    load<kVec>(cnt + j, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      // ids >= d_pad never occur (the tensorizers size d_pad to hold every
      // domain); dropping them keeps the access in bounds all the same
      if (d[k] >= 0 && d[k] < d_pad && v[k] != 0)
        atomicAdd(bin_ptr<kGlobal>(cluster, hist, out_row, slice, d[k]), v[k]);
    }
  }
  if (kGlobal) __threadfence();
  cluster.sync();  // the row's histogram is complete

  // 3. write this block's slice of bins out whole (the global path's bins
  // are already in `out`)
  if (!kGlobal && out_row)
    for (int i = threadIdx.x; i < nb; i += kThreads) out_row[b_lo + i] = hist[i];

  // 4. the per-node gather for this block's lanes
  if (tot) {
    int32_t* tot_row = tot + base;
    for (long long j = l_lo + static_cast<long long>(threadIdx.x) * kVec; j < l_hi;
         j += static_cast<long long>(kThreads) * kVec) {
      int32_t g[kVec], t[kVec];
      load<kVec>(gdom + j, g);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int idx = g[k] < 0 ? 0 : g[k];
        if (idx >= d_pad) {
          t[k] = 0;
        } else {
          const int32_t* b = bin_ptr<kGlobal>(cluster, hist, out_row, slice, idx);
          t[k] = kGlobal ? __ldcg(b) : *b;
        }
      }
      if constexpr (kVec == 4) {
        *reinterpret_cast<int4*>(tot_row + j) = make_int4(t[0], t[1], t[2], t[3]);
      } else {
        tot_row[j] = t[0];
      }
    }
    // no block may exit while a peer still reads its shared memory
    if (!kGlobal) cluster.sync();
  }
}

template <bool kGlobal, int kVec>
cudaError_t launch_as(const Params& p, int c, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.set[0].rows + p.set[1].rows) * c), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, domain_counts_kernel<kGlobal, kVec>, p);
}

template <bool kGlobal>
cudaError_t launch_vec(const Params& p, int c, size_t smem, int vec, cudaStream_t s) {
  return vec ? launch_as<kGlobal, 4>(p, c, smem, s) : launch_as<kGlobal, 1>(p, c, smem, s);
}

template <int kVec>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(domain_counts_kernel<false, kVec>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Bytes of shared memory one block may use (cudaDevAttrMaxSharedMemoryPerBlockOptin),
// or -1 when the query fails.
int domain_counts_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

// Once per device, before its first launch: lets every variant of the
// kernel take up to `bytes` of dynamic shared memory. Returns a cudaError_t.
int domain_counts_prepare(int device, int bytes) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaError_t errs[] = {allow_smem<1>(bytes), allow_smem<4>(bytes)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess && err == cudaSuccess) err = e;
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : back);
}

// One launch over one or two row sets. `a` holds 17 64-bit words (one
// buffer, so that the caller pays for one foreign-call argument, not 17):
//   [0..5]   dom, cnt, gdom, out, tot, rows of the first set
//   [6..11]  the same for the second set (rows 0: one set)
//   [12..16] n, d_pad, c, global, stream
// dom, cnt, gdom: [rows, n] int32 contiguous on the device (gdom may equal
// dom); out: [rows, d_pad] int32 or 0 (must be given on the global path);
// tot: [rows, n] int32 or 0. Outputs need no zeroing. c: cluster size in 1,
// 2, 4, 8; global: 1 for the global-memory path. Returns the launch's
// cudaError_t, then cudaGetLastError() (0 = launched).
int domain_counts_launch(const long long* a) {
  Params p;
  for (int s = 0; s < 2; ++s) {
    const long long* w = a + 6 * s;
    p.set[s] = {reinterpret_cast<const int32_t*>(w[0]), reinterpret_cast<const int32_t*>(w[1]),
                reinterpret_cast<const int32_t*>(w[2]), reinterpret_cast<int32_t*>(w[3]),
                reinterpret_cast<int32_t*>(w[4]), static_cast<int>(w[5])};
  }
  const long long n = a[12];
  const int d_pad = static_cast<int>(a[13]);
  const int c = static_cast<int>(a[14]);
  const bool global = a[15] != 0;
  bool vec = n % 4 == 0;
  for (int s = 0; s < (p.set[1].rows > 0 ? 2 : 1); ++s) {
    const RowSet& rs = p.set[s];
    vec = vec && aligned16(rs.dom) && aligned16(rs.cnt) && aligned16(rs.gdom) &&
          (rs.tot == nullptr || aligned16(rs.tot));
  }
  const int width = vec ? 4 : 1;
  p.n = n;
  p.chunk = ((n + c - 1) / c + width - 1) / width * width;
  p.d_pad = d_pad;
  p.slice = (d_pad + c - 1) / c;
  const size_t smem = global ? 0 : static_cast<size_t>(p.slice) * sizeof(int32_t);
  const cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[16]);
  const cudaError_t err = global ? launch_vec<true>(p, c, smem, vec, stream)
                                 : launch_vec<false>(p, c, smem, vec, stream);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
