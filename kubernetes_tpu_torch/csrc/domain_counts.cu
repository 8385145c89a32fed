// Per-(term, domain) count aggregation for Hopper (sm_90a).
//
//   out[t, d] = sum_n cnt[t, n] * [dom[t, n] == d],   lanes with dom < 0 excluded
//
// Replaces the TPU kernel kubernetes_tpu/ops/pallas_kernels.py:96
// (domain_counts_pallas), which builds a one-hot [512, d_pad] tile in VMEM and
// contracts it on the MXU in f32. A segment reduction on integers wants integer
// atomics instead: they are exact and independent of order, so the result is
// bit-identical to the reference on every run.
//
// Grid: one block per (node chunk, term row) -- blockIdx.x walks the chunks of
// row blockIdx.y. Two paths, chosen by the wrapper from d_pad:
//   use_smem = 1: the block zeroes a d_pad-entry int32 histogram in (dynamic)
//                 shared memory, its threads stride over the chunk with
//                 shared atomicAdd, then add the nonzero bins into out[t, :]
//                 with global atomicAdd;
//   use_smem = 0: d_pad * 4 bytes exceed what a block can hold, so the threads
//                 add straight into out[t, :] in global memory.
// The wrapper zeroes `out`. The kernel allocates nothing and never
// synchronises; it launches on the stream it is given.
//
// Bound: memory. It must read T*N*8 bytes (dom and cnt) and write T*d_pad*4;
// there is one add per lane. Each thread reads neighbouring lanes of its warp
// (coalesced 128-byte transactions); the histogram keeps the per-lane adds in
// shared memory, so device memory sees one atomic per nonzero bin per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void domain_counts_kernel(const int32_t* __restrict__ dom,
                                     const int32_t* __restrict__ cnt,
                                     int32_t* __restrict__ out,
                                     int64_t n, int d_pad, int64_t chunk,
                                     int use_smem) {
  extern __shared__ int32_t hist[];
  const int64_t t = blockIdx.y;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  const int32_t* dom_row = dom + t * n;
  const int32_t* cnt_row = cnt + t * n;
  int32_t* out_row = out + t * static_cast<int64_t>(d_pad);

  if (use_smem) {
    for (int i = threadIdx.x; i < d_pad; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int64_t j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      const int32_t d = dom_row[j];
      // ids >= d_pad never occur (the tensorizers size d_pad to hold every
      // domain); dropping them keeps the access in bounds all the same
      if (d >= 0 && d < d_pad) {
        const int32_t c = cnt_row[j];
        if (c != 0) atomicAdd(&hist[d], c);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < d_pad; i += blockDim.x) {
      const int32_t v = hist[i];
      if (v != 0) atomicAdd(&out_row[i], v);
    }
  } else {
    for (int64_t j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      const int32_t d = dom_row[j];
      if (d >= 0 && d < d_pad) {
        const int32_t c = cnt_row[j];
        if (c != 0) atomicAdd(&out_row[d], c);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched). dom, cnt: [t, n]
// int32 contiguous on the device; out: [t, d_pad] int32, zeroed by the caller.
int domain_counts_launch(const void* dom, const void* cnt, void* out, int t,
                         long long n, int d_pad, long long chunk, int use_smem,
                         void* stream) {
  const size_t smem = use_smem ? static_cast<size_t>(d_pad) * sizeof(int32_t) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        domain_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_chunks = (n + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>(n_chunks), static_cast<unsigned>(t));
  domain_counts_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dom), static_cast<const int32_t*>(cnt),
      static_cast<int32_t*>(out), static_cast<int64_t>(n), d_pad,
      static_cast<int64_t>(chunk), use_smem);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of shared memory one block may use (cudaDevAttrMaxSharedMemoryPerBlockOptin),
// or -1 when the query fails; the wrapper picks the path from it.
int domain_counts_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return v;
}

}  // extern "C"
