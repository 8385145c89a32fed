// The exact solver's random tie-break draws for Hopper (sm_90a): JAX's
// threefry2x32 stream, bit for bit.
//
// The JAX package draws its random tie-breaks from jax.random (x64, the
// partitionable threefry layout) inside its compiled programs:
//   - the per-pod scan step, kubernetes_tpu/solver/exact.py:352-355:
//     k, sub = split(k); rank = randint(sub, (), 0, max(n_ties, 1)) in int64;
//   - the grouped loop's iteration, exact.py:759-775 and :843:
//     k, s1 = split(k), then uniform(s1, (n,)) in float64 (plain chunks, and
//     the spread water-fill) or randint(s1, (n,), 0, 1 << 20, int32) made
//     into the unique node key r * n + iota (quota chunks).
// No TPU kernel of the repo corresponds to this (XLA lowers jax.random); a
// library generator (cuRAND's Philox, torch.rand) draws another stream, so
// these kernels compute Threefry-2x32-20 (Salmon et al., SC'11) as JAX does.
// The plain versions are kubernetes_tpu_torch/ops/prng.py; the wrapper is
// ops/threefry.py.
//
// The key lives in device memory, in a state of six int64 words: two key
// slots [0..1] and [2..3] and the last subkey [4..5]. Nothing is read back to
// the host: the scan step's tie count is read on the device too.
//
// threefry_scan_draw: one thread. Applies `skip` pending splits (scan rows
// that drew nothing), plus `*skip_at` more when `skip_at` is given (a step
// replayed from a CUDA graph reads its row's pending splits from the device,
// solver/graphs.py), splits the key, splits the subkey, hashes the two
// 64-bit words and maps them onto [0, max(n_ties, 1)) with native unsigned
// 64-bit arithmetic (the same wraps as JAX's uint64 ops), writes the rank
// and the new key in place (slot `cur`). It replaces the one torch.rand
// launch the step made; a dependent chain of six hashes, so latency, not
// throughput, sets its time.
//
// threefry_grouped_draw: one thread per column of [lo, lo + n). With
// `split`, every thread derives the iteration's subkey from slot `cur` after
// `skip` pending splits, and thread 0 writes the new key into the other slot
// (the host flips `cur`) and the subkey into [4..5]: no thread reads a word
// this launch writes, so blocks need no order. Without `split` the threads
// read the subkey of the last split (the water-fill's second draw from the
// same subkey). `what` 0 writes the float64 uniform, 1 the int64 node key.
//
// Bound: operations. A 20-round hash is about 130 integer instructions; the
// grouped draw does 1-3 hashes per column and moves 8 bytes per column, far
// below both of the card's rates at the solver's widths, so the launch sets
// its time (PERF.md has the measured times beside the bound).
//
// The hash, the key chain and the bits a draw maps are threefry.cuh's device
// functions, which grouped_spread.cu shares.
//
// The kernels allocate nothing and never synchronise the device; they launch
// on the stream they are given.

#include "threefry.cuh"

namespace {

using namespace threefry;

constexpr int kThreads = 256;

__global__ void scan_draw_kernel(int64_t* state, int cur, const int64_t* n_ties,
                                 int64_t* rank, long long skip, const int64_t* skip_at) {
  Key k = load_key(state + cur);
  const long long pending = skip + (skip_at != nullptr ? *skip_at : 0);
  for (long long s = 0; s < pending; ++s) k = next_key(k);
  const Key sub = sub_key(k);
  store_key(state + cur, next_key(k));
  // randint(sub, (), 0, max(n_ties, 1)) in int64
  const uint64_t hi = bits64(next_key(sub), 0);
  const uint64_t lo = bits64(sub_key(sub), 0);
  const int64_t t = *n_ties;
  const uint64_t span = t > 1 ? static_cast<uint64_t>(t) : 1ull;
  uint64_t mult = (1ull << 32) % span;
  mult = (mult * mult) % span;
  *rank = static_cast<int64_t>(((hi % span) * mult + lo % span) % span);
}

__global__ void grouped_draw_kernel(int64_t* state, int cur, void* out, long long lo,
                                    long long n, long long n_all, int what, int split,
                                    long long skip) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Key sub;
  if (split) {
    Key k = load_key(state + cur);
    for (long long s = 0; s < skip; ++s) k = next_key(k);
    sub = sub_key(k);
    if (i == 0) {
      store_key(state + (2 - cur), next_key(k));
      store_key(state + 4, sub);
    }
  } else {
    sub = load_key(state + 4);
  }
  if (i >= n) return;
  const uint64_t col = static_cast<uint64_t>(lo + i);
  if (what == 0) {
    // uniform float64: the top 52 bits as the mantissa of [1, 2), less 1
    const uint64_t b = (bits64(sub, col) >> 12) | 0x3FF0000000000000ull;
    static_cast<double*>(out)[i] = __longlong_as_double(static_cast<long long>(b)) - 1.0;
  } else {
    // randint(sub, (n_all,), 0, 1 << 20, int32): every product wraps at 32 bits
    const uint32_t span = 1u << 20;
    const uint32_t hi = bits32(next_key(sub), col);
    const uint32_t lw = bits32(sub_key(sub), col);
    uint32_t mult = (1u << 16) % span;
    mult = (mult * mult) % span;
    const uint32_t r = ((hi % span) * mult + lw % span) % span;
    static_cast<int64_t*>(out)[i] = static_cast<int64_t>(r) * n_all + static_cast<int64_t>(col);
  }
}

}  // namespace

extern "C" {

// The scan step's draw. state: int64[6] on the device; n_ties, rank: int64
// scalars on the device; skip_at: an int64 scalar on the device, or null.
// Returns a cudaError_t.
int threefry_scan_draw(void* state, int cur, const void* n_ties, void* rank, long long skip,
                       const void* skip_at, void* stream) {
  scan_draw_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(state), cur, static_cast<const int64_t*>(n_ties),
      static_cast<int64_t*>(rank), skip, static_cast<const int64_t*>(skip_at));
  return static_cast<int>(cudaGetLastError());
}

// The grouped loop's draw over columns [lo, lo + n): out is float64[n]
// (what 0) or int64[n] (what 1). Returns a cudaError_t.
int threefry_grouped_draw(void* state, int cur, void* out, long long lo, long long n,
                          long long n_all, int what, int split, long long skip,
                          void* stream) {
  const long long blocks = n > 0 ? (n + kThreads - 1) / kThreads : 1;
  grouped_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int64_t*>(state), cur, out, lo, n, n_all, what, split, skip);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
