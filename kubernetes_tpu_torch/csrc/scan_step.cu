// The exact solver's per-pod scan step for Hopper (sm_90a), in one launch:
// the filters, the scores, the tie-break pick and the assume of one pod.
//
// What it replaces: no TPU kernel (the JAX package's scan step is a
// lax.scan body that XLA compiles, kubernetes_tpu/solver/exact.py
// _solve_scan). In the port the step was plain PyTorch
// (solver/exact.py _make_step over _mask_and_score): about 115 small kernels
// a pod, replayed since then as one CUDA graph per step signature. On the
// card those kernels run back to back, each a microsecond or two of launch
// and tail over 5,120 nodes, so the step took 190-217 us of card a pod while
// it reads about 1 MB. This kernel computes everything the step computes
// after the domain totals; the step's domain_counts launches stay as they
// were, in front of it (their outputs are its inputs).
//
// What bounds it: the per-node instructions, then latency. The step reads
// about 150 bytes a node once (N 5,120: about 0.77 MB, 0.23 us at 3.35 TB/s), but
// spends about a thousand instructions a node (the filters over every term
// row, the fit score's divisions, the balanced score in float64), which one
// SM issues in about 40 us: one block measured 50 us a step on an H100. So
// the step runs on one thread-block cluster of up to 8 blocks, a block per SM,
// about one node a thread (22 us a step at N 5,120, PERF.md). Each block takes a contiguous range of nodes and
// each of its warps a contiguous run of that range, walked 32 at a time, so
// node order is block order, then warp, then tile, then lane. Per node the
// mask and the scores are computed once and kept in a workspace (the block's
// shared memory, or a device buffer where N is too large for it: the same
// code through generic pointers). What the pipeline needs of the whole node
// axis (each normalisation's maximum or minimum over the feasible nodes, the
// feasible count, the best score, the tie count) each block reduces over its
// nodes and publishes in its shared memory, and after the cluster's barrier
// every thread combines the blocks' values through distributed shared memory
// (cluster_peer), in rank order. One cluster barrier a phase:
//   P0 (only for a class with hard spread or required affinity; each block
//      alone, over all domains and nodes): each hard constraint's minimum
//      over its present domains, eight constraints a block barrier, into the
//      workspace; the required affinity's first-pod total;
//   P1: the mask (the class's static mask and node_valid, NodeResourcesFit,
//      NodePorts, the hard spread violations, InterPodAffinity's
//      existing-anti symmetry, incoming required anti and required affinity
//      with its first-pod case), LeastAllocated or MostAllocated +
//      BalancedAllocation (resource_score.cuh, shared with
//      grouped_spread.cu), InterPodAffinity's raw score; the maxima of the
//      TaintToleration and NodeAffinity rows over the mask, the feasible
//      count, the raw score's maximum and minimum over the mask;
//   P2 (only with soft spread scores): the soft spread raw score, and its
//      maximum, minimum and presence over the considered nodes;
//   P3: the total, masked, and the best (score, first index) pair;
//   P4 ("random" only): the tie count of each warp and block; then the warp
//      holding the rank-th tie finds it.
// A last cluster barrier keeps every block alive until the others have read
// its shared memory. The warp that holds the pick adds the pod's take rows into the carried
// state at the pick (the index-add of take64 / take32), writes the
// assignment and, in a replayed step, advances the step table's cursor.
//
// Arithmetic is the torch step's, on the same inputs: int64 for the fit
// scores with floor division, int32 with wrap-around where the tensors are
// int32, BalancedAllocation and the soft spread score in the configured
// float type with round-to-nearest intrinsics and no contraction. The soft
// spread score's log(size + 2) is read from a table the wrapper computes with
// torch.log (ops/scan_step.py), so that it is torch's own on either device.
//
// The draw ("random"): JAX's threefry2x32 stream (threefry.cuh), the scan
// draw of threefry.cu's threefry_scan_draw, bit for bit: the owed splits (the
// launch's, plus the step table's row in a replayed step), the split, and
// randint(sub, (), 0, max(n_ties, 1)) in int64. Its bits do not depend on the
// tie count, so each block's last warp hashes them while the block computes
// the mask; the next key goes into the same live slot `cur`. "first" takes the
// first maximal index.
//
// The class's constraint slots (its hard and soft spread constraints, each
// with its aggregation's outputs and its parameters, and its InterPodAffinity
// term lists) are a table of words in a device buffer the wrapper keeps for
// the class (ops/scan_step.py), of any length: the launch holds its address
// and the counts, and the loops run over the counts.
//
// The kernel allocates nothing and never synchronises the device; it launches
// on the stream it is given. Built with nvcc for the card; the block body
// (run_step) is plain C++ under a host shim too, which the CPU tests use
// (tests/_cuda_host_shim.h gives it the cluster calls below).

#include <limits.h>

#include "resource_score.cuh"
#include "threefry.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

namespace {

using namespace resource_score;
using namespace threefry;

#ifdef __CUDACC__
__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }
__device__ __forceinline__ unsigned cluster_rank() {
  return cooperative_groups::this_cluster().block_rank();
}
// the same shared-memory object of block `rank` of the cluster
template <typename T>
__device__ __forceinline__ T* cluster_peer(T* p, unsigned rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int32_t kInf = 1 << 30;  // ops/spread.py INF_COUNT, ops/interpod.py INF

// the words of a hard and of a soft spread constraint in the slot table;
// P0 reduces the hard constraints' minima kGroup at a time
constexpr int kHardWords = 8, kSoftWords = 5;
constexpr int kGroup = 8;

// launch flags
constexpr long long F_FIT = 1, F_PORTS = 2, F_IPA = 4, F_IPA_FILTER = 8, F_IPA_SCORE = 16,
                    F_MOST = 32, F_F64 = 64, F_RANDOM = 128;

// node flags in the workspace
constexpr uint8_t MASK = 1, CONSIDERED = 2;

// the launch's packed words (ops/scan_step.py builds them)
enum Word {
  W_N, W_K, W_V, W_J, W_TI, W_TE, W_FLAGS,
  W_I64, W_I64_STRIDE, W_I32, W_I32_STRIDE,
  W_ALLOC, W_ALLOC_STRIDE, W_MAXPODS, W_VALID, W_SMASK, W_TAINT, W_NODEAFF, W_IMAGE, W_EXTRA,
  W_FITW, W_LOGTAB,
  W_WFIT, W_WBAL, W_WTAINT, W_WNODEAFF, W_WIMAGE, W_WSPREAD, W_WINTERPOD,
  W_IN_TOT, W_IN_TOT_STRIDE, W_EX_TOT, W_EX_TOT_STRIDE, W_IN_HK, W_IN_HK_STRIDE,
  W_EX_HK, W_EX_HK_STRIDE, W_EX_ANTI,
  W_TAKE64, W_TAKE32, W_REQ_MASK, W_CONFLICT, W_M_ANTI, W_M_W, W_SELF_AFF, W_ROW_STRIDE,
  W_STEPS, W_STEPS_STRIDE, W_CURSOR, W_POD, W_ASG,
  W_STATE, W_CUR, W_SKIP,
  W_WORK, W_SMEM, W_THREADS, W_BLOCKS, W_STREAM,
  W_NHARD, W_NSOFT, W_NANTI, W_NAFF, W_NPREF, W_SLOTS, W_HSLOTS,
  W_WORDS
};

// a hard spread constraint of the class: its aggregation's per-node totals
// and domain counts, its presence and has-key rows, and its parameters
// (min_zero: minDomains exceeds the registered domains, so the minimum is 0);
// kHardWords words of the slot table
struct Hard {
  const int32_t* tot;
  const int32_t* out;
  const bool* present;
  const bool* hk;
  int d_pad, max_skew, self_match, min_zero;
};

// a soft spread constraint: the counts it scores (the per-node totals, or the
// node's own carried count for a hostname key), has-key, and its parameters;
// kSoftWords words of the slot table
struct Soft {
  const int32_t* val;
  const bool* hk;
  int is_host, n_dom, max_skew;
};

struct Args {
  long long n, k, v, j, ti, te, flags;
  int64_t* i64;
  long long i64_stride;
  int32_t* i32;
  long long i32_stride;
  const int64_t* alloc;
  long long alloc_stride;
  const int32_t* max_pods;
  const bool* valid;
  const bool* smask;
  const int32_t* taint;
  const int32_t* nodeaff;
  const int32_t* image;
  const int32_t* extra;
  const int64_t* fitw;
  const double* logtab64;
  const float* logtab32;
  long long w_fit, w_bal, w_taint, w_nodeaff, w_image, w_spread, w_interpod;
  const int32_t* in_tot;
  long long in_tot_stride;
  const int32_t* ex_tot;
  long long ex_tot_stride;
  const bool* in_hk;
  long long in_hk_stride;
  const bool* ex_hk;
  long long ex_hk_stride;
  const bool* ex_anti;
  const unsigned char* take64;
  const unsigned char* take32;
  const unsigned char* req_mask;
  const unsigned char* conflict;
  const unsigned char* m_anti;
  const unsigned char* m_w;
  const unsigned char* self_aff;
  long long row_stride;
  const int64_t* steps;
  long long steps_stride;
  int64_t* cursor;
  long long pod;
  int64_t* asg;
  int64_t* state;
  int cur;
  long long skip;
  unsigned char* work;
  int use_smem;
  int nhard, nsoft, nanti, naff, npref;
  // the slot table's parts: nhard and nsoft constraints, then the term
  // lists (required anti, required affinity, preferred and its weights)
  const long long* hard;
  const long long* soft;
  const long long* anti;
  const long long* aff;
  const long long* pref;
  const long long* prefw;
  long long hslots;  // the hard minima the workspace holds (at least nhard)
};

__device__ __forceinline__ Hard hard_at(const Args& a, int h) {
  const long long* s = a.hard + kHardWords * h;
  return {reinterpret_cast<const int32_t*>(s[0]), reinterpret_cast<const int32_t*>(s[1]),
          reinterpret_cast<const bool*>(s[2]), reinterpret_cast<const bool*>(s[3]),
          static_cast<int>(s[4]), static_cast<int>(s[5]), static_cast<int>(s[6]),
          static_cast<int>(s[7])};
}

__device__ __forceinline__ Soft soft_at(const Args& a, int q) {
  const long long* t = a.soft + kSoftWords * q;
  return {reinterpret_cast<const int32_t*>(t[0]), reinterpret_cast<const bool*>(t[1]),
          static_cast<int>(t[2]), static_cast<int>(t[3]), static_cast<int>(t[4])};
}

__host__ __device__ inline long long align8(long long b) { return (b + 7) / 8 * 8; }

// The workspace (shared memory or a device buffer): the hard constraints'
// minima (hslots int32), then the per-node arrays: score, InterPodAffinity's
// raw score, the soft spread raw score (int32) and the node flags (uint8).
// Returns the bytes they take.
struct Layout {
  long long hmin, score, ipa, soft, flags, bytes;
};

__host__ __device__ inline Layout layout(long long n, long long hslots) {
  Layout l;
  long long o = 0;
  l.hmin = o;  o = align8(o + 4 * hslots);
  l.score = o; o = align8(o + 4 * n);
  l.ipa = o;   o = align8(o + 4 * n);
  l.soft = o;  o = align8(o + 4 * n);
  l.flags = o; o = align8(o + n);
  l.bytes = o;
  return l;
}

// int32 arithmetic that wraps as the tensors' does
__device__ __forceinline__ int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t mul32(long long a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t floordiv32(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(kFull, v, o);
    v = w > v ? w : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A block's scratch at the head of its dynamic shared memory: each warp's
// partials of a phase; the block's partials of a phase, which the cluster's
// blocks read (two sets, one a phase in turn: a set is written again only
// after the barrier that follows the one its readers passed); P0's own
// partials; the draw's bits; the rank.
struct Scratch {
  long long red[5][kMaxWarps];
  long long part[2][5];
  int red0[kGroup][kMaxWarps];
  long long red0_any[kMaxWarps];
  unsigned long long hi, lo;
  Key next;
  long long rank;
};

__host__ __device__ inline long long scratch_bytes() { return align8(sizeof(Scratch)); }

enum Op { MAX, MIN, SUM };

__device__ __forceinline__ long long apply(Op op, long long x, long long y) {
  return op == MAX ? (x > y ? x : y) : op == MIN ? (x < y ? x : y) : x + y;
}

__device__ __forceinline__ long long identity(Op op) {
  return op == MAX ? LLONG_MIN : op == MIN ? LLONG_MAX : 0;
}

// The cluster-wide reduction of k values of every thread, by ops[s]: each warp
// reduces its lanes, warp 0 the block's warps into part[par], and after the
// cluster's barrier every thread combines the blocks' parts in rank order.
__device__ __forceinline__ void cluster_reduce(long long* v, const Op* ops, int k, Scratch* sc,
                                               int par) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int s = 0; s < k; ++s) {
    long long x = v[s];
    for (int o = 16; o > 0; o >>= 1) x = apply(ops[s], x, __shfl_xor_sync(kFull, x, o));
    if (lane == 0) sc->red[s][warp] = x;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < k) {
    const int s = threadIdx.x;
    long long x = identity(ops[s]);
    for (int w = 0; w < nw; ++w) x = apply(ops[s], x, sc->red[s][w]);
    sc->part[par][s] = x;
  }
  cluster_sync();
  for (int s = 0; s < k; ++s) {
    long long x = identity(ops[s]);
    for (unsigned r = 0; r < static_cast<unsigned>(gridDim.x); ++r)
      x = apply(ops[s], x, cluster_peer(sc, r)->part[par][s]);
    v[s] = x;
  }
}

// One pod's step; every thread of every block of the cluster calls it. `smem`:
// the block's dynamic shared memory (its scratch, then its workspace where
// the launch put it there). Inlined into the kernel, so that `a` is the
// kernel's own parameter, which the loops read from the constant bank.
__device__ __forceinline__ void run_step(const Args& a, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nw = nthreads >> 5;
  const unsigned rank_b = cluster_rank(), nblocks = static_cast<unsigned>(gridDim.x);
  const long long n = a.n;
  const long long flags = a.flags;
  const bool random = (flags & F_RANDOM) != 0;
  Scratch* sc = reinterpret_cast<Scratch*>(smem);

  // this block's nodes [b0, b1), this warp's run [lo, hi) of them, walked
  // 32 at a time
  const long long per_block = (n + nblocks - 1) / nblocks;
  const long long b0 = rank_b * per_block < n ? rank_b * per_block : n;
  const long long b1 = b0 + per_block < n ? b0 + per_block : n;
  const Layout L = layout(per_block, a.hslots);
  unsigned char* w = a.use_smem ? smem + scratch_bytes() : a.work + rank_b * L.bytes;
  int32_t* hmin = reinterpret_cast<int32_t*>(w + L.hmin);
  int32_t* score = reinterpret_cast<int32_t*>(w + L.score) - b0;
  int32_t* ipa = reinterpret_cast<int32_t*>(w + L.ipa) - b0;
  int32_t* soft = reinterpret_cast<int32_t*>(w + L.soft) - b0;
  uint8_t* nflags = w + L.flags - b0;
  // the last warp takes no nodes where there is another: it hashes the draw
  const int node_warps = nw > 1 ? nw - 1 : 1;
  const long long chunk = (b1 - b0 + node_warps - 1) / node_warps;
  const long long lo = b0 + warp * chunk < b1 ? b0 + warp * chunk : b1;
  const long long hi = lo + chunk < b1 ? lo + chunk : b1;

  // the pod's row and assignment slot: the step table's at the cursor (a
  // replayed step), or the launch's
  long long cursor = 0, row = 0, pod = a.pod, owed = 0;
  if (a.cursor != nullptr) {
    cursor = *a.cursor;
    row = a.steps[cursor];
    pod = a.steps[a.steps_stride + cursor];
    owed = a.steps[2 * a.steps_stride + cursor];
  }
  const long long rs = row * a.row_stride;
  const int64_t* take64 = reinterpret_cast<const int64_t*>(a.take64 + rs);
  const int32_t* take32 = reinterpret_cast<const int32_t*>(a.take32 + rs);
  const bool* req_mask = reinterpret_cast<const bool*>(a.req_mask + rs);
  const bool* conflict = reinterpret_cast<const bool*>(a.conflict + rs);
  const bool* m_anti = reinterpret_cast<const bool*>(a.m_anti + rs);
  const int32_t* m_w = reinterpret_cast<const int32_t*>(a.m_w + rs);
  const bool self_aff = *reinterpret_cast<const bool*>(a.self_aff + rs);
  const int64_t* req = take64;
  const int64_t* nz = take64 + a.k;

  const long long s32 = a.i32_stride, s64 = a.i64_stride;
  const int32_t* pod_count = a.i32;
  const int32_t* port_used = a.i32 + s32;
  const int32_t* in_cnt = a.i32 + (1 + a.v + a.j) * s32;
  const int64_t* nzu = a.i64 + a.k * s64;

  // the draw's bits, which do not depend on the tie count: the owed splits,
  // the split, the two hashes of the subkey (threefry.cu scan_draw_kernel),
  // one lane each, on the last warp of every block
  if (random && warp == nw - 1 && lane < 3) {
    Key k = load_key(a.state + a.cur);
    const long long pending = a.skip + owed;
    for (long long s = 0; s < pending; ++s) k = next_key(k);
    if (lane == 0) {
      sc->next = next_key(k);
    } else {
      const Key sub = sub_key(k);
      if (lane == 1) {
        sc->hi = bits64(next_key(sub), 0);
      } else {
        sc->lo = bits64(sub_key(sub), 0);
      }
    }
  }

  // P0 (each block alone): each hard constraint's least count over its
  // present domains, into hmin; the required affinity's first-pod total over
  // the valid nodes with the key
  long long total_any = 0;
  if (a.nhard > 0 || a.naff > 0) {
    long long any = 0;
    for (int q = 0; q < a.naff; ++q) {
      const long long jj = a.aff[q];
      for (long long i = tid; i < n; i += nthreads) {
        const int32_t c = in_cnt[jj * s32 + i];
        any += a.in_hk[jj * a.in_hk_stride + i] & a.valid[i] ? c : 0;
      }
    }
    any = warp_sum(any);
    if (lane == 0) sc->red0_any[warp] = any;
    // the hard constraints kGroup at a time: each warp's minima, then the
    // block's, one thread a constraint (at least one pass, for the total)
    int g = 0;
    do {
      const int ge = g + kGroup < a.nhard ? g + kGroup : a.nhard;
      for (int h = g; h < ge; ++h) {
        const Hard c = hard_at(a, h);
        int m = kInf;
        for (long long d = tid; d < c.d_pad; d += nthreads) {
          const int v = c.out[d];
          m = c.present[d] && v < m ? v : m;
        }
        m = warp_min(m);
        if (lane == 0) sc->red0[h - g][warp] = m;
      }
      __syncthreads();  // A
      if (tid < ge - g) {
        int m = kInf;
        for (int v = 0; v < nw; ++v) m = sc->red0[tid][v] < m ? sc->red0[tid][v] : m;
        hmin[g + tid] = hard_at(a, g + tid).min_zero ? 0 : m;
      }
      __syncthreads();  // the minima seen, red0 free again
      g = ge;
    } while (g < a.nhard);
    for (int v = 0; v < nw; ++v) total_any += sc->red0_any[v];
  }

  // P1: the mask, fit + balanced, InterPodAffinity's raw score; the
  // normalisations' maxima and minima over the mask, the feasible count
  const bool fit = (flags & F_FIT) != 0, ports = (flags & F_PORTS) != 0;
  const bool use_ipa = (flags & F_IPA) != 0, ipa_score = (flags & F_IPA_SCORE) != 0;
  int32_t lt = INT32_MIN, ln = INT32_MIN, limx = INT32_MIN, limn = INT32_MAX;
  long long lnf = 0;
  for (long long b = lo; b < hi; b += 32) {
    const long long i = b + lane;
    bool m = false;
    if (i < hi) {
      // every load of a node is unconditional and the tests combine with
      // bitwise operators, so that a node's loads are in flight together
      m = a.smask[i] & a.valid[i];
      if (fit) {
        bool ok = add32(pod_count[i], 1) <= a.max_pods[i];
        for (long long r = 0; r < a.k; ++r) {
          const int64_t u = static_cast<int64_t>(static_cast<uint64_t>(a.i64[r * s64 + i]) +
                                                 static_cast<uint64_t>(req[r]));
          ok &= !req_mask[r] | (u <= a.alloc[r * a.alloc_stride + i]);
        }
        m &= ok;
      }
      if (ports) {
        bool clash = false;
        for (long long v = 0; v < a.v; ++v) clash |= conflict[v] & (port_used[v * s32 + i] > 0);
        m &= !clash;
      }
      for (int h = 0; h < a.nhard; ++h) {
        const Hard c = hard_at(a, h);
        const int32_t skew = sub32(add32(c.tot[i], c.self_match), hmin[h]);
        m &= c.hk[i] & (skew <= c.max_skew);
      }
      if (use_ipa) {
        bool allowed = true;
        // the symmetric weights: an int32 product each, summed in int64
        int64_t sym = 0;
        for (long long t = 0; t < a.te; ++t) {
          const bool hk = a.ex_hk[t * a.ex_hk_stride + i];
          const int32_t tot = a.ex_tot[t * a.ex_tot_stride + i];
          allowed &= !(a.ex_anti[t] & m_anti[t] & hk & (tot > 0));
          sym += hk ? mul32(m_w[t], tot) : 0;
        }
        for (int q = 0; q < a.nanti; ++q) {
          const long long jj = a.anti[q];
          allowed &= !(a.in_hk[jj * a.in_hk_stride + i] & (a.in_tot[jj * a.in_tot_stride + i] > 0));
        }
        if (a.naff > 0) {
          bool all_ok = true, has_all = true;
          for (int q = 0; q < a.naff; ++q) {
            const long long jj = a.aff[q];
            const bool hk = a.in_hk[jj * a.in_hk_stride + i];
            all_ok &= hk & (a.in_tot[jj * a.in_tot_stride + i] > 0);
            has_all &= hk;
          }
          const bool first = total_any == 0 && self_aff && has_all;
          allowed &= all_ok | first;
        }
        if (flags & F_IPA_FILTER) m &= allowed;
        if (ipa_score) {
          int32_t raw = 0;
          for (int q = 0; q < a.npref; ++q) {
            const long long jj = a.pref[q];
            const int32_t tot = a.in_tot[jj * a.in_tot_stride + i];
            raw = add32(raw, a.in_hk[jj * a.in_hk_stride + i] ? mul32(a.prefw[q], tot) : 0);
          }
          raw = add32(raw, static_cast<int32_t>(static_cast<uint32_t>(sym)));
          ipa[i] = raw;
          // the maximum and minimum of where(mask, raw, -/+INF) over the nodes
          const int32_t up = m ? raw : -kInf, down = m ? raw : kInf;
          limx = up > limx ? up : limx;
          limn = down < limn ? down : limn;
        }
      }
      const int64_t rq[2] = {nzu[i] + nz[0], nzu[s64 + i] + nz[1]};
      const int64_t al[2] = {a.alloc[i], a.alloc[a.alloc_stride + i]};
      score[i] = fit_balanced(rq, al, a.fitw, (flags & F_MOST) != 0, (flags & F_F64) != 0,
                              a.w_fit, a.w_bal);
      if (a.w_taint) {
        const int32_t s = m ? a.taint[i] : 0;
        lt = s > lt ? s : lt;
      }
      if (a.w_nodeaff) {
        const int32_t s = m ? a.nodeaff[i] : 0;
        ln = s > ln ? s : ln;
      }
      nflags[i] = m ? MASK : 0;
      lnf += m ? 1 : 0;
    }
  }
  const Op ops1[5] = {MAX, MAX, MAX, MIN, SUM};
  long long v1[5] = {lt, ln, limx, limn, lnf};
  // the parts' set of each cluster phase in turn
  int par = 0;
  cluster_reduce(v1, ops1, 5, sc, par);  // B
  par ^= 1;
  const int32_t tmax = static_cast<int32_t>(v1[0]), nmax = static_cast<int32_t>(v1[1]);
  const int32_t imx = static_cast<int32_t>(v1[2]), imn = static_cast<int32_t>(v1[3]);
  const long long n_feasible = v1[4];

  // P2: the soft spread raw score over the considered nodes
  int32_t smx = INT32_MIN, smn = INT32_MAX;
  bool sany = false;
  if (a.nsoft > 0) {
    const bool f64 = (flags & F_F64) != 0;
    int32_t lmx = INT32_MIN, lmn = INT32_MAX;
    long long lany = 0;
    for (long long b = lo; b < hi; b += 32) {
      const long long i = b + lane;
      if (i < hi) {
        double r64 = 0.0;
        float r32 = 0.0f;
        bool ignored = false;
        for (int q = 0; q < a.nsoft; ++q) {
          const Soft c = soft_at(a, q);
          if (!c.hk[i]) {
            ignored = true;
            continue;
          }
          // c * log(size + 2) + (maxSkew - 1), the scalar in the float type
          const long long size = c.is_host ? n_feasible : c.n_dom;
          const int32_t cnt = c.val[i];
          const double skew1 = static_cast<double>(c.max_skew) - 1.0;
          if (f64) {
            r64 = __dadd_rn(
                r64, __dadd_rn(__dmul_rn(static_cast<double>(cnt), a.logtab64[size]), skew1));
          } else {
            r32 = __fadd_rn(r32, __fadd_rn(__fmul_rn(__int2float_rn(cnt), a.logtab32[size]),
                                           static_cast<float>(skew1)));
          }
        }
        const int32_t raw =
            f64 ? static_cast<int32_t>(rint(r64)) : static_cast<int32_t>(rintf(r32));
        soft[i] = raw;
        // the maximum and minimum of where(considered, raw, -/+INF)
        const bool considered = (nflags[i] & MASK) && !ignored;
        const int32_t up = considered ? raw : -kInf, down = considered ? raw : kInf;
        lmx = up > lmx ? up : lmx;
        lmn = down < lmn ? down : lmn;
        if (considered) {
          nflags[i] |= CONSIDERED;
          lany = 1;
        }
      }
    }
    const Op ops2[3] = {MAX, MIN, MAX};
    long long v2[3] = {lmx, lmn, lany};
    cluster_reduce(v2, ops2, 3, sc, par);  // C
    par ^= 1;
    smx = static_cast<int32_t>(v2[0]);
    smn = static_cast<int32_t>(v2[1]);
    sany = v2[2] != 0;
  }

  // P3: the total over the mask, -1 elsewhere; the best (score, first index)
  long long lkey = LLONG_MIN;
  const int32_t idiff = sub32(imx, imn);
  for (long long b = lo; b < hi; b += 32) {
    const long long i = b + lane;
    if (i < hi) {
      const uint8_t fl = nflags[i];
      const bool m = fl & MASK;
      int32_t f = score[i];
      if (a.w_taint) {
        const int32_t s = m ? a.taint[i] : 0;
        const int32_t scaled = floordiv32(mul32(100, s), tmax > 1 ? tmax : 1);
        f = add32(f, mul32(a.w_taint, tmax > 0 ? 100 - scaled : 100));
      }
      if (a.w_nodeaff) {
        const int32_t s = m ? a.nodeaff[i] : 0;
        const int32_t scaled = floordiv32(mul32(100, s), nmax > 1 ? nmax : 1);
        f = add32(f, mul32(a.w_nodeaff, nmax > 0 ? scaled : 0));
      }
      if (a.w_image) f = add32(f, mul32(a.w_image, a.image[i]));
      if (a.extra != nullptr) f = add32(f, a.extra[i]);
      if (a.nsoft > 0) {
        int32_t norm = floordiv32(mul32(100, sub32(add32(smx, smn), soft[i])), smx > 1 ? smx : 1);
        norm = smx == 0 ? 100 : norm;
        f = add32(f, mul32(a.w_spread, (fl & CONSIDERED) && sany ? norm : 0));
      }
      if (ipa_score && a.w_interpod) {
        const int32_t norm = floordiv32(mul32(100, sub32(ipa[i], imn)), idiff > 1 ? idiff : 1);
        f = add32(f, mul32(a.w_interpod, m && idiff > 0 ? norm : 0));
      }
      const int32_t sc_i = m ? f : -1;
      score[i] = sc_i;
      // the larger score, then the smaller index
      const long long key = static_cast<long long>(
          (static_cast<uint64_t>(static_cast<int64_t>(sc_i)) << 32) |
          static_cast<uint64_t>(~static_cast<uint32_t>(i)));
      lkey = key > lkey ? key : lkey;
    }
  }
  const Op ops3[1] = {MAX};
  long long v3[1] = {lkey};
  cluster_reduce(v3, ops3, 1, sc, par);  // D
  par ^= 1;
  const int32_t best = static_cast<int32_t>(v3[0] >> 32);
  long long pick = static_cast<long long>(~static_cast<uint32_t>(v3[0] & 0xffffffffll));
  bool owner = rank_b == 0 && warp == 0;

  // P4 ("random"): the rank-th of the ties in node order
  if (random) {
    long long cnt = 0;
    for (long long b = lo; b < hi; b += 32) {
      const long long i = b + lane;
      cnt += __popc(__ballot_sync(kFull, i < hi && best >= 0 && score[i] == best));
    }
    if (lane == 0) sc->red[0][warp] = cnt;
    __syncthreads();
    if (tid == 0) {
      long long t = 0;
      for (int v = 0; v < nw; ++v) t += sc->red[0][v];
      sc->part[par][0] = t;
    }
    cluster_sync();  // E
    long long total = 0, before = 0;
    for (unsigned r = 0; r < nblocks; ++r) {
      const long long t = cluster_peer(sc, r)->part[par][0];
      before += r < rank_b ? t : 0;
      total += t;
    }
    for (int v = 0; v < warp; ++v) before += sc->red[0][v];
    if (tid == 0) {
      // randint(sub, (), 0, max(n_ties, 1)) in int64
      const uint64_t span = total > 1 ? static_cast<uint64_t>(total) : 1ull;
      uint64_t mult = (1ull << 32) % span;
      mult = (mult * mult) % span;
      sc->rank = static_cast<long long>(((sc->hi % span) * mult + sc->lo % span) % span);
    }
    __syncthreads();
    const long long rank = sc->rank;
    pick = 0;  // no tie: the first index, as argmax over all-false gives it
    if (total > 0) {
      owner = before <= rank && rank < before + sc->red[0][warp];
      if (owner) {
        long long run = before, found = -1;
        for (long long b = lo; b < hi && found < 0; b += 32) {
          const long long i = b + lane;
          const bool tie = i < hi && score[i] == best;
          const unsigned bal = __ballot_sync(kFull, tie);
          const long long at = run + __popc(bal & ((1u << lane) - 1));
          found = warp_max(tie && at == rank ? i : -1ll);
          run += __popc(bal);
        }
        pick = found;
      }
    }
  }
  // every block's shared memory stays until the others have read it
  cluster_sync();  // F

  // the assume at the pick, the assignment, the cursor and the key
  if (owner) {
    const bool found = best >= 0;
    if (found) {
      for (long long r = lane; r < a.k + 2; r += 32) {
        int64_t* p = a.i64 + r * s64 + pick;
        *p = static_cast<int64_t>(static_cast<uint64_t>(*p) + static_cast<uint64_t>(take64[r]));
      }
      const long long r32 = 1 + a.v + a.j + a.ti + a.te;
      for (long long r = lane; r < r32; r += 32) {
        int32_t* p = a.i32 + r * s32 + pick;
        *p = add32(*p, take32[r]);
      }
    }
    if (lane == 0) {
      a.asg[pod] = found ? pick : -1;
      if (a.cursor != nullptr) *a.cursor = cursor + 1;
      if (random) store_key(a.state + a.cur, sc->next);
    }
  }
}

inline Args unpack(const long long* w) {
  Args a;
  a.n = w[W_N];
  a.k = w[W_K];
  a.v = w[W_V];
  a.j = w[W_J];
  a.ti = w[W_TI];
  a.te = w[W_TE];
  a.flags = w[W_FLAGS];
  a.i64 = reinterpret_cast<int64_t*>(w[W_I64]);
  a.i64_stride = w[W_I64_STRIDE];
  a.i32 = reinterpret_cast<int32_t*>(w[W_I32]);
  a.i32_stride = w[W_I32_STRIDE];
  a.alloc = reinterpret_cast<const int64_t*>(w[W_ALLOC]);
  a.alloc_stride = w[W_ALLOC_STRIDE];
  a.max_pods = reinterpret_cast<const int32_t*>(w[W_MAXPODS]);
  a.valid = reinterpret_cast<const bool*>(w[W_VALID]);
  a.smask = reinterpret_cast<const bool*>(w[W_SMASK]);
  a.taint = reinterpret_cast<const int32_t*>(w[W_TAINT]);
  a.nodeaff = reinterpret_cast<const int32_t*>(w[W_NODEAFF]);
  a.image = reinterpret_cast<const int32_t*>(w[W_IMAGE]);
  a.extra = reinterpret_cast<const int32_t*>(w[W_EXTRA]);
  a.fitw = reinterpret_cast<const int64_t*>(w[W_FITW]);
  a.logtab64 = reinterpret_cast<const double*>(w[W_LOGTAB]);
  a.logtab32 = reinterpret_cast<const float*>(w[W_LOGTAB]);
  a.w_fit = w[W_WFIT];
  a.w_bal = w[W_WBAL];
  a.w_taint = w[W_WTAINT];
  a.w_nodeaff = w[W_WNODEAFF];
  a.w_image = w[W_WIMAGE];
  a.w_spread = w[W_WSPREAD];
  a.w_interpod = w[W_WINTERPOD];
  a.in_tot = reinterpret_cast<const int32_t*>(w[W_IN_TOT]);
  a.in_tot_stride = w[W_IN_TOT_STRIDE];
  a.ex_tot = reinterpret_cast<const int32_t*>(w[W_EX_TOT]);
  a.ex_tot_stride = w[W_EX_TOT_STRIDE];
  a.in_hk = reinterpret_cast<const bool*>(w[W_IN_HK]);
  a.in_hk_stride = w[W_IN_HK_STRIDE];
  a.ex_hk = reinterpret_cast<const bool*>(w[W_EX_HK]);
  a.ex_hk_stride = w[W_EX_HK_STRIDE];
  a.ex_anti = reinterpret_cast<const bool*>(w[W_EX_ANTI]);
  a.take64 = reinterpret_cast<const unsigned char*>(w[W_TAKE64]);
  a.take32 = reinterpret_cast<const unsigned char*>(w[W_TAKE32]);
  a.req_mask = reinterpret_cast<const unsigned char*>(w[W_REQ_MASK]);
  a.conflict = reinterpret_cast<const unsigned char*>(w[W_CONFLICT]);
  a.m_anti = reinterpret_cast<const unsigned char*>(w[W_M_ANTI]);
  a.m_w = reinterpret_cast<const unsigned char*>(w[W_M_W]);
  a.self_aff = reinterpret_cast<const unsigned char*>(w[W_SELF_AFF]);
  a.row_stride = w[W_ROW_STRIDE];
  a.steps = reinterpret_cast<const int64_t*>(w[W_STEPS]);
  a.steps_stride = w[W_STEPS_STRIDE];
  a.cursor = reinterpret_cast<int64_t*>(w[W_CURSOR]);
  a.pod = w[W_POD];
  a.asg = reinterpret_cast<int64_t*>(w[W_ASG]);
  a.state = reinterpret_cast<int64_t*>(w[W_STATE]);
  a.cur = static_cast<int>(w[W_CUR]);
  a.skip = w[W_SKIP];
  a.work = reinterpret_cast<unsigned char*>(w[W_WORK]);
  a.use_smem = w[W_WORK] == 0;
  a.nhard = static_cast<int>(w[W_NHARD]);
  a.nsoft = static_cast<int>(w[W_NSOFT]);
  a.nanti = static_cast<int>(w[W_NANTI]);
  a.naff = static_cast<int>(w[W_NAFF]);
  a.npref = static_cast<int>(w[W_NPREF]);
  // the slot table's parts in order (addresses only: nothing is read here)
  a.hard = reinterpret_cast<const long long*>(w[W_SLOTS]);
  a.soft = a.hard + kHardWords * a.nhard;
  a.anti = a.soft + kSoftWords * a.nsoft;
  a.aff = a.anti + a.nanti;
  a.pref = a.aff + a.naff;
  a.prefw = a.pref + a.npref;
  a.hslots = w[W_HSLOTS];
  return a;
}

#ifdef __CUDACC__
// __grid_constant__: the body reads Args straight from the parameter space,
// with no per-thread copy
__global__ void __launch_bounds__(1024) scan_step_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  run_step(a, smem);
}
#endif

}  // namespace

extern "C" {

// The word count of a launch; the scratch bytes at the head of a block's
// dynamic shared memory; the workspace bytes a block of n nodes takes with
// room for hslots hard constraints' minima (in shared memory or in the device
// buffer).
int scan_step_words() { return W_WORDS; }

long long scan_step_scratch() { return scratch_bytes(); }

long long scan_step_workspace(long long n, long long hslots) { return layout(n, hslots).bytes; }

#ifdef __CUDACC__
// Shared memory a block of this kernel may take on `device` (the opt-in
// limit less the kernel's static shared memory), or -1.
int scan_step_smem_limit(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, scan_step_kernel) != cudaSuccess) return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

// Lets the kernel take `bytes` of dynamic shared memory (once per device).
int scan_step_prepare(int device, int bytes) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  const cudaError_t rc = cudaFuncSetAttribute(
      scan_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaSetDevice(prev);
  return static_cast<int>(rc);
}

// One pod's step: one cluster of words[W_BLOCKS] blocks (at most 8) of
// words[W_THREADS] threads (a multiple of 32, at most 1,024), each with
// words[W_SMEM] bytes of dynamic shared memory: its scratch, then its
// workspace when words[W_WORK] is 0, else the workspace is that device
// buffer, a block's share after another's. Returns a cudaError_t.
int scan_step_launch(const long long* words) {
  const Args a = unpack(words);
  const unsigned blocks = static_cast<unsigned>(words[W_BLOCKS]);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(words[W_THREADS]), 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(words[W_SMEM]);
  cfg.stream = reinterpret_cast<cudaStream_t>(words[W_STREAM]);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, scan_step_kernel, a);
  // read and clear the last error either way: a refused launch leaves its
  // error there, and the next launch's check would take it for its own
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}
#endif

}  // extern "C"
