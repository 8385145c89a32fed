// One spread chunk's whole random loop for Hopper (sm_90a), in one launch.
//
// What it replaces: no TPU kernel (the JAX package runs the grouped loop as
// a lax.while_loop that XLA compiles, kubernetes_tpu/solver/exact.py
// _solve_grouped). In the port the loop was host code: each iteration of
// solver/grouped.py _Loop.iteration in spread mode launched about 195 small
// kernels (the domain_counts aggregation, two frontier score rows, the
// threefry split and node keys, the winners, the water-fill's ranking sort,
// the scatters), replayed since then as one CUDA graph, and ended in one
// blocking read of its exit row: 22 iterations and 22 reads a 64-pod chunk at
// spread5k's shape. This kernel runs the loop `while placed < vcnt` inside
// one thread block and exits on the card; nothing is read back per
// iteration.
//
// What bounds it: latency. An iteration reads about 25 bytes a node (N 5,000:
// 125 KB, held in shared memory), so neither bytes nor operations bound it;
// the chain of block-wide steps does (five barriers an iteration, two more a
// round of the rare water-fill). The design keeps every per-node and
// per-domain array of the loop in the block's shared memory (in a device
// workspace where N is too large for it: the same code through generic
// pointers), gives each warp a contiguous run of nodes so that the prefix of
// the winners' positions needs one barrier, and recomputes nothing that did
// not change: the domain counts and a node's two frontier scores move only
// where a pod was placed.
//
// Each iteration computes what _Loop.iteration computes in spread mode, on the
// same inputs, in the same arithmetic:
//   - _DomainModel.eval: counts over counted_dom (base + m, kept
//     incrementally), the minimum over present domains, the ok mask, quotas;
//   - frontier_rows for m+1 and m+2: LeastAllocated or MostAllocated in int64
//     with floor division, BalancedAllocation in float64 or float32 with
//     round-to-nearest intrinsics (no contraction; resource_score.cuh, which
//     scan_step.cu shares), the static row added;
//   - scores_at, the best score, the tie set, eligible and ec;
//   - the threefry split and node keys (threefry.cuh, the stream of
//     threefry.cu), for the tie nodes, the only ones whose keys are read;
//   - _winner_accept with the maxSkew > 1 re-entry gate, positions in node
//     order;
//   - _waterfill_accept's condition, and only where it holds, the uniform
//     redraw from the same subkey and each domain's ranking (k rounds of a
//     per-domain minimum of (key, index): the stable sort's order) -- it takes
//     no split, so the stream is the eager loop's;
//   - q, take, single, the scatter into the assignments, m, placed.
// The loop pays the stream's owed splits with its first split, leaves the
// next key in the live slot `cur` and the last subkey in [4..5], and adds its
// iteration count and its kept water-fills to a device row.
//
// The kernel allocates nothing and never synchronises the device; it launches
// on the stream it is given. Built with nvcc for the card; the block body
// (run_chunk) is plain C++ under a host shim too, which the CPU tests use.

#include "resource_score.cuh"
#include "threefry.cuh"

namespace {

using namespace resource_score;
using namespace threefry;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int32_t kInfCount = 1 << 30;  // solver/grouped.py INF_COUNT

// node flags: constant over the chunk ...
constexpr uint8_t HK = 1, CHARGED = 2;
// ... and set anew each iteration
constexpr uint8_t OK = 4, MASK = 8, ELIG = 16, EC = 32, ACC = 64;

// the launch's packed words (ops/grouped_spread.py builds them)
enum Word {
  W_N, W_DPAD, W_GROUP, W_VCNT, W_SKEW, W_DPRESENT, W_SKIP, W_CUR, W_MOST, W_F64,
  W_WFIT, W_WBAL, W_STATE, W_CAP, W_BASE, W_CDOM, W_DOM, W_HK, W_PRESENT, W_ALLOC,
  W_ALLOC_STRIDE, W_NZU, W_NZU_STRIDE, W_NZ, W_FITW, W_SROW, W_M, W_ASG, W_COUNTS,
  W_WORK, W_SMEM, W_THREADS, W_STREAM, W_WORDS
};

struct Args {
  long long n, d_pad, group, vcnt, skew, d_present, skip;
  int cur, most, f64;
  long long w_fit, w_bal;
  int64_t* state;
  const int32_t* cap;
  const int32_t* base;
  const int32_t* cdom;
  const int32_t* dom;
  const bool* hk;
  const bool* present;
  const int64_t* alloc;
  long long alloc_stride;
  const int64_t* nzu;
  long long nzu_stride;
  const int64_t* nz;
  const int64_t* fitw;
  const int32_t* srow;
  int32_t* m;
  int64_t* asg;
  unsigned long long* counts;
  unsigned char* work;
};

__host__ __device__ inline long long align8(long long b) { return (b + 7) / 8 * 8; }

// The loop's arrays, in the workspace (shared memory or a device buffer):
// per node rb, pos (int64), f_now, f_next (int32), flags (uint8); per domain
// seg_key, two minkey buffers (64-bit), counts, seg_elig, d_rank, two minidx
// buffers (int32). Returns the bytes it takes.
struct Layout {
  long long rb, pos, fnow, fnext, flags, seg_key, minkey, dcounts, seg_elig, d_rank, minidx,
      bytes;
};

__host__ __device__ inline Layout layout(long long n, long long d_pad) {
  Layout l;
  long long o = 0;
  l.rb = o;      o = align8(o + 8 * n);
  l.pos = o;     o = align8(o + 8 * n);
  l.seg_key = o; o = align8(o + 8 * d_pad);
  l.minkey = o;  o = align8(o + 16 * d_pad);
  l.fnow = o;    o = align8(o + 4 * n);
  l.fnext = o;   o = align8(o + 4 * n);
  l.dcounts = o; o = align8(o + 4 * d_pad);
  l.seg_elig = o; o = align8(o + 4 * d_pad);
  l.d_rank = o;  o = align8(o + 4 * d_pad);
  l.minidx = o;  o = align8(o + 8 * d_pad);
  l.flags = o;   o = align8(o + n);
  l.bytes = o;
  return l;
}

// frontier_rows: fit + balanced (+ the static row) of placing the jj-th
// identical pod on node i, as torch computes it (resource_score.cuh; the
// static row added in int32).
__device__ int32_t frontier(const Args& a, long long i, long long jj) {
  int64_t req[2], al[2];
  for (int r = 0; r < 2; ++r) {
    req[r] = a.nzu[r * a.nzu_stride + i] + a.nz[r] * jj;
    al[r] = a.alloc[r * a.alloc_stride + i];
  }
  uint32_t f = static_cast<uint32_t>(
      fit_balanced(req, al, a.fitw, a.most, a.f64, a.w_fit, a.w_bal));
  if (a.srow != nullptr) f += static_cast<uint32_t>(a.srow[i]);
  return static_cast<int32_t>(f);
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

// One chunk's loop; every thread of the block calls it. `smem`: the dynamic
// shared memory (the workspace where the launch put it there).
__device__ void run_chunk(const Args& a, unsigned char* smem, int use_smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nw = nthreads >> 5;
  const long long n = a.n, d_pad = a.d_pad, group = a.group;

  __shared__ long long red_a[kMaxWarps], red_b[kMaxWarps], red_c[kMaxWarps],
      red_d[kMaxWarps], red_e[kMaxWarps];
  __shared__ Key sh_k, sh_sub, sh_kn, sh_ks;

  const Layout L = layout(n, d_pad);
  unsigned char* w = use_smem ? smem : a.work;
  int64_t* rb = reinterpret_cast<int64_t*>(w + L.rb);
  int64_t* pos = reinterpret_cast<int64_t*>(w + L.pos);
  int32_t* fnow = reinterpret_cast<int32_t*>(w + L.fnow);
  int32_t* fnext = reinterpret_cast<int32_t*>(w + L.fnext);
  uint8_t* flags = w + L.flags;
  long long* seg_key = reinterpret_cast<long long*>(w + L.seg_key);
  unsigned long long* minkey = reinterpret_cast<unsigned long long*>(w + L.minkey);
  int* dcounts = reinterpret_cast<int*>(w + L.dcounts);
  int* seg_elig = reinterpret_cast<int*>(w + L.seg_elig);
  int32_t* d_rank = reinterpret_cast<int32_t*>(w + L.d_rank);
  int* minidx = reinterpret_cast<int*>(w + L.minidx);

  // each warp owns a contiguous run of nodes (and of domains), walked 32 at
  // a time, so that node order is warp order, then tile, then lane
  const long long chunk = (n + nthreads - 1) / nthreads * 32;
  const long long lo = warp * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const long long dchunk = (d_pad + nthreads - 1) / nthreads * 32;
  const long long dlo = warp * dchunk, dhi = dlo + dchunk < d_pad ? dlo + dchunk : d_pad;

  // -- set-up: the stream's owed splits, the domain arrays, the assignments
  if (tid == 0) {
    Key k = load_key(a.state + a.cur);
    for (long long s = 0; s < a.skip; ++s) k = next_key(k);
    sh_k = k;
  }
  for (long long d = tid; d < d_pad; d += nthreads) {
    dcounts[d] = 0;
    seg_key[d] = -1;
    seg_elig[d] = 0;
    minkey[d] = minkey[d_pad + d] = ~0ull;
    minidx[d] = minidx[d_pad + d] = 0x7fffffff;
  }
  for (long long t = tid; t < group; t += nthreads) a.asg[t] = -1;
  __syncthreads();
  // the domain counts of base + m (m is 0), each node's flags and scores;
  // each warp's present domains, for the water-fill's domain ranks
  for (long long b = lo; b < hi; b += 32) {
    const long long i = b + lane;
    if (i < hi) {
      a.m[i] = 0;
      const int cd = a.cdom[i];
      flags[i] = (a.hk[i] ? HK : 0) | (cd >= 0 ? CHARGED : 0);
      if (cd >= 0) atomicAdd(&dcounts[cd], a.base[i]);
      fnow[i] = frontier(a, i, 1);
      fnext[i] = frontier(a, i, 2);
    }
  }
  long long npres = 0;
  for (long long b = dlo; b < dhi; b += 32) {
    const long long d = b + lane;
    npres += __popc(__ballot_sync(kFull, d < dhi && a.present[d]));
  }
  if (lane == 0) red_a[warp] = npres;
  __syncthreads();
  {
    long long run = -1;
    for (int v = 0; v < warp; ++v) run += red_a[v];
    for (long long b = dlo; b < dhi; b += 32) {
      const long long d = b + lane;
      const bool p = d < dhi && a.present[d];
      const unsigned bal = __ballot_sync(kFull, p);
      if (d < dhi) d_rank[d] = static_cast<int32_t>(run + __popc(bal & ((2u << lane) - 1)));
      run += __popc(bal);
    }
  }
  __syncthreads();

  long long placed = 0, iterations = 0, waterfills = 0;
  const long long d_present = a.d_present > 1 ? a.d_present : 1;
  for (;;) {
    // P1: the minimum and maximum count over present domains; the split
    int lmn = kInfCount, lmx = -1;
    for (long long d = tid; d < d_pad; d += nthreads) {
      if (a.present[d]) {
        const int c = dcounts[d];
        lmn = c < lmn ? c : lmn;
        lmx = c > lmx ? c : lmx;
      }
    }
    lmn = warp_min(lmn);
    lmx = warp_max(lmx);
    if (lane == 0) {
      red_a[warp] = lmn;
      red_b[warp] = lmx;
    }
    if (tid == 0) {
      const Key k = sh_k;
      const Key sub = sub_key(k);
      sh_k = next_key(k);
      sh_sub = sub;
      sh_kn = next_key(sub);
      sh_ks = sub_key(sub);
    }
    __syncthreads();  // A
    int mn = kInfCount, mx = -1;
    for (int v = 0; v < nw; ++v) {
      mn = red_a[v] < mn ? static_cast<int>(red_a[v]) : mn;
      mx = red_b[v] > mx ? static_cast<int>(red_b[v]) : mx;
    }

    // P2: ok, the mask, the best total
    int lbest = -1;
    for (long long b = lo; b < hi; b += 32) {
      const long long i = b + lane;
      if (i < hi) {
        uint8_t fl = flags[i];
        const int dd = a.dom[i] > 0 ? a.dom[i] : 0;
        const bool ok = (fl & HK) && (dcounts[dd] + 1 - mn <= a.skew);
        const bool mask = ok && a.m[i] < a.cap[i];
        if (ok) fl |= OK;
        if (mask) {
          fl |= MASK;
          lbest = fnow[i] > lbest ? fnow[i] : lbest;
        }
        flags[i] = fl;
      }
    }
    lbest = warp_max(lbest);
    if (lane == 0) red_c[warp] = lbest;
    __syncthreads();  // B
    int best = -1;
    for (int v = 0; v < nw; ++v) best = red_c[v] > best ? static_cast<int>(red_c[v]) : best;

    // P3: ties, their node keys, eligible and ec; each domain's highest key
    // and eligible count; the skew-blocked nodes at or above the best
    const Key kn = sh_kn, ks = sh_ks;
    long long lmaxrb = -1, bh = 0, bo = 0;
    for (long long b = lo; b < hi; b += 32) {
      const long long i = b + lane;
      if (i < hi) {
        uint8_t fl = flags[i];
        const int32_t f = fnow[i];
        if ((fl & MASK) && f == best) {  // a tie
          const int64_t r = node_key(kn, ks, static_cast<uint64_t>(i), n);
          rb[i] = r;
          lmaxrb = r > lmaxrb ? r : lmaxrb;
          if (fnext[i] <= f) {
            fl |= ELIG;
            if (fl & CHARGED) {
              fl |= EC;
              const int dd = a.dom[i] > 0 ? a.dom[i] : 0;
              atomicMax(&seg_key[dd], static_cast<long long>(r));
              atomicAdd(&seg_elig[dd], 1);
            }
          }
        }
        if ((fl & HK) && !(fl & OK) && a.m[i] < a.cap[i]) {
          if (f >= best) bh = 1;
          if (f > best) bo = 1;
        }
        flags[i] = fl;
      }
    }
    lmaxrb = warp_max(lmaxrb);
    bh = warp_max(bh);
    bo = warp_max(bo);
    if (lane == 0) {
      red_d[warp] = lmaxrb;
      red_a[warp] = bh;
      red_b[warp] = bo;
    }
    __syncthreads();  // C
    long long maxrb = -1;
    bool blocked_high = false, blocked_over = false;
    for (int v = 0; v < nw; ++v) {
      maxrb = red_d[v] > maxrb ? red_d[v] : maxrb;
      blocked_high |= red_a[v] != 0;
      blocked_over |= red_b[v] != 0;
    }
    const bool gate = a.skew > 1 && blocked_high;
    const long long remaining = a.vcnt - placed;

    // P4: the winners (one a domain with quota, the highest key) and the
    // eligible uncharged nodes; the least eligible count of a present domain
    int lse = kInfCount;
    for (long long d = tid; d < d_pad; d += nthreads) {
      if (a.present[d]) lse = seg_elig[d] < lse ? seg_elig[d] : lse;
    }
    long long wcount = 0;
    for (long long b = lo; b < hi; b += 32) {
      const long long i = b + lane;
      bool acc = false;
      if (i < hi) {
        const uint8_t fl = flags[i];
        if (fl & EC) {
          const int dd = a.dom[i] > 0 ? a.dom[i] : 0;
          long long quota = static_cast<long long>(mn) + a.skew - dcounts[dd];
          quota = quota < 0 ? 0 : (quota > group ? group : quota);
          acc = rb[i] == seg_key[dd] && !gate && quota >= 1;
        } else if ((fl & ELIG) && !(fl & CHARGED)) {
          acc = true;
        }
        if (acc) flags[i] = fl | ACC;
      }
      wcount += __popc(__ballot_sync(kFull, acc));
    }
    lse = warp_min(lse);
    if (lane == 0) {
      red_c[warp] = wcount;
      red_e[warp] = lse;
    }
    __syncthreads();  // D
    long long before = 0, accepted = 0, min_se = kInfCount;
    for (int v = 0; v < nw; ++v) {
      if (v < warp) before += red_c[v];
      accepted += red_c[v];
      min_se = red_e[v] < min_se ? red_e[v] : min_se;
    }
    const long long share = remaining / d_present;
    const long long kk = min_se < share ? min_se : share;
    const bool waterfill = mx == mn && !blocked_over && kk >= 1;

    if (!waterfill) {
      // positions in node order: this warp's offset, then its tiles in turn
      long long run = before;
      for (long long b = lo; b < hi; b += 32) {
        const long long i = b + lane;
        const bool acc = i < hi && (flags[i] & ACC);
        const unsigned bal = __ballot_sync(kFull, acc);
        if (acc) pos[i] = run + __popc(bal & ((1u << lane) - 1));
        run += __popc(bal);
      }
    } else {
      // the water-fill: kk rounds, each taking every domain's least
      // (dd * 2 + u, index) among its ec nodes not yet taken, which is the
      // stable sort's order; the rank is the round
      const Key sub = sh_sub;
      for (long long b = lo; b < hi; b += 32) {
        const long long i = b + lane;
        if (i < hi) {
          const uint8_t fl = flags[i] & ~ACC;
          flags[i] = fl;
          if (fl & EC) {
            const int dd = a.dom[i] > 0 ? a.dom[i] : 0;
            const double u = uniform_f64(sub, static_cast<uint64_t>(i));
            const double keyf = __dadd_rn(__dmul_rn(static_cast<double>(dd), 2.0), u);
            rb[i] = __double_as_longlong(keyf);
          }
        }
      }
      long long taken = 0;
      for (long long r = 0; r < kk; ++r) {
        unsigned long long* mk = minkey + (r & 1) * d_pad;
        int* mi = minidx + (r & 1) * d_pad;
        for (long long b = lo; b < hi; b += 32) {
          const long long i = b + lane;
          if (i < hi && (flags[i] & (EC | ACC)) == EC) {
            const int dd = a.dom[i] > 0 ? a.dom[i] : 0;
            atomicMin(&mk[dd], static_cast<unsigned long long>(rb[i]));
          }
        }
        __syncthreads();
        for (long long b = lo; b < hi; b += 32) {
          const long long i = b + lane;
          if (i < hi && (flags[i] & (EC | ACC)) == EC) {
            const int dd = a.dom[i] > 0 ? a.dom[i] : 0;
            if (static_cast<unsigned long long>(rb[i]) == mk[dd]) {
              atomicMin(&mi[dd], static_cast<int>(i));
            }
          }
        }
        __syncthreads();
        // the round's pick in each domain takes its rank, and clears the
        // buffers the round after next uses again
        for (long long b = lo; b < hi; b += 32) {
          const long long i = b + lane;
          if (i < hi && (flags[i] & (EC | ACC)) == EC) {
            const int dd = a.dom[i] > 0 ? a.dom[i] : 0;
            if (mi[dd] == static_cast<int>(i)) {
              flags[i] |= ACC;
              pos[i] = r * a.d_present + d_rank[dd];
              ++taken;
              mk[dd] = ~0ull;
              mi[dd] = 0x7fffffff;
            }
          }
        }
      }
      taken = warp_sum(taken);
      if (lane == 0) red_c[warp] = taken;
      __syncthreads();  // E
      accepted = 0;
      for (int v = 0; v < nw; ++v) accepted += red_c[v];
    }

    // P5: take the first q accepted nodes (or the single pick), m, placed
    const long long q = accepted < remaining ? accepted : remaining;
    const bool multi = q > 0, feasible = best >= 0;
    const bool single = !multi && feasible;
    const long long pick = maxrb >= 0 ? maxrb % n : 0;
    for (long long b = lo; b < hi; b += 32) {
      const long long i = b + lane;
      if (i < hi) {
        const uint8_t fl = flags[i];
        bool inc = false;
        if (multi && feasible && (fl & ACC) && pos[i] < q) {
          a.asg[placed + pos[i]] = i;
          inc = true;
        } else if (single && i == pick) {
          a.asg[placed] = i;
          inc = true;
        }
        if (inc) {
          const int32_t mi = a.m[i] + 1;
          a.m[i] = mi;
          if (a.cdom[i] >= 0) atomicAdd(&dcounts[a.cdom[i]], 1);
          fnow[i] = frontier(a, i, mi + 1);
          fnext[i] = frontier(a, i, mi + 2);
        }
        flags[i] = fl & (HK | CHARGED);
      }
    }
    for (long long d = tid; d < d_pad; d += nthreads) {
      seg_key[d] = -1;
      seg_elig[d] = 0;
    }
    placed += feasible ? (multi ? q : 1) : remaining;
    ++iterations;
    waterfills += waterfill ? 1 : 0;
    __syncthreads();  // F
    if (placed >= a.vcnt) break;
  }

  if (tid == 0) {
    store_key(a.state + a.cur, sh_k);
    store_key(a.state + 4, sh_sub);
    atomicAdd(&a.counts[0], static_cast<unsigned long long>(iterations));
    atomicAdd(&a.counts[1], static_cast<unsigned long long>(waterfills));
  }
}

inline Args unpack(const long long* w) {
  Args a;
  a.n = w[W_N];
  a.d_pad = w[W_DPAD];
  a.group = w[W_GROUP];
  a.vcnt = w[W_VCNT];
  a.skew = w[W_SKEW];
  a.d_present = w[W_DPRESENT];
  a.skip = w[W_SKIP];
  a.cur = static_cast<int>(w[W_CUR]);
  a.most = static_cast<int>(w[W_MOST]);
  a.f64 = static_cast<int>(w[W_F64]);
  a.w_fit = w[W_WFIT];
  a.w_bal = w[W_WBAL];
  a.state = reinterpret_cast<int64_t*>(w[W_STATE]);
  a.cap = reinterpret_cast<const int32_t*>(w[W_CAP]);
  a.base = reinterpret_cast<const int32_t*>(w[W_BASE]);
  a.cdom = reinterpret_cast<const int32_t*>(w[W_CDOM]);
  a.dom = reinterpret_cast<const int32_t*>(w[W_DOM]);
  a.hk = reinterpret_cast<const bool*>(w[W_HK]);
  a.present = reinterpret_cast<const bool*>(w[W_PRESENT]);
  a.alloc = reinterpret_cast<const int64_t*>(w[W_ALLOC]);
  a.alloc_stride = w[W_ALLOC_STRIDE];
  a.nzu = reinterpret_cast<const int64_t*>(w[W_NZU]);
  a.nzu_stride = w[W_NZU_STRIDE];
  a.nz = reinterpret_cast<const int64_t*>(w[W_NZ]);
  a.fitw = reinterpret_cast<const int64_t*>(w[W_FITW]);
  a.srow = reinterpret_cast<const int32_t*>(w[W_SROW]);
  a.m = reinterpret_cast<int32_t*>(w[W_M]);
  a.asg = reinterpret_cast<int64_t*>(w[W_ASG]);
  a.counts = reinterpret_cast<unsigned long long*>(w[W_COUNTS]);
  a.work = reinterpret_cast<unsigned char*>(w[W_WORK]);
  return a;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(1024) grouped_spread_kernel(Args a, int use_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  run_chunk(a, smem, use_smem);
}
#endif

}  // namespace

extern "C" {

// The word count of a launch, and the workspace bytes the loop's arrays take
// at n nodes and d_pad domains (in shared memory or in the device buffer).
int grouped_spread_words() { return W_WORDS; }

long long grouped_spread_workspace(long long n, long long d_pad) {
  return layout(n, d_pad).bytes;
}

#ifdef __CUDACC__
// Shared memory a block of this kernel may take on `device` (the opt-in
// limit less the kernel's static shared memory), or -1.
int grouped_spread_smem_limit(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, grouped_spread_kernel) != cudaSuccess) return -1;
  return optin - static_cast<int>(attr.sharedSizeBytes);
}

// Lets the kernel take `bytes` of dynamic shared memory (once per device).
int grouped_spread_prepare(int device, int bytes) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  const cudaError_t rc = cudaFuncSetAttribute(
      grouped_spread_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaSetDevice(prev);
  return static_cast<int>(rc);
}

// One chunk's loop: one block of words[W_THREADS] threads (a multiple of
// 32, at most 1,024), the workspace in words[W_SMEM] bytes of dynamic shared
// memory when that is not 0, else in the device buffer words[W_WORK].
// Returns a cudaError_t.
int grouped_spread_launch(const long long* words) {
  const Args a = unpack(words);
  const long long smem = words[W_SMEM];
  grouped_spread_kernel<<<1, static_cast<unsigned>(words[W_THREADS]),
                          static_cast<size_t>(smem),
                          reinterpret_cast<cudaStream_t>(words[W_STREAM])>>>(a, smem > 0);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // extern "C"
