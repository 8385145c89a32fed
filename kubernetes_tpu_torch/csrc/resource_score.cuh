// NodeResourcesFit's LeastAllocated / MostAllocated score and
// BalancedAllocation of one node, as the solver's tensors compute them
// (ops/noderesources.py): int64 scores with floor division, the balanced
// score in float64 or float32 with round-to-nearest intrinsics (no
// contraction), and their weighted sum cut to int32 as the tensors' dtypes
// cut it. grouped_spread.cu (a spread chunk's frontier rows) and scan_step.cu
// (the per-pod scan step) share it.

#ifndef KUBERNETES_TPU_RESOURCE_SCORE_CUH
#define KUBERNETES_TPU_RESOURCE_SCORE_CUH

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace resource_score {

// floor(a / b), exactly. Where 0 <= a < 2^52 and 0 < b < 2^52 (the scores'
// operands are, at any node's real sizes), through one float64 division: a and b convert
// exactly, and a quotient k - d below an integer k has d >= 1 / b, more than
// the rounding's k * 2^-53 when a + b < 2^53, so the correctly rounded
// quotient truncates to the exact floor. An int64 division costs the card
// about five times the instructions.
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  if (a >= 0 && b > 0 && a < (1ll << 52) && b < (1ll << 52))
    return static_cast<long long>(__ddiv_rn(static_cast<double>(a), static_cast<double>(b)));
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// w_fit * fit + w_bal * balanced over the two scoring resources (cpu,
// memory): `req` the requested amounts with the pod's, `al` the allocatable,
// `fitw` the strategy's resource weights. The balanced score times its
// weight wraps in int32, the sum in int64, and the result is cut to int32.
__device__ __forceinline__ int32_t fit_balanced(const int64_t req[2], const int64_t al[2],
                                                const int64_t* fitw, int most, int f64,
                                                long long w_fit, long long w_bal) {
  int64_t per[2];
  double fd[2];
  float ff[2];
  for (int r = 0; r < 2; ++r) {
    const int64_t al1 = al[r] > 1 ? al[r] : 1;
    const bool ok = al[r] > 0 && req[r] <= al[r];
    per[r] = ok ? floordiv((most ? req[r] : al[r] - req[r]) * 100, al1) : 0;
    if (f64) {
      const double f = al[r] > 0 ? __ddiv_rn(static_cast<double>(req[r]),
                                             static_cast<double>(al1))
                                  : 1.0;
      fd[r] = f > 1.0 ? 1.0 : f;
    } else {
      const float f = al[r] > 0 ? __fdiv_rn(__ll2float_rn(req[r]), __ll2float_rn(al1)) : 1.0f;
      ff[r] = f > 1.0f ? 1.0f : f;
    }
  }
  const int64_t w0 = fitw[0], w1 = fitw[1];
  const int64_t wsum = w0 + w1;
  const int64_t fit = floordiv(per[0] * w0 + per[1] * w1, wsum > 1 ? wsum : 1);
  int32_t bal;
  if (f64) {
    const double sd = __ddiv_rn(fabs(__dsub_rn(fd[0], fd[1])), 2.0);
    bal = static_cast<int32_t>(__dmul_rn(__dsub_rn(1.0, sd), 100.0));
  } else {
    const float sd = __fdiv_rn(fabsf(__fsub_rn(ff[0], ff[1])), 2.0f);
    bal = static_cast<int32_t>(__fmul_rn(__fsub_rn(1.0f, sd), 100.0f));
  }
  const int32_t balw = static_cast<int32_t>(static_cast<uint32_t>(w_bal) *
                                            static_cast<uint32_t>(bal));
  const uint64_t s = static_cast<uint64_t>(w_fit) * static_cast<uint64_t>(fit) +
                     static_cast<uint64_t>(static_cast<int64_t>(balw));
  return static_cast<int32_t>(static_cast<uint32_t>(s));
}

}  // namespace resource_score

#endif  // KUBERNETES_TPU_RESOURCE_SCORE_CUH
