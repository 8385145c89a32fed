// kubernetes_tpu_torch/csrc/grouped_spread.cu's block body on the host, one
// block of std::threads (tests/_cuda_host_shim.h), behind the C interface the
// card's library has: the CPU tests launch it with the wrapper's packed
// words. Built with
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -shared -fPIC
//       -include tests/_cuda_host_shim.h -I kubernetes_tpu_torch/csrc
#include "grouped_spread.cu"

thread_local HostDim threadIdx;
HostDim blockDim;

extern "C" int grouped_spread_emulate(const long long* words) {
  const Args a = unpack(words);
  const long long smem = words[W_SMEM];
  std::vector<unsigned char> shared(smem > 0 ? smem : 1);
  host_shim::run_block(static_cast<int>(words[W_THREADS]),
                       [&](int) { run_chunk(a, shared.data(), smem > 0); });
  return 0;
}
