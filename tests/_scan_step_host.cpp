// kubernetes_tpu_torch/csrc/scan_step.cu's block body on the host, one
// cluster of blocks of std::threads (tests/_cuda_host_shim.h), behind the C
// interface the card's library has: the CPU tests launch it with the
// wrapper's packed words. Built with
//   g++ -std=c++20 -O1 -ffp-contract=off -pthread -shared -fPIC
//       -include tests/_cuda_host_shim.h -I kubernetes_tpu_torch/csrc
#include "scan_step.cu"

thread_local HostDim threadIdx;
HostDim blockDim;

extern "C" int scan_step_emulate(const long long* words) {
  const Args a = unpack(words);
  const int blocks = static_cast<int>(words[W_BLOCKS]);
  std::vector<std::vector<unsigned char>> shared(blocks,
                                                 std::vector<unsigned char>(words[W_SMEM]));
  std::vector<unsigned char*> bases;
  for (auto& b : shared) bases.push_back(b.data());
  host_shim::run_cluster(blocks, static_cast<int>(words[W_THREADS]), bases,
                         [&](int b, int) { run_step(a, bases[b]); });
  return 0;
}
