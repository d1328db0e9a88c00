// Which shapes the kernels take on a device.  Every kernel keeps a block's
// copy of the weights (or its registers' share of them) and its buffers in
// shared memory, so a shape is covered when each kernel of a family has its
// dynamic shared memory within the device's opt-in limit per block (232,448
// bytes on an H100).
#include <algorithm>

#include "crnn_common.cuh"
#include "mdrnn_common.cuh"

namespace {

// The cRNN family's kernels in the order rnnwf_crnn_smem_bytes reports them.
constexpr int kCrnnKernels = 4;

void crnn_needs(int u, size_t (&need)[kCrnnKernels]) {
  using namespace rnnwf;
  need[0] = exchange_base_smem_bytes(u);
  need[1] = std::max(exchange_suffix_smem_bytes(u), exchange_suffix_rs_smem_bytes(u));
  need[2] = crnn_sweep_smem_bytes(u);
  need[3] = rollout_smem_bytes(u);
}

}  // namespace

// Writes 1 to *fits when every kernel of `family` (0: the GRU kernels K1-K4
// and the jacobian sweep B17, which runs K2's replay and reverse sweep, 1:
// the cRNN kernels B7-B11 (B7 and B9's replay are B10's base pass, its reverse
// sweep and weight cotangent K2's) and the split jacobian sweeps B19/B20
// (B20 runs K2's reverse sweep), 2: the MDRNN kernels B12-B16) fits at width
// u on `device`, else 0.  `nx` is the lattice width of the MDRNN family (its
// kernels keep rows of Nx states); the chain families ignore it.  Returns
// the CUDA error of the device query.
extern "C" int rnnwf_fits_shared_memory(int family, int nx, int u, int device, int* fits) {
  using namespace rnnwf;
  int limit = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t need = 0;
  if (family == 0) {
    need = std::max({k2_smem_bytes(u), flip_base_smem_bytes(u), flip_suffix_smem_bytes(u),
                     flip_suffix_rs_smem_bytes(u)});
  } else if (family == 1) {
    size_t needs[kCrnnKernels];
    crnn_needs(u, needs);
    need = *std::max_element(needs, needs + kCrnnKernels);
  } else {
    need = std::max({mdrnn_sweep_smem_bytes(nx, u), mdrnn_bwd_smem_bytes(nx, u),
                     mdrnn_suffix_smem_bytes(u)});
  }
  *fits = need <= static_cast<size_t>(limit) ? 1 : 0;
  return 0;
}

// The dynamic shared memory of each cRNN kernel at width u, in bytes, into
// need[0..3]: the base pass of B7, B8, B10, B11 and B9's replay; the suffix
// pass of B10/B11; the reverse sweep of B9 and B20; B19.
extern "C" void rnnwf_crnn_smem_bytes(int u, long long* need) {
  size_t needs[kCrnnKernels];
  crnn_needs(u, needs);
  for (int i = 0; i < kCrnnKernels; ++i) need[i] = static_cast<long long>(needs[i]);
}
