// Which shapes the kernels take on a device.  Every kernel keeps a block's
// copy of the weights and its per-warp buffers in shared memory, so a shape
// is covered when each kernel of a family has its dynamic shared memory
// within the device's opt-in limit per block (232,448 bytes on an H100).
#include <algorithm>

#include "crnn_common.cuh"
#include "mdrnn_common.cuh"

// Writes 1 to *fits when every kernel of `family` (0: the GRU kernels K1-K4
// and the jacobian sweep B17, which runs K2's replay and reverse sweep, 1:
// the cRNN kernels B7, B9, B10/B11 and the split jacobian sweeps B19/B20,
// 2: the MDRNN kernels B12-B16) fits at
// width u on `device`, else 0.  `nx` is the lattice width of the MDRNN
// family (its kernels keep rows of Nx states); the chain families ignore it.
// Returns the CUDA error of the device query.
extern "C" int rnnwf_fits_shared_memory(int family, int nx, int u, int device, int* fits) {
  using namespace rnnwf;
  int limit = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t need = 0;
  if (family == 0) {
    need = std::max({k2_smem_bytes(u), flip_base_smem_bytes(u), flip_suffix_smem_bytes(u)});
  } else if (family == 1) {
    need = std::max({b7_smem_bytes(u), b9_smem_bytes(u), exchange_base_smem_bytes(u),
                     exchange_suffix_smem_bytes(u), jac_smem_bytes(u),
                     rollout_smem_bytes(u)});
  } else {
    need = std::max({mdrnn_sweep_smem_bytes(nx, u), mdrnn_bwd_smem_bytes(nx, u),
                     mdrnn_suffix_smem_bytes(u)});
  }
  *fits = need <= static_cast<size_t>(limit) ? 1 : 0;
  return 0;
}
