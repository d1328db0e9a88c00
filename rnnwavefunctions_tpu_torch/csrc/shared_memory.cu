// Which widths the kernels take on a device.  Every kernel keeps a block's
// copy of the weights and its per-warp buffers in shared memory, so a width
// is covered when each kernel of a family has its dynamic shared memory
// within the device's opt-in limit per block (232,448 bytes on an H100).
#include <algorithm>

#include "crnn_common.cuh"

// Writes 1 to *fits when every kernel of `family` (0: the GRU kernels K1-K4,
// 1: the cRNN kernels B7, B9, B10/B11) fits at width u on `device`, else 0.
// Returns the CUDA error of the device query.
extern "C" int rnnwf_fits_shared_memory(int family, int u, int device, int* fits) {
  using namespace rnnwf;
  int limit = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t need =
      family == 0 ? std::max({k1_smem_bytes(u), k2_smem_bytes(u), flip_base_smem_bytes(u),
                              flip_suffix_smem_bytes(u)})
                  : std::max({b7_smem_bytes(u), b9_smem_bytes(u), exchange_base_smem_bytes(u),
                              exchange_suffix_smem_bytes(u)});
  *fits = need <= static_cast<size_t>(limit) ? 1 : 0;
  return 0;
}
