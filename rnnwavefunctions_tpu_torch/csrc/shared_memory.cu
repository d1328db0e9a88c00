// Which widths the kernels take on a device.  Every kernel keeps a block's
// copy of the weights and its per-warp buffers in shared memory, so a width
// is covered when each kernel's dynamic shared memory fits the device's
// opt-in limit per block (232,448 bytes on an H100).
#include <algorithm>

#include "gru_common.cuh"

// Writes 1 to *fits when every kernel fits at width u on `device`, else 0.
// Returns the CUDA error of the device query.
extern "C" int rnnwf_fits_shared_memory(int u, int device, int* fits) {
  using namespace rnnwf;
  int limit = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t need = std::max({k1_smem_bytes(u), k2_smem_bytes(u),
                                flip_base_smem_bytes(u), flip_suffix_smem_bytes(u)});
  *fits = need <= static_cast<size_t>(limit) ? 1 : 0;
  return 0;
}
