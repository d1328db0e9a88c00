// Shared device code for the 2D MDRNN kernels (B12-B16).
//
// Layout: the weights keep the JAX package's parameter layout
// (models/cells.py::mdrnn_init, dense head): uh (2, U), uv (2, U), wh (U, U),
// wv (U, U), b (U), head w (U, 2), head b (2).  The gradient kernel
// accumulates into a buffer of the same layout and hands back one flat
// vector.
//
// Visit order (boustrophedon): visit position m lies in row y = m / nx at
// k = m % nx, column x = k on even rows and nx - 1 - k on odd rows.  The
// site above it (same column, row y - 1) has visit position
// vis_up = m - 2k - 1 on both row parities.  Samples stay in the lattice
// layout (B, Nx, Ny): spin (x, y) of sample b is samples[b*Nx*Ny + x*Ny + y].
//
// Site step (ops/fused_mdrnn.py:48-66 of the JAX package):
//   pre = onehot(x_h)·Uh + onehot(x_v)·Uv + h_h·Wh + h_v·Wv + b
//   h   = pre > 0 ? pre : exp(min(pre, 0)) - 1
// At the lattice boundary the horizontal (k == 0) or vertical (y == 0)
// neighbour is a zero vector input and a zero state: its terms are skipped,
// never multiplied by zero, and nothing is read there.
#pragma once

#include "gru_common.cuh"

namespace rnnwf {

// Floats of the MDRNN weight set, the flat gradient's length.
__host__ __device__ inline int mdrnn_weight_floats_exact(int u) { return 2 * u * u + 7 * u + 2; }

// Dynamic shared memory of each MDRNN kernel, defined beside the kernel and
// used both by its launch and by rnnwf_fits_shared_memory.
// The sweep (its row buffers); SIZE_MAX past U = 128, where its register
// share of Wh and Wv ends.
size_t mdrnn_sweep_smem_bytes(int nx, int u);
// B14's reverse sweep (its column buffers); SIZE_MAX past U = 128, where
// its register tiles of Wh and Wv end.
size_t mdrnn_bwd_smem_bytes(int nx, int u);
// The suffix pass (mdrnn_flip.cu), kSuffixTraj trajectories per block.
// Its row buffers are in device memory, so its shared memory does not
// depend on Nx.
constexpr int kSuffixTraj = 32;
size_t mdrnn_suffix_smem_bytes(int u);

// The seven weight tensors as device pointers, in the layout order.
struct MWeightPtrs {
  const float* p[7];
};

inline MWeightPtrs mweight_ptrs(const void* uh, const void* uv, const void* wh,
                                const void* wv, const void* b, const void* hw,
                                const void* hb) {
  return {{static_cast<const float*>(uh), static_cast<const float*>(uv),
           static_cast<const float*>(wh), static_cast<const float*>(wv),
           static_cast<const float*>(b), static_cast<const float*>(hw),
           static_cast<const float*>(hb)}};
}

// Lattice column of visit position m (row y = m / nx).
__device__ __forceinline__ int visit_x(int m, int nx) {
  const int y = m / nx, k = m - y * nx;
  return (y & 1) ? nx - 1 - k : k;
}

// Spin at visit position m of one sample (lattice layout, ny columns).
__device__ __forceinline__ float spin_at(const int32_t* s, int m, int nx, int ny) {
  return static_cast<float>(s[visit_x(m, nx) * ny + m / nx]);
}

// The teacher-forced (kSample false) or sampling sweep of B12/B13, which
// also writes the (B, NS, U) history and the corrected running prefix pfx
// (B, NS) for B15/B16 when hist is not null.  Defined in fused_mdrnn.cu.
cudaError_t launch_mdrnn_sweep(bool sample, int32_t* samples, uint32_t seed, uint32_t offset,
                               const MWeightPtrs& w, float* hist, float* pfx, float* lp,
                               int b_total, int nx, int ny, int u, cudaStream_t stream);

}  // namespace rnnwf
