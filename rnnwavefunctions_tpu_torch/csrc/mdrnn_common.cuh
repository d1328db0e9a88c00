// Shared device code for the 2D MDRNN kernels (B12-B16).
//
// Layout: the weights keep the JAX package's parameter layout
// (models/cells.py::mdrnn_init, dense head): uh (2, U), uv (2, U), wh (U, U),
// wv (U, U), b (U), head w (U, 2), head b (2).  A block copies them once into
// shared memory in exactly this order, so the gradient kernel accumulates
// into a buffer of the same layout and hands back one flat vector.
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

// Floats of the MDRNN weight set: the exact count is the flat gradient's
// length; the padded one keeps the buffers after it 16-byte aligned.
__host__ __device__ inline int mdrnn_weight_floats_exact(int u) { return 2 * u * u + 7 * u + 2; }
__host__ __device__ inline int mdrnn_weight_floats(int u) {
  return (mdrnn_weight_floats_exact(u) + 3) & ~3;
}

// Dynamic shared memory of each MDRNN kernel, defined beside the kernel and
// used both by its launch and by rnnwf_fits_shared_memory.
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

struct MWeights {
  const float* uh;  // (2, U)
  const float* uv;  // (2, U)
  const float* wh;  // (U, U)
  const float* wv;  // (U, U)
  const float* b;   // (U)
  const float* hw;  // (U, 2)
  const float* hb;  // (2)
};

// Cooperative copy of the seven tensors into shared memory (whole block).
__device__ __forceinline__ MWeights load_mdrnn_weights(float* smem, const MWeightPtrs& src,
                                                       int u) {
  const int sizes[7] = {2 * u, 2 * u, u * u, u * u, u, 2 * u, 2};
  float* dst = smem;
  for (int a = 0; a < 7; ++a) {
    for (int i = threadIdx.x; i < sizes[a]; i += blockDim.x) dst[i] = src.p[a][i];
    dst += sizes[a];
  }
  __syncthreads();
  MWeights w;
  w.uh = smem;
  w.uv = w.uh + 2 * u;
  w.wh = w.uv + 2 * u;
  w.wv = w.wh + u * u;
  w.b = w.wv + u * u;
  w.hw = w.b + u;
  w.hb = w.hw + 2 * u;
  return w;
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

// One MDRNN site plus the 2-logit head for the warp's T trajectories.
// hh / hv hold the horizontal / vertical neighbour states as h[k*T + t], or
// are null where that neighbour lies outside the lattice (its input term is
// skipped with it); xh / xv are the neighbour spins (0/1).  Writes hn
// (U*T) and returns every trajectory's logits on every lane (butterfly
// sums, bitwise identical across lanes).  Ends with __syncwarp, so hn is
// visible to the warp and every read of hh / hv is done.
template <int T>
__device__ __forceinline__ void mdrnn_site(const MWeights& w, int u, const float* hh,
                                           const float (&xh)[T], const float* hv,
                                           const float (&xv)[T], float* hn, float (&l0)[T],
                                           float (&l1)[T], int lane) {
  float p0[T], p1[T];
#pragma unroll
  for (int t = 0; t < T; ++t) { p0[t] = 0.0f; p1[t] = 0.0f; }
  // A lane takes the units j and j + 32 together (a single pass up to
  // U = 64), and both products run in one loop where both neighbours exist:
  // 4T independent accumulator chains share each state load.
  for (int j0 = lane; j0 < u; j0 += 2 * kWarp) {
    const int jj[2] = {j0, j0 + kWarp};
    const bool on1 = jj[1] < u;
    float a[2][T], ah[2][T], av[2][T];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = q == 0 || on1 ? jj[q] : j0;  // a missing second unit repeats the first
#pragma unroll
      for (int t = 0; t < T; ++t) {
        a[q][t] = w.b[j];
        if (hh != nullptr) a[q][t] += (1.0f - xh[t]) * w.uh[j] + xh[t] * w.uh[u + j];
        if (hv != nullptr) a[q][t] += (1.0f - xv[t]) * w.uv[j] + xv[t] * w.uv[u + j];
        ah[q][t] = 0.0f;
        av[q][t] = 0.0f;
      }
    }
    const int j1 = on1 ? jj[1] : j0;
    if (hh != nullptr && hv != nullptr) {
#pragma unroll 2
      for (int k = 0; k < u; ++k) {
        const float* wh = w.wh + k * u;
        const float* wv = w.wv + k * u;
        const float wh0 = wh[j0], wh1 = wh[j1], wv0 = wv[j0], wv1 = wv[j1];
        float hk[T], vk[T];
        load_h<T>(hh, k, hk);
        load_h<T>(hv, k, vk);
#pragma unroll
        for (int t = 0; t < T; ++t) {
          ah[0][t] = fmaf(hk[t], wh0, ah[0][t]);
          ah[1][t] = fmaf(hk[t], wh1, ah[1][t]);
          av[0][t] = fmaf(vk[t], wv0, av[0][t]);
          av[1][t] = fmaf(vk[t], wv1, av[1][t]);
        }
      }
    } else if (hh != nullptr || hv != nullptr) {
      const float* hs = hh != nullptr ? hh : hv;
      const float* ws = hh != nullptr ? w.wh : w.wv;
#pragma unroll 2
      for (int k = 0; k < u; ++k) {
        const float w0 = ws[k * u + j0], w1 = ws[k * u + j1];
        float hk[T];
        load_h<T>(hs, k, hk);
#pragma unroll
        for (int t = 0; t < T; ++t) {
          ah[0][t] = fmaf(hk[t], w0, ah[0][t]);
          ah[1][t] = fmaf(hk[t], w1, ah[1][t]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !on1) break;
      const int j = jj[q];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float pre = a[q][t] + (ah[q][t] + av[q][t]);
        const float h = pre > 0.0f ? pre : expf(fminf(pre, 0.0f)) - 1.0f;
        hn[j * T + t] = h;
        p0[t] = fmaf(h, w.hw[2 * j], p0[t]);
        p1[t] = fmaf(h, w.hw[2 * j + 1], p1[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    l0[t] = warp_sum(p0[t]) + w.hb[0];
    l1[t] = warp_sum(p1[t]) + w.hb[1];
  }
  __syncwarp();
}

// The teacher-forced (kSample false) or sampling sweep of B12/B13, which
// also writes the (B, NS, U) history and the corrected running prefix pfx
// (B, NS) for B15/B16 when hist is not null.  Defined in fused_mdrnn.cu.
cudaError_t launch_mdrnn_sweep(bool sample, int32_t* samples, uint32_t seed, uint32_t offset,
                               const MWeightPtrs& w, float* hist, float* pfx, float* lp,
                               int b_total, int nx, int ny, int u, cudaStream_t stream);

}  // namespace rnnwf
