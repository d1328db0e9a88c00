// B15 and B16: the 2D TFIM single-flip amplitude-ratio sum of the MDRNN,
//     ratio[b] = sum_f exp(0.5 * (log p(sigma_b with site f flipped) - log p(sigma_b))),
// with the base log p as a by-product.  B15 reads the given samples; B16
// (sample mode) draws them first in the same base pass.
//
// Replaces: rnnwavefunctions_tpu/ops/mdrnn_flip_kernel.py::mdrnn_flip_ratio_sum
// (B15) and ::mdrnn_sample_and_flip_sum (B16), both _make_kernel.
//
// Bound on the H100: the flip suffixes.  The MDRNN is autoregressive in the
// boustrophedon visit order, so flipping the spin at visit position f leaves
// positions < f untouched and only positions f..NS-1 are recomputed (prefix
// sharing): B*NS*(NS+1)/2 site steps, each two U x U products out of shared
// memory, ~176 GFLOP at the flagship (B=500, 16x16, U=50) against ~1.4 for
// the base pass.  The limit is shared-memory load bandwidth and issue rate.
//
// Design: three launches.
//   1. The base pass (fused_mdrnn.cu's sweep, one warp per sample): in
//      sample mode it draws the spins; it stores the (B, NS, U) cell-output
//      history in visit order, the corrected prefix pfx[m] = log p(positions
//      <= m) and the base log p.
//   2. The suffix pass, one warp per (flip f, group of 4 samples), ordered
//      by flip, longest suffix first; the 4 trajectories share f, so they
//      run in lockstep and each weight load feeds 4 products.  Flip f starts
//      at position f from the horizontal carry hist[f-1] and spin s[f-1]
//      (nothing at a row start) and acc = pfx[f-1] (0 at f = 0), with the
//      target at f flipped.  At position m the vertical state is the
//      trajectory's own (Nx, U) row buffer at column x when
//      vis_up(m) >= f (that site was recomputed), else the base history at
//      vis_up(m); the vertical spin is s[vis_up] flipped iff vis_up == f, so
//      the flip also changes the input of the site below it one row later.
//      The row buffers sit in shared memory; the launch takes the most warps
//      per block (up to 16) whose buffers fit, and a lattice too wide for
//      one warp's buffers is not covered (rnnwf_fits_shared_memory).
//   3. A per-sample sum of the NS ratio terms in flip order, so the result
//      does not depend on how warps were scheduled.
// The TPU kernel's wavefront groups, flip-pair lane packing and row-window
// spill ring are TPU machinery and have no counterpart here.
#include "mdrnn_common.cuh"

namespace rnnwf {

constexpr int kMSufT = 4;

// Row buffer (Nx*U*T), the start carry, the vertical staging buffer and hn
// (U*T each), per warp.
__host__ __device__ inline int suffix_warp_floats(int nx, int u) {
  return (nx + 3) * u * kMSufT;
}

size_t mdrnn_suffix_smem_bytes(int nx, int u, int warps) {
  return sizeof(float) * (mdrnn_weight_floats(u) +
                          static_cast<size_t>(warps) * suffix_warp_floats(nx, u));
}

// The most warps per block (at most kMSufMaxWarps) whose shared memory fits
// in `limit` bytes; 0 when not even one warp fits.  One block per SM holding
// as many warps as fit hides more of each warp's latency than several small
// blocks that each copy the weights.
constexpr int kMSufMaxWarps = 16;

int mdrnn_suffix_warps(int nx, int u, int limit) {
  for (int warps = kMSufMaxWarps; warps >= 1; --warps)
    if (mdrnn_suffix_smem_bytes(nx, u, warps) <= static_cast<size_t>(limit)) return warps;
  return 0;
}

__global__ void mdrnn_suffix_kernel(const int32_t* __restrict__ samples, MWeightPtrs src,
                                    const float* __restrict__ hist,
                                    const float* __restrict__ pfx,
                                    const float* __restrict__ lp, float* __restrict__ terms,
                                    int b_total, int nx, int ny, int u, int warps) {
  extern __shared__ __align__(16) float smem[];
  const MWeights w = load_mdrnn_weights(smem, src, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int ns = nx * ny;
  const int groups = (b_total + kMSufT - 1) / kMSufT;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * warps + warp;
  const int f = static_cast<int>(gw / groups);
  if (f >= ns) return;
  const int grp = static_cast<int>(gw - static_cast<int64_t>(f) * groups);
  const int ut = u * kMSufT;
  float* rowbuf = smem + mdrnn_weight_floats(u) + warp * suffix_warp_floats(nx, u);
  float* h0 = rowbuf + nx * ut;
  float* vst = h0 + ut;
  float* hn = vst + ut;

  const int kf = f % nx;
  int64_t rows[kMSufT];
  const int32_t* sl[kMSufT];
  float xh[kMSufT], xv[kMSufT], acc[kMSufT], cmp[kMSufT], l0[kMSufT], l1[kMSufT];
#pragma unroll
  for (int t = 0; t < kMSufT; ++t) {
    const int b = min(grp * kMSufT + t, b_total - 1);  // padding rows repeat the last sample
    rows[t] = static_cast<int64_t>(b) * ns;
    sl[t] = samples + rows[t];
    if (kf > 0) {
      const float* hf = hist + (rows[t] + f - 1) * u;
      for (int j = lane; j < u; j += kWarp) h0[j * kMSufT + t] = hf[j];
      xh[t] = spin_at(sl[t], f - 1, nx, ny);
    } else {
      xh[t] = 0.0f;
    }
    acc[t] = f > 0 ? pfx[rows[t] + f - 1] : 0.0f;
    cmp[t] = 0.0f;
    xv[t] = 0.0f;
  }
  __syncwarp();

  int x_prev = 0;
  int y = f / nx, k = kf;
  for (int m = f; m < ns; ++m) {
    const int x = (y & 1) ? nx - 1 - k : k;
    const int up = m - 2 * k - 1;
    // the spins of this site and of the one above, loaded ahead of the site
    float s_m[kMSufT], s_up[kMSufT];
#pragma unroll
    for (int t = 0; t < kMSufT; ++t) {
      s_m[t] = static_cast<float>(sl[t][x * ny + y]);
      s_up[t] = y > 0 ? static_cast<float>(sl[t][x * ny + y - 1]) : 0.0f;
    }
    const float* hh = k > 0 ? (m == f ? h0 : rowbuf + x_prev * ut) : nullptr;
    const float* hv = nullptr;
    if (y > 0) {
      if (up >= f) {
        hv = rowbuf + x * ut;
      } else {
#pragma unroll
        for (int t = 0; t < kMSufT; ++t) {
          const float* hb = hist + (rows[t] + up) * u;
          for (int j = lane; j < u; j += kWarp) vst[j * kMSufT + t] = hb[j];
        }
        __syncwarp();
        hv = vst;
      }
#pragma unroll
      for (int t = 0; t < kMSufT; ++t) xv[t] = up == f ? 1.0f - s_up[t] : s_up[t];
    }
    mdrnn_site<kMSufT>(w, u, hh, xh, hv, xv, hn, l0, l1, lane);
#pragma unroll
    for (int t = 0; t < kMSufT; ++t) {
      const float tgt = m == f ? 1.0f - s_m[t] : s_m[t];
      kadd(acc[t], cmp[t], logp2(l0[t], l1[t], tgt));
      xh[t] = tgt;
    }
    for (int e = lane; e < ut; e += kWarp) rowbuf[x * ut + e] = hn[e];
    __syncwarp();
    x_prev = x;
    if (++k == nx) { k = 0; ++y; }
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kMSufT; ++t) {
      const int b = grp * kMSufT + t;
      if (b < b_total) terms[rows[t] + f] = expf(0.5f * ((acc[t] - cmp[t]) - lp[b]));
    }
  }
}

__global__ void mdrnn_flip_sum_kernel(const float* __restrict__ terms,
                                      float* __restrict__ ratio, int b_total, int ns) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= b_total) return;
  const float* t = terms + static_cast<int64_t>(b) * ns;
  float v = 0.0f;
  for (int f = 0; f < ns; ++f) v += t[f];
  ratio[b] = v;
}

int launch_mdrnn_flip(bool sample, int32_t* samples, uint32_t seed, uint32_t offset,
                      const MWeightPtrs& w, void* hist, void* pfx, void* terms, void* lp,
                      void* ratio, int b_total, int nx, int ny, int u, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_mdrnn_sweep(sample, samples, seed, offset, w,
                                       static_cast<float*>(hist), static_cast<float*>(pfx),
                                       static_cast<float*>(lp), b_total, nx, ny, u, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  int device = 0, limit = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = mdrnn_suffix_warps(nx, u, limit);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = mdrnn_suffix_smem_bytes(nx, u, warps);
  err = cudaFuncSetAttribute(mdrnn_suffix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ns = nx * ny;
  const int64_t total = static_cast<int64_t>(ns) * ((b_total + kMSufT - 1) / kMSufT);
  const int blocks = static_cast<int>((total + warps - 1) / warps);
  mdrnn_suffix_kernel<<<blocks, warps * kWarp, smem, st>>>(
      samples, w, static_cast<const float*>(hist), static_cast<const float*>(pfx),
      static_cast<const float*>(lp), static_cast<float*>(terms), b_total, nx, ny, u, warps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  mdrnn_flip_sum_kernel<<<(b_total + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(terms), static_cast<float*>(ratio), b_total, ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rnnwf

// Scratch (allocated by the caller): hist B*NS*U, pfx and terms B*NS floats.
extern "C" int rnnwf_mdrnn_flip_ratio_sum(const void* samples, const void* uh, const void* uv,
                                          const void* wh, const void* wv, const void* b,
                                          const void* hw, const void* hb, void* hist,
                                          void* pfx, void* terms, void* lp, void* ratio,
                                          int b_total, int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return launch_mdrnn_flip(false, static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u,
                           mweight_ptrs(uh, uv, wh, wv, b, hw, hb), hist, pfx, terms, lp,
                           ratio, b_total, nx, ny, u, stream);
}

extern "C" int rnnwf_mdrnn_sample_and_flip_sum(unsigned int seed, unsigned int offset,
                                               const void* uh, const void* uv, const void* wh,
                                               const void* wv, const void* b, const void* hw,
                                               const void* hb, void* samples, void* hist,
                                               void* pfx, void* terms, void* lp, void* ratio,
                                               int b_total, int nx, int ny, int u,
                                               void* stream) {
  using namespace rnnwf;
  return launch_mdrnn_flip(true, static_cast<int32_t*>(samples), seed, offset,
                           mweight_ptrs(uh, uv, wh, wv, b, hw, hb), hist, pfx, terms, lp, ratio,
                           b_total, nx, ny, u, stream);
}
