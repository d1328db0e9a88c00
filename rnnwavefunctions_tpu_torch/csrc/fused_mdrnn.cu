// B12 and B13: the 2D MDRNN's boustrophedon sweep, teacher-forced (joint
// log p of given samples) or sampling (draws the samples and their log p),
// the base pass of B15/B16, which also stores the history and the prefixes,
// and B14's replay (its stage 1, csrc/fused_mdrnn_bwd.cu), which stores the
// history and the head's p(s = 1) per (sample, site).
//
// Replaces: rnnwavefunctions_tpu/ops/fused_mdrnn.py::mdrnn_log_prob (B12)
// and ::mdrnn_sample (B13), both _make_sweep_kernel; and the base pass of
// ops/mdrnn_flip_kernel.py::_make_kernel.
//
// Bound on the H100: latency of the NS dependent sites of a sample, each
// two U x U matrix-vector products out of shared memory.  At the flagship
// (B=500, 16x16, U=50) the sweep is ~1.4 GFLOP, far from the FP32 peak.
//
// Design: one warp per sample, four samples per block.  The ~21 KB weight
// set is copied once into shared memory.  Each warp keeps one lattice row of
// cell outputs (Nx x U) and of spins (Nx) in shared memory: column x holds
// the site above the current one until the current site overwrites it, and
// the previous site's column is the horizontal carry.  The site log-probs
// are Kahan-summed in registers in visit order.  Sampling draws from
// Philox4x32-10 keyed by (seed, offset) with counter (sample, visit
// position), as K3 does, so B13 and B16 draw the same samples for the same
// key.  The TPU kernel's lane tiles, feature-major layout and hard selects
// on uninitialised scratch have no counterpart: the boundary reads nothing.
#include "mdrnn_common.cuh"

namespace rnnwf {

constexpr int kSweepWarps = 4;

__host__ __device__ inline int sweep_warp_floats(int nx, int u) {
  return (nx * u + u + nx + 3) & ~3;
}

size_t mdrnn_sweep_smem_bytes(int nx, int u) {
  return sizeof(float) * (mdrnn_weight_floats(u) + kSweepWarps * sweep_warp_floats(nx, u));
}

// What the sweep stores beside log p: nothing (B12, B13), B15/B16's base
// pass (the history and the corrected running prefix pfx) or B14's replay
// (the history and p1 = p(s = 1)); `extra` is pfx or p1, (B, NS).
enum class MStore { kNone, kFlip, kReplay };

template <bool kSample, MStore kStore>
__global__ void mdrnn_sweep_kernel(int32_t* __restrict__ samples, uint32_t seed,
                                   uint32_t offset, MWeightPtrs src, float* __restrict__ hist,
                                   float* __restrict__ extra, float* __restrict__ lp,
                                   int b_total, int nx, int ny, int u) {
  constexpr bool kHist = kStore != MStore::kNone;
  extern __shared__ __align__(16) float smem[];
  const MWeights w = load_mdrnn_weights(smem, src, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kSweepWarps + warp;
  if (b >= b_total) return;
  float* row = smem + mdrnn_weight_floats(u) + warp * sweep_warp_floats(nx, u);
  float* hn = row + nx * u;
  float* srow = hn + u;
  const int ns = nx * ny;
  int32_t* s_lat = samples + static_cast<int64_t>(b) * ns;
  float* h_row = kHist ? hist + static_cast<int64_t>(b) * ns * u : nullptr;

  float xh[1] = {0.0f}, xv[1] = {0.0f}, l0[1], l1[1];
  float acc = 0.0f, cmp = 0.0f;
  int x_prev = 0;
  for (int m = 0; m < ns; ++m) {
    const int y = m / nx, k = m - y * nx;
    const int x = (y & 1) ? nx - 1 - k : k;
    const float* hh = k > 0 ? row + x_prev * u : nullptr;
    const float* hv = y > 0 ? row + x * u : nullptr;
    xv[0] = y > 0 ? srow[x] : 0.0f;
    mdrnn_site<1>(w, u, hh, xh, hv, xv, hn, l0, l1, lane);
    float s;
    if constexpr (kSample) {
      const float p0 = sigmoidf_(l0[0] - l1[0]);
      s = uniform23(seed, offset, static_cast<uint32_t>(b), static_cast<uint32_t>(m)) >= p0
              ? 1.0f : 0.0f;
    } else {
      s = static_cast<float>(s_lat[x * ny + y]);
    }
    kadd(acc, cmp, logp2(l0[0], l1[0], s));
    for (int j = lane; j < u; j += kWarp) {
      row[x * u + j] = hn[j];
      if constexpr (kHist) h_row[static_cast<int64_t>(m) * u + j] = hn[j];
    }
    if (lane == 0) {
      srow[x] = s;
      if constexpr (kSample) s_lat[x * ny + y] = static_cast<int32_t>(s);
      if constexpr (kStore == MStore::kFlip) extra[static_cast<int64_t>(b) * ns + m] = acc - cmp;
      if constexpr (kStore == MStore::kReplay)
        extra[static_cast<int64_t>(b) * ns + m] = expf(logp2(l0[0], l1[0], 1.0f));
    }
    __syncwarp();
    xh[0] = s;
    x_prev = x;
  }
  if (lane == 0) lp[b] = acc - cmp;
}

template <bool kSample, MStore kStore>
cudaError_t launch_sweep(int32_t* samples, uint32_t seed, uint32_t offset, const MWeightPtrs& w,
                         float* hist, float* extra, float* lp, int b_total, int nx, int ny,
                         int u, cudaStream_t stream) {
  const size_t smem = mdrnn_sweep_smem_bytes(nx, u);
  cudaError_t err = cudaFuncSetAttribute(mdrnn_sweep_kernel<kSample, kStore>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b_total + kSweepWarps - 1) / kSweepWarps;
  mdrnn_sweep_kernel<kSample, kStore><<<blocks, kSweepWarps * kWarp, smem, stream>>>(
      samples, seed, offset, w, hist, extra, lp, b_total, nx, ny, u);
  return cudaGetLastError();
}

cudaError_t launch_mdrnn_sweep(bool sample, int32_t* samples, uint32_t seed, uint32_t offset,
                               const MWeightPtrs& w, float* hist, float* pfx, float* lp,
                               int b_total, int nx, int ny, int u, cudaStream_t stream) {
  if (hist != nullptr) {
    return sample ? launch_sweep<true, MStore::kFlip>(samples, seed, offset, w, hist, pfx, lp,
                                                      b_total, nx, ny, u, stream)
                  : launch_sweep<false, MStore::kFlip>(samples, seed, offset, w, hist, pfx, lp,
                                                       b_total, nx, ny, u, stream);
  }
  return sample ? launch_sweep<true, MStore::kNone>(samples, seed, offset, w, hist, pfx, lp,
                                                    b_total, nx, ny, u, stream)
                : launch_sweep<false, MStore::kNone>(samples, seed, offset, w, hist, pfx, lp,
                                                     b_total, nx, ny, u, stream);
}

}  // namespace rnnwf

// B12: samples (B, Nx, Ny) int32 -> out (B) joint log p.
extern "C" int rnnwf_mdrnn_log_prob(const void* samples, const void* uh, const void* uv,
                                    const void* wh, const void* wv, const void* b,
                                    const void* hw, const void* hb, void* out, int b_total,
                                    int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return static_cast<int>(launch_mdrnn_sweep(
      false, static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u,
      mweight_ptrs(uh, uv, wh, wv, b, hw, hb), nullptr, nullptr, static_cast<float*>(out),
      b_total, nx, ny, u, static_cast<cudaStream_t>(stream)));
}

// B13: draws samples (B, Nx, Ny) int32 and writes their log p (B).
extern "C" int rnnwf_mdrnn_sample(unsigned int seed, unsigned int offset, const void* uh,
                                  const void* uv, const void* wh, const void* wv, const void* b,
                                  const void* hw, const void* hb, void* samples, void* lp,
                                  int b_total, int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return static_cast<int>(launch_mdrnn_sweep(
      true, static_cast<int32_t*>(samples), seed, offset, mweight_ptrs(uh, uv, wh, wv, b, hw, hb),
      nullptr, nullptr, static_cast<float*>(lp), b_total, nx, ny, u,
      static_cast<cudaStream_t>(stream)));
}

// B12 storing B14's replay: the joint log p (lp, B floats), the cell-output
// history in visit order (hist, B*NS*U) and the head's p(s = 1) per (sample,
// visit position) (p1, B*NS).
extern "C" int rnnwf_mdrnn_replay(const void* samples, const void* uh, const void* uv,
                                  const void* wh, const void* wv, const void* b, const void* hw,
                                  const void* hb, void* hist, void* p1, void* lp, int b_total,
                                  int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return static_cast<int>(launch_sweep<false, MStore::kReplay>(
      static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u,
      mweight_ptrs(uh, uv, wh, wv, b, hw, hb), static_cast<float*>(hist),
      static_cast<float*>(p1), static_cast<float*>(lp), b_total, nx, ny, u,
      static_cast<cudaStream_t>(stream)));
}
