// K1: teacher-forced joint log-probability through a single-layer GRU and
// its 2-logit head.
//
// Replaces: rnnwavefunctions_tpu/ops/fused_gru.py::_log_prob_pallas
// (_make_log_prob_kernel), the forward half of the loss gradient.
//
// Bound on the H100: latency of the sequential site loop.  At the flagship
// shape (B=500, N=100, U=50) the work is B*N*3U*U ~ 0.4 GFMA, so neither
// the FP32 pipes nor HBM come close to their limits; what costs is N
// dependent steps per sample, each a 3U x U matrix-vector product read out
// of shared memory.
//
// Design: one warp per sample and four warps per block, so 125 blocks cover
// the card's 132 SMs at B=500.  The 33 KB weight set is copied once into
// shared memory; the sample's hidden state stays in shared memory across
// all N sites; the site log-probs are Kahan-summed in registers.  Device
// memory sees the samples once and one float per sample.
#include "gru_common.cuh"

namespace rnnwf {

constexpr int kK1Warps = 4;

size_t k1_smem_bytes(int u) { return sizeof(float) * (weight_floats(u) + kK1Warps * 2 * u); }

__global__ void gru_log_prob_kernel(const int32_t* __restrict__ samples,
                                    const float* wx, const float* wh,
                                    const float* bx, const float* bh,
                                    const float* hw, const float* hb,
                                    float* __restrict__ out, int b_total,
                                    int n_sites, int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_weights(smem, wx, wh, bx, bh, hw, hb, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kK1Warps + warp;
  if (b >= b_total) return;
  float* h = smem + weight_floats(u) + warp * 2 * u;
  float* hn = h + u;
  for (int j = lane; j < u; j += kWarp) h[j] = 0.0f;
  __syncwarp();

  const int32_t* s_row = samples + static_cast<int64_t>(b) * n_sites;
  float x[1] = {0.0f}, l0[1], l1[1];
  float acc = 0.0f, cmp = 0.0f;
  for (int n = 0; n < n_sites; ++n) {
    gru_site<1>(w, u, h, hn, x, n > 0 ? 1.0f : 0.0f, l0, l1, lane);
    const float s = static_cast<float>(s_row[n]);
    kadd(acc, cmp, logp2(l0[0], l1[0], s));
    x[0] = s;
    float* tmp = h; h = hn; hn = tmp;
  }
  if (lane == 0) out[b] = acc - cmp;
}

}  // namespace rnnwf

extern "C" int rnnwf_gru_log_prob(const void* samples, const void* wx, const void* wh,
                                  const void* bx, const void* bh, const void* hw,
                                  const void* hb, void* out, int b_total, int n_sites,
                                  int u, void* stream) {
  using namespace rnnwf;
  const size_t smem = k1_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(
      gru_log_prob_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b_total + kK1Warps - 1) / kK1Warps;
  gru_log_prob_kernel<<<blocks, kK1Warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(bx),
      static_cast<const float*>(bh), static_cast<const float*>(hw),
      static_cast<const float*>(hb), static_cast<float*>(out), b_total, n_sites, u);
  return static_cast<int>(cudaGetLastError());
}
