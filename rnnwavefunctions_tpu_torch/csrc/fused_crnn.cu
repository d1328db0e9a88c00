// B7: teacher-forced (Re, Im) log psi of the single-layer U(1) cRNN.
//
// Replaces: rnnwavefunctions_tpu/ops/fused_crnn.py::crnn_log_amp_parts
// (_make_log_amp_kernel), the forward half of the J1-J2 loss gradient.
//
// Bound on the H100: latency of the sequential site loop, as K1's.  At the
// J1-J2 flagship shape (B=500, N=100, U=50) the work is B*N*(3U*U + 4U) ~
// 0.38 GFMA, far from the FP32 peak, and device memory sees only the samples
// and two floats per sample; what costs is N dependent steps per sample,
// each a 3U x U matrix-vector product out of shared memory followed by the
// two heads and the U(1) renormalisation.
//
// Design: K1's (fused_gru.cu): one warp per sample, four warps per block
// (125 blocks at B=500 for the card's 132 SMs), the 34 KB weight set with
// both heads copied once into shared memory, the hidden state in shared
// memory across all N sites.  The running up-count of the mask and the two
// Kahan pairs (Re, Im) live in registers; a masked target contributes the
// finite LOG_ZERO - log norm2, never -inf.
#include "crnn_common.cuh"

namespace rnnwf {

constexpr int kB7Warps = 4;

size_t b7_smem_bytes(int u) {
  return sizeof(float) * (crnn_weight_floats(u) + kB7Warps * 2 * u);
}

__global__ void crnn_log_amp_kernel(const int32_t* __restrict__ samples, WeightPtrs wp,
                                    float* __restrict__ re_out, float* __restrict__ im_out,
                                    int b_total, int n_sites, int u, int u1) {
  extern __shared__ __align__(16) float smem[];
  const CWeights c = load_crnn_weights(smem, wp, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kB7Warps + warp;
  if (b >= b_total) return;
  float* h = smem + crnn_weight_floats(u) + warp * 2 * u;
  float* hn = h + u;
  for (int j = lane; j < u; j += kWarp) h[j] = 0.0f;
  __syncwarp();

  const int32_t* s_row = samples + static_cast<int64_t>(b) * n_sites;
  float x[1] = {0.0f}, up[1] = {0.0f}, lp0[1], lp1[1], ph0[1], ph1[1];
  float re = 0.0f, rec = 0.0f, im = 0.0f, imc = 0.0f;
  for (int n = 0; n < n_sites; ++n) {
    crnn_site<1>(c, u, h, hn, x, n > 0 ? 1.0f : 0.0f, n, up, n_sites, u1 != 0, lp0, lp1,
                 ph0, ph1, lane);
    const float s = static_cast<float>(s_row[n]);
    kadd(re, rec, 0.5f * (s > 0.5f ? lp1[0] : lp0[0]));
    kadd(im, imc, s > 0.5f ? ph1[0] : ph0[0]);
    x[0] = s;
    up[0] += s;
    float* tmp = h; h = hn; hn = tmp;
  }
  if (lane == 0) {
    re_out[b] = re - rec;
    im_out[b] = im - imc;
  }
}

}  // namespace rnnwf

extern "C" int rnnwf_crnn_log_amp_parts(const void* samples, const void* wx, const void* wh,
                                        const void* bx, const void* bh, const void* aw,
                                        const void* ab, const void* pw, const void* pb,
                                        void* re, void* im, int b_total, int n_sites, int u,
                                        int u1, void* stream) {
  using namespace rnnwf;
  const size_t smem = b7_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(
      crnn_log_amp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b_total + kB7Warps - 1) / kB7Warps;
  crnn_log_amp_kernel<<<blocks, kB7Warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(samples), weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb),
      static_cast<float*>(re), static_cast<float*>(im), b_total, n_sites, u, u1);
  return static_cast<int>(cudaGetLastError());
}
