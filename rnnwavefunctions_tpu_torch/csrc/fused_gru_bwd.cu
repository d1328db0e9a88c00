// K2: the VJP of sum_b g_b log p(sigma_b) with respect to every weight of a
// single-layer GRU and its 2-logit head.
//
// Replaces: rnnwavefunctions_tpu/ops/fused_gru_bwd.py::gru_log_prob_bwd
// (_make_bwd_kernel, run_history_bptt, gru_trunk_bwd_site), the backward
// half of the loss gradient.
//
// Bound on the H100: latency of the two sequential site sweeps (forward
// replay, then the reverse sweep), each site a few dependent 3U x U
// products out of shared memory, plus the per-site outer-product updates
// of the 3U x U weight cotangent.  The history the reverse sweep reads is
// B*N*U floats (10 MB at B=500, N=100, U=50): it stays in L2.
//
// Design: one warp per sample, four samples per block.  The forward replay
// writes the (N, U) hidden history of each sample to device memory.  The
// reverse sweep recomputes the gates from h[n-1] per site (math in
// fused_gru_bwd.py:29-39).  The per-site cotangents of the block's samples
// meet in shared memory, and every thread of the block owns a fixed set of
// weight-cotangent entries that it updates in a fixed sample order: no
// atomics, so the result is the same on every run.  Where the TPU grid
// added every tile into one output in turn (fused_gru_bwd.py:542-553), GPU
// blocks run in parallel, so each block writes its partial gradient and a
// second kernel sums the partials in block order.
#include "gru_common.cuh"

namespace rnnwf {

constexpr int kK2Warps = 4;

__host__ __device__ inline int k2_warp_floats(int u) { return 13 * u + 4; }

size_t k2_smem_bytes(int u) {
  return sizeof(float) * (2 * weight_floats(u) + kK2Warps * k2_warp_floats(u));
}

__global__ void gru_bwd_kernel(const int32_t* __restrict__ samples,
                               const float* __restrict__ g_in, const float* wx,
                               const float* wh, const float* bx, const float* bh,
                               const float* hw, const float* hb,
                               float* __restrict__ hist, float* __restrict__ partial,
                               int b_total, int n_sites, int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_weights(smem, wx, wh, bx, bh, hw, hb, u);
  const int g3 = 3 * u;
  const int wf = weight_floats(u), wfx = weight_floats_exact(u);
  float* acc = smem + wf;
  for (int e = threadIdx.x; e < wfx; e += blockDim.x) acc[e] = 0.0f;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kK2Warps + warp;
  const bool valid = b < b_total;
  float* pw = smem + 2 * wf + warp * k2_warp_floats(u);
  float* h = pw;
  float* hn = h + u;
  float* hp = hn + u;
  float* hc = hp + u;
  float* dh = hc + u;
  float* dhs = dh + u;
  float* zb = dhs + u;
  float* da = zb + u;
  float* dgh = da + g3;
  float* sc = dgh + g3;
  const float gb = valid ? g_in[b] : 0.0f;
  const int32_t* s_row = samples + static_cast<int64_t>(valid ? b : 0) * n_sites;
  float* h_row = hist + static_cast<int64_t>(valid ? b : 0) * n_sites * u;

  // ---- forward replay: store h_n for every site
  if (valid) {
    for (int j = lane; j < u; j += kWarp) h[j] = 0.0f;
    __syncwarp();
    float x[1] = {0.0f}, l0[1], l1[1];
    for (int n = 0; n < n_sites; ++n) {
      gru_site<1>(w, u, h, hn, x, n > 0 ? 1.0f : 0.0f, l0, l1, lane);
      for (int j = lane; j < u; j += kWarp) h_row[n * u + j] = hn[j];
      x[0] = static_cast<float>(s_row[n]);
      float* tmp = h; h = hn; hn = tmp;
    }
  }
  for (int j = lane; j < u; j += kWarp) dh[j] = 0.0f;
  __syncthreads();

  // ---- reverse sweep
  for (int n = n_sites - 1; n >= 0; --n) {
    for (int j = lane; j < u; j += kWarp) {
      hc[j] = valid ? h_row[n * u + j] : 0.0f;
      hp[j] = (valid && n > 0) ? h_row[(n - 1) * u + j] : 0.0f;
    }
    const float s_n = valid ? static_cast<float>(s_row[n]) : 0.0f;
    const float xr = (valid && n > 0) ? static_cast<float>(s_row[n - 1]) : 0.0f;
    const float xs = n > 0 ? 1.0f : 0.0f;
    __syncwarp();

    // head: logits from h_n, dlogit_1 = g (s - p1) = -dlogit_0
    float p0 = 0.0f, p1 = 0.0f;
    for (int j = lane; j < u; j += kWarp) {
      p0 = fmaf(hc[j], w.hw[2 * j], p0);
      p1 = fmaf(hc[j], w.hw[2 * j + 1], p1);
    }
    const float l0 = warp_sum(p0) + w.hb[0];
    const float l1 = warp_sum(p1) + w.hb[1];
    const float dl1 = gb * (s_n - sigmoidf_(l1 - l0));

    // gates recomputed from h_{n-1}, then their cotangents
    for (int j = lane; j < u; j += kWarp) {
      float ar = 0.0f, az = 0.0f, ac = 0.0f;
      for (int k = 0; k < u; ++k) {
        const float* wk = w.wh + k * g3;
        const float hk = hp[k];
        ar = fmaf(hk, wk[j], ar);
        az = fmaf(hk, wk[u + j], az);
        ac = fmaf(hk, wk[2 * u + j], ac);
      }
      const float gxr = xs * ((1.0f - xr) * w.wx[j] + xr * w.wx[g3 + j]) + w.bx[j];
      const float gxz = xs * ((1.0f - xr) * w.wx[u + j] + xr * w.wx[g3 + u + j]) + w.bx[u + j];
      const float gxc = xs * ((1.0f - xr) * w.wx[2 * u + j] + xr * w.wx[g3 + 2 * u + j]) + w.bx[2 * u + j];
      const float ghc = ac + w.bh[2 * u + j];
      const float r = sigmoidf_(gxr + (ar + w.bh[j]));
      const float z = sigmoidf_(gxz + (az + w.bh[u + j]));
      const float c = tanhf(gxc + r * ghc);

      const float dht = dh[j] + (w.hw[2 * j + 1] - w.hw[2 * j]) * dl1;
      const float dz = dht * (hp[j] - c);
      const float dc = dht * (1.0f - z);
      const float dac = dc * (1.0f - c * c);
      const float dr = dac * ghc;
      const float dar = dr * r * (1.0f - r);
      const float daz = dz * z * (1.0f - z);
      da[j] = dar; da[u + j] = daz; da[2 * u + j] = dac;
      dgh[j] = dar; dgh[u + j] = daz; dgh[2 * u + j] = dac * r;
      zb[j] = z;
      dhs[j] = dht;
    }
    __syncwarp();
    // recurrent cotangent: dh_{n-1} = dh * z + wh @ dgh
    for (int k = lane; k < u; k += kWarp) {
      const float* wk = w.wh + k * g3;
      float d = 0.0f;
      for (int q = 0; q < g3; ++q) d = fmaf(wk[q], dgh[q], d);
      dh[k] = dhs[k] * zb[k] + d;
    }
    if (lane == 0) { sc[0] = xr; sc[1] = xs; sc[2] = dl1; }
    __syncthreads();

    // ---- block accumulation: thread-owned entries, fixed sample order
    const float* pws[kK2Warps];
#pragma unroll
    for (int q = 0; q < kK2Warps; ++q) pws[q] = smem + 2 * wf + q * k2_warp_floats(u);
    // offsets of each per-warp buffer inside pws[q]
    const int o_hp = 2 * u, o_hc = 3 * u, o_da = 7 * u, o_dgh = 7 * u + g3, o_sc = 7 * u + 2 * g3;
    float* a_wx = acc;
    float* a_wh = a_wx + 2 * g3;
    float* a_bx = a_wh + u * g3;
    float* a_bh = a_bx + g3;
    float* a_hw = a_bh + g3;
    float* a_hb = a_hw + 2 * u;
    for (int e = threadIdx.x; e < 2 * g3; e += blockDim.x) {
      const int row = e / g3, q3 = e - row * g3;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kK2Warps; ++q) {
        const float* sq = pws[q] + o_sc;
        const float xw = row == 0 ? sq[1] * (1.0f - sq[0]) : sq[1] * sq[0];
        v = fmaf(pws[q][o_da + q3], xw, v);
      }
      a_wx[e] += v;
    }
    for (int e = threadIdx.x; e < u * g3; e += blockDim.x) {
      const int k = e / g3, q3 = e - k * g3;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kK2Warps; ++q) v = fmaf(pws[q][o_hp + k], pws[q][o_dgh + q3], v);
      a_wh[e] += v;
    }
    for (int e = threadIdx.x; e < g3; e += blockDim.x) {
      float vx = 0.0f, vh = 0.0f;
#pragma unroll
      for (int q = 0; q < kK2Warps; ++q) {
        vx += pws[q][o_da + e];
        vh += pws[q][o_dgh + e];
      }
      a_bx[e] += vx;
      a_bh[e] += vh;
    }
    for (int e = threadIdx.x; e < 2 * u + 2; e += blockDim.x) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kK2Warps; ++q) {
        const float d1 = pws[q][o_sc + 2];
        const float dl = (e & 1) ? d1 : -d1;
        v += e < 2 * u ? pws[q][o_hc + (e >> 1)] * dl : dl;
      }
      if (e < 2 * u) a_hw[e] += v; else a_hb[e - 2 * u] += v;
    }
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.x) * wfx;
  for (int e = threadIdx.x; e < wfx; e += blockDim.x) out[e] = acc[e];
}

// Sums the per-block partial gradients in block order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int blocks, int wfx) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= wfx) return;
  float v = 0.0f;
  for (int i = 0; i < blocks; ++i) v += partial[static_cast<int64_t>(i) * wfx + e];
  out[e] = v;
}

cudaError_t launch_sum_partials(const float* partial, float* out, int blocks, int wfx,
                                cudaStream_t stream) {
  sum_partials_kernel<<<(wfx + 255) / 256, 256, 0, stream>>>(partial, out, blocks, wfx);
  return cudaGetLastError();
}

}  // namespace rnnwf

// The floats of the per-block partial gradients rnnwf_gru_log_prob_bwd needs.
extern "C" long long rnnwf_gru_bwd_partial_floats(int b_total, int u) {
  using namespace rnnwf;
  return static_cast<long long>((b_total + kK2Warps - 1) / kK2Warps) * weight_floats_exact(u);
}

// hist: B*N*U floats of scratch; partial: rnnwf_gru_bwd_partial_floats(B, U)
// floats of scratch; out: weight_floats_exact(U) floats in the layout
// [wx | wh | bx | bh | head w | head b].
extern "C" int rnnwf_gru_log_prob_bwd(const void* samples, const void* g, const void* wx,
                                      const void* wh, const void* bx, const void* bh,
                                      const void* hw, const void* hb, void* hist,
                                      void* partial, void* out, int b_total, int n_sites,
                                      int u, void* stream) {
  using namespace rnnwf;
  const size_t smem = k2_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (b_total + kK2Warps - 1) / kK2Warps;
  gru_bwd_kernel<<<blocks, kK2Warps * kWarp, smem, st>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(g),
      static_cast<const float*>(wx), static_cast<const float*>(wh),
      static_cast<const float*>(bx), static_cast<const float*>(bh),
      static_cast<const float*>(hw), static_cast<const float*>(hb),
      static_cast<float*>(hist), static_cast<float*>(partial), b_total, n_sites, u);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_partials(static_cast<const float*>(partial),
                                              static_cast<float*>(out), blocks,
                                              weight_floats_exact(u), st));
}
