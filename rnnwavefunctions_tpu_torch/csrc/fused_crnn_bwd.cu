// B9: the VJP of sum_b (g_re[b] Re log psi_b + g_im[b] Im log psi_b) with
// respect to every weight of the single-layer U(1) cRNN and its two heads.
//
// Replaces: rnnwavefunctions_tpu/ops/fused_crnn_bwd.py::crnn_log_amp_bwd
// (_make_bwd_kernel over fused_gru_bwd.run_history_bptt), the backward half
// of the J1-J2 loss gradient.
//
// Bound on the H100: as K2's (fused_gru_bwd.cu), latency of the two
// sequential site sweeps plus the per-site block-wide accumulation of the
// 3U x U weight cotangent out of shared memory; the (B, N, U) history the
// reverse sweep reads is 10 MB at B=500, N=100, U=50 and stays in L2.
//
// Design: K2's, with the cRNN's heads and mask.  One warp per sample, four
// samples per block; the forward replay writes each sample's hidden history
// to device memory; the reverse sweep recomputes both heads from h_n and the
// gates from h_{n-1}.  Per site (math in ops/fused_crnn_bwd.py:11-25):
//   amplitude: dlp_t = 0.5 g_re [s == t]; under the U(1) mask at 2n >= N,
//     dlp_t <- dlp_t act_t - (dlp0 + dlp1) [raw > 1e-30] act_t p_t / norm2,
//     p_t the unmasked softmax, act_t the heavyside of the class;
//     dd = dlp0 p1 - dlp1 p0 is the cotangent of d = l0 - l1;
//   phase: dq_t = g_im [s == t] pi / (1 + |q_t|)^2;
//   trunk: dh_n += (aw[:,0] - aw[:,1]) dd + pw dq, then K2's GRU step.
// The mask's up-counts are data: the sweep walks them down from the sample's
// total (count before n = count before n+1 - s_n).  Each thread owns fixed
// gradient entries and adds the block's four samples in a fixed order; each
// block writes a partial and a second launch sums them in block order, so
// the result is the same on every run.  The second head adds 2U+2 weights
// and accumulators to shared memory, so this kernel bounds the cRNN's width
// (rnnwf_fits_shared_memory).
#include "crnn_common.cuh"

namespace rnnwf {

constexpr int kB9Warps = 4;

__host__ __device__ inline int b9_warp_floats(int u) { return 13 * u + 8; }

size_t b9_smem_bytes(int u) {
  return sizeof(float) * (2 * crnn_weight_floats(u) + kB9Warps * b9_warp_floats(u));
}

__global__ void crnn_bwd_kernel(const int32_t* __restrict__ samples,
                                const float* __restrict__ gre_in,
                                const float* __restrict__ gim_in, WeightPtrs wp,
                                float* __restrict__ hist, float* __restrict__ partial,
                                int b_total, int n_sites, int u, int u1) {
  extern __shared__ __align__(16) float smem[];
  const CWeights c = load_crnn_weights(smem, wp, u);
  const Weights& w = c.w;
  const int g3 = 3 * u;
  const int wf = crnn_weight_floats(u), wfx = crnn_weight_floats_exact(u);
  float* acc = smem + wf;
  for (int e = threadIdx.x; e < wfx; e += blockDim.x) acc[e] = 0.0f;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kB9Warps + warp;
  const bool valid = b < b_total;
  float* pw = smem + 2 * wf + warp * b9_warp_floats(u);
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
  const float gre = valid ? gre_in[b] : 0.0f;
  const float gim = valid ? gim_in[b] : 0.0f;
  const int32_t* s_row = samples + static_cast<int64_t>(valid ? b : 0) * n_sites;
  float* h_row = hist + static_cast<int64_t>(valid ? b : 0) * n_sites * u;

  // ---- forward replay: store h_n for every site, count the ups
  float cnt = 0.0f;
  if (valid) {
    for (int j = lane; j < u; j += kWarp) h[j] = 0.0f;
    __syncwarp();
    float x[1] = {0.0f}, l0[1], l1[1];
    for (int n = 0; n < n_sites; ++n) {
      gru_site<1>(w, u, h, hn, x, n > 0 ? 1.0f : 0.0f, l0, l1, lane);
      for (int j = lane; j < u; j += kWarp) h_row[n * u + j] = hn[j];
      x[0] = static_cast<float>(s_row[n]);
      cnt += x[0];
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

    // both heads from h_n
    float a0 = 0.0f, a1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
    for (int j = lane; j < u; j += kWarp) {
      a0 = fmaf(hc[j], w.hw[2 * j], a0);
      a1 = fmaf(hc[j], w.hw[2 * j + 1], a1);
      q0 = fmaf(hc[j], c.pw[2 * j], q0);
      q1 = fmaf(hc[j], c.pw[2 * j + 1], q1);
    }
    const float d = (warp_sum(a0) + w.hb[0]) - (warp_sum(a1) + w.hb[1]);
    const float ql0 = warp_sum(q0) + c.pb[0];
    const float ql1 = warp_sum(q1) + c.pb[1];
    const float p0r = sigmoidf_(d), p1r = sigmoidf_(-d);

    // amplitude head and the U(1) renormalisation chain
    const float glp = 0.5f * gre;
    float dlp0 = glp * (1.0f - s_n), dlp1 = glp * s_n;
    const float num_up = cnt - s_n;  // ups before site n
    if (u1 && 2 * n >= n_sites) {
      const float baseline = static_cast<float>(n_sites / 2 - 1);
      const float act_up = baseline - num_up >= 0.0f ? 1.0f : 0.0f;
      const float act_down = baseline - (static_cast<float>(n) - num_up) >= 0.0f ? 1.0f : 0.0f;
      const float raw = act_down * p0r + act_up * p1r;
      const float norm2 = fmaxf(raw, 1e-30f);
      const float clamp = raw > 1e-30f ? 1.0f : 0.0f;
      const float gsum = (dlp0 + dlp1) * clamp / norm2;
      const float m0 = dlp0 * act_down - gsum * act_down * p0r;
      const float m1 = dlp1 * act_up - gsum * act_up * p1r;
      dlp0 = m0;
      dlp1 = m1;
    }
    cnt = num_up;
    const float dd = dlp0 * p1r - dlp1 * p0r;
    // phase head
    const float den0 = 1.0f + fabsf(ql0), den1 = 1.0f + fabsf(ql1);
    const float dq0 = gim * (1.0f - s_n) * kPi / (den0 * den0);
    const float dq1 = gim * s_n * kPi / (den1 * den1);

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
      const float cc = tanhf(gxc + r * ghc);

      const float dtop = (w.hw[2 * j] - w.hw[2 * j + 1]) * dd + c.pw[2 * j] * dq0 +
                         c.pw[2 * j + 1] * dq1;
      const float dht = dh[j] + dtop;
      const float dz = dht * (hp[j] - cc);
      const float dc = dht * (1.0f - z);
      const float dac = dc * (1.0f - cc * cc);
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
      float dsum = 0.0f;
      for (int q = 0; q < g3; ++q) dsum = fmaf(wk[q], dgh[q], dsum);
      dh[k] = dhs[k] * zb[k] + dsum;
    }
    if (lane == 0) { sc[0] = xr; sc[1] = xs; sc[2] = dd; sc[3] = dq0; sc[4] = dq1; }
    __syncthreads();

    // ---- block accumulation: thread-owned entries, fixed sample order
    const float* pws[kB9Warps];
#pragma unroll
    for (int q = 0; q < kB9Warps; ++q) pws[q] = smem + 2 * wf + q * b9_warp_floats(u);
    // offsets of each per-warp buffer inside pws[q]
    const int o_hc = 3 * u, o_hp = 2 * u, o_da = 7 * u, o_dgh = 7 * u + g3, o_sc = 7 * u + 2 * g3;
    float* a_wx = acc;
    float* a_wh = a_wx + 2 * g3;
    float* a_bx = a_wh + u * g3;
    float* a_bh = a_bx + g3;
    float* a_aw = a_bh + g3;
    float* a_pw = a_aw + 2 * u + 2;  // after the amplitude head's w and b
    for (int e = threadIdx.x; e < 2 * g3; e += blockDim.x) {
      const int row = e / g3, q3 = e - row * g3;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kB9Warps; ++q) {
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
      for (int q = 0; q < kB9Warps; ++q) v = fmaf(pws[q][o_hp + k], pws[q][o_dgh + q3], v);
      a_wh[e] += v;
    }
    for (int e = threadIdx.x; e < g3; e += blockDim.x) {
      float vx = 0.0f, vh = 0.0f;
#pragma unroll
      for (int q = 0; q < kB9Warps; ++q) {
        vx += pws[q][o_da + e];
        vh += pws[q][o_dgh + e];
      }
      a_bx[e] += vx;
      a_bh[e] += vh;
    }
    // the two heads: (U, 2) weight then (2) bias each; amplitude logit
    // cotangents (dd, -dd), phase logit cotangents (dq0, dq1)
    for (int e = threadIdx.x; e < 2 * (2 * u + 2); e += blockDim.x) {
      const bool phase = e >= 2 * u + 2;
      const int f = phase ? e - (2 * u + 2) : e;
      const int cls = f < 2 * u ? (f & 1) : f - 2 * u;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kB9Warps; ++q) {
        const float* sq = pws[q] + o_sc;
        const float dl = phase ? sq[3 + cls] : (cls ? -sq[2] : sq[2]);
        v += f < 2 * u ? pws[q][o_hc + (f >> 1)] * dl : dl;
      }
      (phase ? a_pw : a_aw)[f] += v;
    }
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.x) * wfx;
  for (int e = threadIdx.x; e < wfx; e += blockDim.x) out[e] = acc[e];
}

}  // namespace rnnwf

// The floats of the per-block partial gradients rnnwf_crnn_log_amp_bwd needs.
extern "C" long long rnnwf_crnn_bwd_partial_floats(int b_total, int u) {
  using namespace rnnwf;
  return static_cast<long long>((b_total + kB9Warps - 1) / kB9Warps) *
         crnn_weight_floats_exact(u);
}

// hist: B*N*U floats of scratch; partial: rnnwf_crnn_bwd_partial_floats(B, U)
// floats of scratch; out: crnn_weight_floats_exact(U) floats in the layout
// [wx | wh | bx | bh | ampl w | ampl b | phase w | phase b].
extern "C" int rnnwf_crnn_log_amp_bwd(const void* samples, const void* g_re, const void* g_im,
                                      const void* wx, const void* wh, const void* bx,
                                      const void* bh, const void* aw, const void* ab,
                                      const void* pw, const void* pb, void* hist,
                                      void* partial, void* out, int b_total, int n_sites,
                                      int u, int u1, void* stream) {
  using namespace rnnwf;
  const size_t smem = b9_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(
      crnn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (b_total + kB9Warps - 1) / kB9Warps;
  crnn_bwd_kernel<<<blocks, kB9Warps * kWarp, smem, st>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(g_re),
      static_cast<const float*>(g_im), weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb),
      static_cast<float*>(hist), static_cast<float*>(partial), b_total, n_sites, u, u1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_partials(static_cast<const float*>(partial),
                                              static_cast<float*>(out), blocks,
                                              crnn_weight_floats_exact(u), st));
}
