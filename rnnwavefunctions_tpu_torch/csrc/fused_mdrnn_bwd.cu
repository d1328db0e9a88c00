// B14: the VJP of sum_b g_b log p(sigma_b) with respect to every weight of
// the 2D MDRNN cell and its 2-logit head.
//
// Replaces: rnnwavefunctions_tpu/ops/fused_mdrnn_bwd.py::mdrnn_log_prob_bwd
// (_make_bwd_kernel), the backward half of the loss gradient.
//
// Bound on the H100: latency of the two sequential sweeps over NS sites
// (forward replay, then the reverse sweep), each site a few dependent U x U
// products out of shared memory, plus the per-site outer-product updates of
// the two U x U weight cotangents.  The history the reverse sweep reads is
// B*NS*U floats (25.6 MB at B=500, 16x16, U=50): it stays in L2.
//
// Design: one warp per sample, four samples per block.  The forward replay
// (the sweep of fused_mdrnn.cu) writes each sample's (NS, U) cell-output
// history in visit order.  The reverse sweep walks m = NS-1..0 (math in
// fused_mdrnn_bwd.py:12-20 of the JAX package):
//   dlogit_1 = g (s - p1) = -dlogit_0,
//   dh = (hw[:,1] - hw[:,0]) dlogit_1 + (horizontal carry from m+1, same row)
//        + (vertical cotangent from the site below, per-column buffer),
//   dpre = dh * elu'(pre), elu'(pre) = 1 if h > 0 else h + 1 (from h),
//   carry to m-1 = Wh dpre (k > 0); column buffer for the site above = Wv dpre.
// The per-site vectors of the block's samples meet in shared memory and
// every thread owns a fixed set of weight-cotangent entries that it updates
// in a fixed sample order: no atomics.  Where the TPU grid added every tile
// into one output in turn, each block writes its partial gradient and a
// second kernel sums the partials in block order (as K2).
#include "mdrnn_common.cuh"

namespace rnnwf {

constexpr int kMBwdWarps = 4;

// Per warp: the column buffer (Nx*U), h, hh, hv, dpre, the horizontal
// carry (U each) and 8 scalars.
__host__ __device__ inline int mdrnn_bwd_warp_floats(int nx, int u) {
  return ((nx + 5) * u + 8 + 3) & ~3;
}

size_t mdrnn_bwd_smem_bytes(int nx, int u) {
  return sizeof(float) *
         (2 * mdrnn_weight_floats(u) + kMBwdWarps * mdrnn_bwd_warp_floats(nx, u));
}

__global__ void mdrnn_bwd_kernel(const int32_t* __restrict__ samples,
                                 const float* __restrict__ g_in, MWeightPtrs src,
                                 float* __restrict__ hist, float* __restrict__ partial,
                                 int b_total, int nx, int ny, int u) {
  extern __shared__ __align__(16) float smem[];
  const MWeights w = load_mdrnn_weights(smem, src, u);
  const int wf = mdrnn_weight_floats(u), wfx = mdrnn_weight_floats_exact(u);
  float* acc = smem + wf;
  for (int e = threadIdx.x; e < wfx; e += blockDim.x) acc[e] = 0.0f;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kMBwdWarps + warp;
  const bool valid = b < b_total;
  const int ns = nx * ny;
  const int wpf = mdrnn_bwd_warp_floats(nx, u);
  float* pw = smem + 2 * wf + warp * wpf;
  float* dv = pw;          // (Nx, U): replay row, then vertical cotangents
  float* h = dv + nx * u;  // replay hn, then h_m
  float* hh = h + u;
  float* hv = hh + u;
  float* dpre = hv + u;
  float* dhc = dpre + u;
  float* sc = dhc + u;     // x_h, x_v, has_h, has_v, dlogit_1
  const float gb = valid ? g_in[b] : 0.0f;
  const int32_t* s_lat = samples + static_cast<int64_t>(valid ? b : 0) * ns;
  float* h_row = hist + static_cast<int64_t>(valid ? b : 0) * ns * u;

  // ---- forward replay: store h_m for every visit position
  if (valid) {
    float xh[1] = {0.0f}, xv[1] = {0.0f}, l0[1], l1[1];
    int x_prev = 0;
    for (int m = 0; m < ns; ++m) {
      const int y = m / nx, k = m - y * nx;
      const int x = (y & 1) ? nx - 1 - k : k;
      const float* hhp = k > 0 ? dv + x_prev * u : nullptr;
      const float* hvp = y > 0 ? dv + x * u : nullptr;
      xv[0] = y > 0 ? static_cast<float>(s_lat[x * ny + y - 1]) : 0.0f;
      mdrnn_site<1>(w, u, hhp, xh, hvp, xv, h, l0, l1, lane);
      for (int j = lane; j < u; j += kWarp) {
        dv[x * u + j] = h[j];
        h_row[static_cast<int64_t>(m) * u + j] = h[j];
      }
      __syncwarp();
      xh[0] = static_cast<float>(s_lat[x * ny + y]);
      x_prev = x;
    }
  }
  for (int j = lane; j < nx * u; j += kWarp) dv[j] = 0.0f;
  for (int j = lane; j < u; j += kWarp) dhc[j] = 0.0f;
  __syncthreads();

  float* a_uh = acc;
  float* a_uv = a_uh + 2 * u;
  float* a_wh = a_uv + 2 * u;
  float* a_wv = a_wh + u * u;
  float* a_b = a_wv + u * u;
  float* a_hw = a_b + u;
  float* a_hb = a_hw + 2 * u;
  const int o_h = nx * u, o_hh = o_h + u, o_hv = o_hh + u, o_dpre = o_hv + u,
            o_sc = o_dpre + 2 * u;

  // ---- reverse sweep
  for (int m = ns - 1; m >= 0; --m) {
    const int y = m / nx, k = m - y * nx;
    const int x = (y & 1) ? nx - 1 - k : k;
    const int up = m - 2 * k - 1;
    float xh = 0.0f, xv = 0.0f, s = 0.0f;
    if (valid) {
      for (int j = lane; j < u; j += kWarp) {
        h[j] = h_row[static_cast<int64_t>(m) * u + j];
        hh[j] = k > 0 ? h_row[static_cast<int64_t>(m - 1) * u + j] : 0.0f;
        hv[j] = y > 0 ? h_row[static_cast<int64_t>(up) * u + j] : 0.0f;
      }
      if (k > 0) xh = spin_at(s_lat, m - 1, nx, ny);
      if (y > 0) xv = static_cast<float>(s_lat[x * ny + y - 1]);
      s = static_cast<float>(s_lat[x * ny + y]);
    } else {
      for (int j = lane; j < u; j += kWarp) { h[j] = 0.0f; hh[j] = 0.0f; hv[j] = 0.0f; }
    }
    __syncwarp();

    // head: logits from h_m, dlogit_1 = g (s - p1) = -dlogit_0
    float p0 = 0.0f, p1 = 0.0f;
    for (int j = lane; j < u; j += kWarp) {
      p0 = fmaf(h[j], w.hw[2 * j], p0);
      p1 = fmaf(h[j], w.hw[2 * j + 1], p1);
    }
    const float l0 = warp_sum(p0) + w.hb[0];
    const float l1 = warp_sum(p1) + w.hb[1];
    const float dl1 = gb * (s - sigmoidf_(l1 - l0));

    for (int j = lane; j < u; j += kWarp) {
      float dh = (w.hw[2 * j + 1] - w.hw[2 * j]) * dl1;
      if (k < nx - 1) dh += dhc[j];
      if (y < ny - 1) dh += dv[x * u + j];
      dpre[j] = dh * (h[j] > 0.0f ? 1.0f : h[j] + 1.0f);
    }
    __syncwarp();
    // carries: to m-1 (same row) through Wh, to the site above through Wv
    for (int q = lane; q < u; q += kWarp) {
      float ch = 0.0f, cv = 0.0f;
      const float* whq = w.wh + q * u;
      const float* wvq = w.wv + q * u;
      for (int j = 0; j < u; ++j) {
        ch = fmaf(whq[j], dpre[j], ch);
        cv = fmaf(wvq[j], dpre[j], cv);
      }
      dhc[q] = k > 0 ? ch : 0.0f;
      dv[x * u + q] = y > 0 ? cv : 0.0f;
    }
    if (lane == 0) {
      sc[0] = xh; sc[1] = xv; sc[2] = k > 0 ? 1.0f : 0.0f; sc[3] = y > 0 ? 1.0f : 0.0f;
      sc[4] = dl1;
    }
    __syncthreads();

    // ---- block accumulation: thread-owned entries, fixed sample order
    const float* pws[kMBwdWarps];
#pragma unroll
    for (int q = 0; q < kMBwdWarps; ++q) pws[q] = smem + 2 * wf + q * wpf;
    for (int e = threadIdx.x; e < 4 * u; e += blockDim.x) {
      const int vert = e >= 2 * u;            // uv rows follow the uh rows
      const int r = (e / u) & 1, j = e % u;
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kMBwdWarps; ++q) {
        const float* sq = pws[q] + o_sc;
        const float xs = vert ? sq[1] : sq[0];
        const float on = vert ? sq[3] : sq[2];
        v = fmaf(pws[q][o_dpre + j], on * (r == 0 ? 1.0f - xs : xs), v);
      }
      a_uh[e] += v;  // a_uv = a_uh + 2u
    }
    for (int e = threadIdx.x; e < u * u; e += blockDim.x) {
      const int q3 = e / u, j = e - q3 * u;
      float vh = 0.0f, vv = 0.0f;
#pragma unroll
      for (int q = 0; q < kMBwdWarps; ++q) {
        const float d = pws[q][o_dpre + j];
        vh = fmaf(pws[q][o_hh + q3], d, vh);
        vv = fmaf(pws[q][o_hv + q3], d, vv);
      }
      a_wh[e] += vh;
      a_wv[e] += vv;
    }
    for (int e = threadIdx.x; e < 3 * u + 2; e += blockDim.x) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < kMBwdWarps; ++q) {
        if (e < u) {
          v += pws[q][o_dpre + e];
        } else {
          const int c = e - u;  // head w (U, 2) entries, then head b (2)
          const float d1 = pws[q][o_sc + 4];
          const float dl = (c & 1) ? d1 : -d1;
          v += c < 2 * u ? pws[q][o_h + (c >> 1)] * dl : dl;
        }
      }
      if (e < u) a_b[e] += v;
      else if (e - u < 2 * u) a_hw[e - u] += v;
      else a_hb[e - 3 * u] += v;
    }
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.x) * wfx;
  for (int e = threadIdx.x; e < wfx; e += blockDim.x) out[e] = acc[e];
}

}  // namespace rnnwf

// The floats of the per-block partial gradients rnnwf_mdrnn_log_prob_bwd needs.
extern "C" long long rnnwf_mdrnn_bwd_partial_floats(int b_total, int u) {
  using namespace rnnwf;
  return static_cast<long long>((b_total + kMBwdWarps - 1) / kMBwdWarps) *
         mdrnn_weight_floats_exact(u);
}

// hist: B*NS*U floats of scratch; partial: rnnwf_mdrnn_bwd_partial_floats(B, U)
// floats of scratch; out: mdrnn_weight_floats_exact(U) floats in the layout
// [uh | uv | wh | wv | b | head w | head b].
extern "C" int rnnwf_mdrnn_log_prob_bwd(const void* samples, const void* g, const void* uh,
                                        const void* uv, const void* wh, const void* wv,
                                        const void* b, const void* hw, const void* hb,
                                        void* hist, void* partial, void* out, int b_total,
                                        int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  const size_t smem = mdrnn_bwd_smem_bytes(nx, u);
  cudaError_t err = cudaFuncSetAttribute(
      mdrnn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (b_total + kMBwdWarps - 1) / kMBwdWarps;
  mdrnn_bwd_kernel<<<blocks, kMBwdWarps * kWarp, smem, st>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(g),
      mweight_ptrs(uh, uv, wh, wv, b, hw, hb), static_cast<float*>(hist),
      static_cast<float*>(partial), b_total, nx, ny, u);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_partials(static_cast<const float*>(partial),
                                              static_cast<float*>(out), blocks,
                                              mdrnn_weight_floats_exact(u), st));
}
