// Shared device code for the single-layer U(1) cRNN kernels (B7, B8, B10,
// B11 and B9's replay): the GRU trunk of gru_common.cuh with two 2-logit
// heads, and the per-site log-probabilities and phases of
// ops/fused_crnn.py::_crnn_site_rows.
//
// Layout: the weights keep the JAX package's parameter layout
// (models/crnn_u1.py): wx (2, 3U), wh (U, 3U), bx (3U), bh (3U), amplitude
// head w (U, 2), b (2), phase head w (U, 2), b (2).  The first six are the GRU
// kernels' layout, so Weights.hw/hb is the amplitude head and the phase head
// follows it.
//
// Numerics (all in log space, as the TPU kernel): lp0 = -softplus(-d),
// lp1 = -softplus(d), d = l0 - l1; under the U(1) mask, at sites 2n >= N a
// class is allowed while its count stays <= N/2 (heavyside with H(0) = 1 on
// N/2 - 1 - count), the allowed probabilities are renormalised with
// max(., 1e-30), and a forbidden class gets the finite LOG_ZERO - log norm2;
// the phase is pi * softsign.
#pragma once

#include "gru_common.cuh"

namespace rnnwf {

constexpr float kLogZero = -1e9f;
constexpr float kPi = 3.14159265358979f;

// Floats of the cRNN weight set: the exact count is the flat gradient's
// length; the padded one keeps the buffers after it 16-byte aligned.
__host__ __device__ inline int crnn_weight_floats_exact(int u) {
  return weight_floats_exact(u) + 2 * u + 2;
}
__host__ __device__ inline int crnn_weight_floats(int u) {
  return (crnn_weight_floats_exact(u) + 3) & ~3;
}

// Dynamic shared memory of each cRNN kernel at width u, defined beside the
// kernel and used both by its launch and by rnnwf_fits_shared_memory.
size_t exchange_base_smem_bytes(int u);
size_t exchange_suffix_smem_bytes(int u);
size_t exchange_suffix_rs_smem_bytes(int u);  // 0 past pad8(U) = 56

// The eight weight tensors as device pointers, in the layout order.
struct WeightPtrs {
  const float* p[8];
};

inline WeightPtrs weight_ptrs(const void* wx, const void* wh, const void* bx,
                              const void* bh, const void* aw, const void* ab,
                              const void* pw, const void* pb) {
  return {{static_cast<const float*>(wx), static_cast<const float*>(wh),
           static_cast<const float*>(bx), static_cast<const float*>(bh),
           static_cast<const float*>(aw), static_cast<const float*>(ab),
           static_cast<const float*>(pw), static_cast<const float*>(pb)}};
}

struct CWeights {
  Weights w;        // the trunk and the amplitude head (w.hw, w.hb)
  const float* pw;  // phase head (U, 2)
  const float* pb;  // phase head bias (2)
};

// Cooperative copy of the eight tensors into shared memory (whole block).
__device__ __forceinline__ CWeights load_crnn_weights(float* smem, const WeightPtrs& src,
                                                      int u) {
  const int g = 3 * u;
  const int sizes[8] = {2 * g, u * g, g, g, 2 * u, 2, 2 * u, 2};
  float* dst = smem;
  for (int a = 0; a < 8; ++a) {
    for (int i = threadIdx.x; i < sizes[a]; i += blockDim.x) dst[i] = src.p[a][i];
    dst += sizes[a];
  }
  __syncthreads();
  CWeights c;
  c.w = weights_at(smem, u);
  c.pw = c.w.hb + 2;
  c.pb = c.pw + 2 * u;
  return c;
}

__device__ __forceinline__ float softplusf_(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Site n's masked log-probabilities and phases from the two heads' logits
// (amplitude l0, l1; phase q0, q1); num_up counts the ups before site n.
__device__ __forceinline__ void crnn_logps(float l0, float l1, float q0, float q1, int n,
                                           float num_up, int n_sites, bool u1, float& lp0,
                                           float& lp1, float& ph0, float& ph1) {
  const float d = l0 - l1;
  lp0 = -softplusf_(-d);
  lp1 = -softplusf_(d);
  if (u1 && 2 * n >= n_sites) {
    const float baseline = static_cast<float>(n_sites / 2 - 1);
    const bool act_up = baseline - num_up >= 0.0f;
    const bool act_down = baseline - (static_cast<float>(n) - num_up) >= 0.0f;
    const float norm2 = fmaxf((act_down ? expf(lp0) : 0.0f) + (act_up ? expf(lp1) : 0.0f),
                              1e-30f);
    const float log_norm2 = logf(norm2);
    lp0 = (act_down ? lp0 : kLogZero) - log_norm2;
    lp1 = (act_up ? lp1 : kLogZero) - log_norm2;
  }
  ph0 = kPi * q0 / (1.0f + fabsf(q0));
  ph1 = kPi * q1 / (1.0f + fabsf(q1));
}

// The sampling decision of the cRNN samplers (ops/fused_crnn.py:216-222)
// from the amplitude logits, num_up counting the ups before site n: s = 1
// iff u >= p0, with p0 = sigmoid(l0 - l1), crnn_logps's exp(lp0) to float32
// rounding (renormalising two allowed classes leaves it as it is); under
// the mask a site whose down class is forbidden draws 1, one whose up class
// alone is forbidden 0, as the plain sampler's clamp does.  One tanhf: the
// logits' whole log-softmax is the books' work, off the decision's path.
__device__ __forceinline__ float crnn_decide(float uni, float l0, float l1, int n, float num_up,
                                             int n_sites, bool u1) {
  if (u1 && 2 * n >= n_sites) {
    const float baseline = static_cast<float>(n_sites / 2 - 1);
    if (baseline - (static_cast<float>(n) - num_up) < 0.0f) return 1.0f;
    if (baseline - num_up < 0.0f) return 0.0f;
  }
  return uni >= sigmoid_tanh(l0 - l1) ? 1.0f : 0.0f;
}

}  // namespace rnnwf
