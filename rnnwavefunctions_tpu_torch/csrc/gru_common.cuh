// Shared device code for the single-layer GRU kernels (K1-K4).
//
// Layout: the weights keep the JAX package's parameter layout
// (models/cells.py): wx (2, 3U), wh (U, 3U), bx (3U), bh (3U), head w (U, 2),
// head b (2), gates packed [r | z | c].  A block copies them once into shared
// memory in exactly this order, so the gradient kernel can accumulate into a
// buffer of the same layout and hand back one flat weight-shaped vector.
//
// Work split: every latency kernel (K1, K2's replay and reverse sweep,
// which B17, B9 and B20 run too, B5, B19, K3's base pass, the base pass of
// B7/B8/B10/B11 and B9's replay, and the MDRNN's sweep (B12, B13, B14's
// replay, B15/B16's base pass) and B14's reverse sweep, with two products
// per site) spreads each site's product over a block (slice_product below
// or its MDRNN form), and the flip and exchange suffixes run on the tensor
// cores (csrc/tfim_flip.cu, csrc/j1j2_exchange.cu).
//
// Numerics: precise expf/tanhf/logf (never built with --use_fast_math); the
// Kahan pairs are written so that no reassociation applies.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rnnwf {

constexpr int kWarp = 32;

// Floats of one weight set in shared memory, padded to a multiple of 4 so
// the per-warp buffers that follow stay 16-byte aligned.
__host__ __device__ inline int weight_floats(int u) {
  const int g = 3 * u;
  const int n = 2 * g + u * g + 2 * g + 2 * u + 2;
  return (n + 3) & ~3;
}

// The unpadded count: the length of the flat gradient vector.
__host__ __device__ inline int weight_floats_exact(int u) {
  const int g = 3 * u;
  return 2 * g + u * g + 2 * g + 2 * u + 2;
}

// Dynamic shared memory of each kernel at width u, defined beside the kernel
// and used both by its launch and by rnnwf_fits_shared_memory.
size_t k2_smem_bytes(int u);       // K2's reverse sweep (also B17's) and weight cotangent
size_t crnn_sweep_smem_bytes(int u);  // the reverse sweep of B9 and B20 (csrc/fused_gru_bwd.cu)
size_t flip_base_smem_bytes(int u);
size_t flip_suffix_smem_bytes(int u);     // K3/K4/B6's first suffix pass (past U = 56)
size_t flip_suffix_rs_smem_bytes(int u);  // the turned-around one (0 past U = 56)
size_t rollout_smem_bytes(int u);  // B19 (csrc/fused_jac.cu)

struct Weights {
  const float* wx;  // (2, 3U)
  const float* wh;  // (U, 3U)
  const float* bx;  // (3U)
  const float* bh;  // (3U)
  const float* hw;  // (U, 2)
  const float* hb;  // (2)
};

__device__ __forceinline__ Weights weights_at(const float* base, int u) {
  const int g = 3 * u;
  Weights w;
  w.wx = base;
  w.wh = w.wx + 2 * g;
  w.bx = w.wh + u * g;
  w.bh = w.bx + g;
  w.hw = w.bh + g;
  w.hb = w.hw + 2 * u;
  return w;
}

// Cooperative copy of the six weight tensors into shared memory (whole block).
__device__ __forceinline__ Weights load_weights(
    float* smem, const float* wx, const float* wh, const float* bx,
    const float* bh, const float* hw, const float* hb, int u) {
  const int g = 3 * u;
  const int sizes[6] = {2 * g, u * g, g, g, 2 * u, 2};
  const float* srcs[6] = {wx, wh, bx, bh, hw, hb};
  float* dst = smem;
  for (int a = 0; a < 6; ++a) {
    for (int i = threadIdx.x; i < sizes[a]; i += blockDim.x) dst[i] = srcs[a][i];
    dst += sizes[a];
  }
  __syncthreads();
  return weights_at(smem, u);
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log-softmax probability of target s in {0, 1} over two logits
// (ops/fused_gru.py::_logp_rows).
__device__ __forceinline__ float logp2(float l0, float l1, float s) {
  const float m = fmaxf(l0, l1);
  const float lse = m + logf(expf(l0 - m) + expf(l1 - m));
  return (s > 0.5f ? l1 : l0) - lse;
}

// One compensated add (ops/compsum.py::kadd).
__device__ __forceinline__ void kadd(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Loads h[k*T + t] for t < T (one 8- or 16-byte broadcast load when T is 2
// or 4).
template <int T>
__device__ __forceinline__ void load_h(const float* h, int k, float (&out)[T]) {
  if constexpr (T == 4) {
    const float4 v = reinterpret_cast<const float4*>(h)[k];
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (T == 2) {
    const float2 v = reinterpret_cast<const float2*>(h)[k];
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) out[t] = h[k * T + t];
  }
}

// ---- The latency kernels (B19 in csrc/fused_jac.cu; K1, K2's replay, K3's
// base pass and B5 in csrc/tfim_flip.cu) advance the P samples of a block
// one site at a time with the site's 3U x U product spread over the whole
// block: thread (ks, j) of kSlices x U32 threads (U32 = U rounded up to a
// warp) sums the terms of hidden unit j over the ks-th quarter of k for
// the P samples (a chain a quarter as deep as one thread's would be), the
// partial sums meet in shared memory, and after a barrier thread (p, j) of
// the first P slices adds them in slice order and updates unit j of
// sample p.  The states sit in
// shared memory as h[k*P + p] (one broadcast load of h[k] feeds P
// samples); a warp's loads wh[k, j], wh[k, U+j], wh[k, 2U+j] are
// consecutive (conflict-free).
constexpr int kSlices = 4;

__host__ __device__ inline int warp_round(int u) { return (u + kWarp - 1) / kWarp * kWarp; }

// Floats of the partial sums: [slice][gate][U32][P].
__host__ __device__ inline int slice_part_floats(int u, int p) {
  return kSlices * 3 * warp_round(u) * p;
}

// The logistic function as 0.5 tanh(x/2) + 0.5 (precise tanhf): the same
// value as 1 / (1 + exp(-x)) to float32 rounding, and without the division's
// slow-path branch, which would keep the compiler from interleaving
// independent gates.
__device__ __forceinline__ float sigmoid_tanh(float x) {
  return fmaf(0.5f, tanhf(0.5f * x), 0.5f);
}

// Slice ks of unit j's three gate sums for the P samples into part.
template <int P>
__device__ __forceinline__ void slice_product(const Weights& w, int u, int ks, int j,
                                              const float* h, float* part) {
  const int g = 3 * u, u32 = warp_round(u);
  const int kc = (u + kSlices - 1) / kSlices, k1 = min(u, (ks + 1) * kc);
  float a[3][P];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int p = 0; p < P; ++p) a[q][p] = 0.0f;
#pragma unroll 4
  for (int k = ks * kc; k < k1; ++k) {
    const float* wk = w.wh + k * g;
    const float wq[3] = {wk[j], wk[u + j], wk[2 * u + j]};
    float hk[P];
    load_h<P>(h, k, hk);
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int p = 0; p < P; ++p) a[q][p] = fmaf(hk[p], wq[q], a[q][p]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int p = 0; p < P; ++p) part[((ks * 3 + q) * u32 + j) * P + p] = a[q][p];
}

// Unit j's gates and new state for one sample (K2's replay stores the
// gates; the other sweeps keep only h).
struct GateStep {
  float h, r, z, c, ghc;  // ghc = (h_{n-1} W_h)_c + bh_c, the reset gate's operand
};

// Unit j's update for sample p from the slices' sums (added in slice
// order); xt is the sample's previous spin (0/1) and xscale is 0 at site 0.
template <int P>
__device__ __forceinline__ GateStep slice_update(const Weights& w, int u, int j, int p,
                                                 const float* h, const float* part, float xt,
                                                 float xscale) {
  const int g = 3 * u, u32 = warp_round(u);
  float a[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    a[q] = part[(q * u32 + j) * P + p];
#pragma unroll
    for (int ks = 1; ks < kSlices; ++ks) a[q] += part[((ks * 3 + q) * u32 + j) * P + p];
  }
  const float gxr = xscale * ((1.0f - xt) * w.wx[j] + xt * w.wx[g + j]) + w.bx[j];
  const float gxz = xscale * ((1.0f - xt) * w.wx[u + j] + xt * w.wx[g + u + j]) + w.bx[u + j];
  const float gxc =
      xscale * ((1.0f - xt) * w.wx[2 * u + j] + xt * w.wx[g + 2 * u + j]) + w.bx[2 * u + j];
  const float r = sigmoid_tanh(gxr + (a[0] + w.bh[j]));
  const float z = sigmoid_tanh(gxz + (a[1] + w.bh[u + j]));
  const float ghc = a[2] + w.bh[2 * u + j];
  const float c = tanhf(gxc + r * ghc);
  return {z * h[j * P + p] + (1.0f - z) * c, r, z, c, ghc};
}

// Sums per-block partial gradients (blocks x wfx floats) in block order into
// out (wfx floats); defined in fused_gru_bwd.cu, shared by K2, B9 and B14.
cudaError_t launch_sum_partials(const float* partial, float* out, int blocks, int wfx,
                                cudaStream_t stream);

// ---- The reverse sweep of K2's stage b (csrc/fused_gru_bwd.cu), one kernel
// for its three seeds and outputs:
//   kGru    K2 and B17: the head's dl1 = g (s - p1) seeds h_n through
//           hw[:, 1] - hw[:, 0]; writes K2's C rows (4U + 1 columns);
//   kCrnn   B9: the cRNN's two heads, seeded per site by the replay's a_n
//           (the amplitude head's dd at g_re = 1) and q_n (the phase seed on
//           the target's logit); writes C rows of 4U + 3 columns;
//   kDouts  B20: given cotangents on h_n for each of P parts; writes dg
//           (P, B, N, 4U) in the JAX order [da_r | da_z | da_c | dgh_c].
enum class Sweep { kGru, kCrnn, kDouts };

struct SweepArgs {
  const int32_t* samples;  // (B, N)
  const float* wh;         // (U, 3U)
  const float* hw;         // (U, 2) K2's head; the cRNN's amplitude head
  const float* pw;         // (U, 2) the cRNN's phase head (kCrnn)
  const float* g;          // (B,) K2's cotangent; the cRNN's g_re
  const float* g_im;       // (B,) (kCrnn)
  const float* rows;       // (B, N + 1, U + 3) K2's A rows (kGru, kCrnn)
  const float* hist;       // (B, N, U) the states h_n (kDouts)
  const float* gates;      // (B, N, 4U) [r | z | c | ghc]
  const float* seeds;      // kGru: p1 (B, N); kCrnn: [a_n, q_n] (B, N, 2)
  const float* douts;      // (P, B, N, U) (kDouts)
  float* out;              // C (B, N + 1, 4U + 1 or 4U + 3) or dg (P, B, N, 4U)
  int b_total, parts, n_sites, u;  // parts: 1 but for kDouts
};

cudaError_t launch_reverse_sweep(Sweep mode, const SweepArgs& args, cudaStream_t st);

// Stage c: the weight cotangent A^T C over the B (N + 1) rows of A (U + 3
// columns) and C (4U + 2 heads - 1 columns), in chunks summed in chunk order
// into out (the flat gradient of one GRU layer and `heads` 2-logit heads);
// partial: weight_cotangent_partial_floats floats of scratch.
int64_t weight_cotangent_partial_floats(int b_total, int n_sites, int u, int heads);
cudaError_t launch_weight_cotangent(const float* a_rows, const float* c_rows, float* partial,
                                    float* out, int b_total, int n_sites, int u, int heads,
                                    cudaStream_t st);

// Philox4x32-10 (Salmon et al., SC'11): counter-based, so a uniform depends
// only on (key, counter) and not on how the work was split into blocks.
__device__ __forceinline__ uint32_t philox_x(uint32_t c0, uint32_t c1, uint32_t c2,
                                             uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// Uniform in [0, 1) on the 2^-23 grid from the top 23 bits, the role of the
// TPU kernels' ``uni`` (ops/tfim_flip_kernel.py:299-305): s = 1 iff u >= p0.
__device__ __forceinline__ float uniform23(uint32_t seed, uint32_t offset,
                                           uint32_t sample, uint32_t site) {
  const uint32_t bits = philox_x(sample, site, 0u, 0u, seed, offset);
  return static_cast<float>(bits >> 9) * (1.0f / 8388608.0f);
}

}  // namespace rnnwf
