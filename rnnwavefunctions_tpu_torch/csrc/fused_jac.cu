// B19 and B20: the per-sample jacobian sweeps of minSR for the cRNN's
// single GRU layer (the rows O of d log psi / d theta, one per sample, never
// reduced over the batch).  B17 (the pRNN's sweep) runs K2's stages a and
// b (csrc/tfim_flip.cu, csrc/fused_gru_bwd.cu; ops/fused_jac.py).
//
// Replaces: rnnwavefunctions_tpu/ops/fused_jac.py::rollout_hist (B19) and
// ::sweep_dgates (B20).
//
// What they compute, per sample s and site n, in sample-major layouts:
//   B19  hist[s, n, :], the post-step hidden state h_n (S, N, U); storing,
//        also the gates [r | z | c | ghc] of each site (S, N, 4U);
//   B20  for each part p, from the cotangent dout[p, s, n, :] on h_n, the
//        reverse sweep's gate cotangents dg[p, s, n, :] = [da_r | da_z | da_c |
//        dgh_c] (S, N, 4U): da are the cotangents of the three input
//        pre-activations, and the recurrent ones are [da_r | da_z | dgh_c]
//        (the two share their first 2U entries, so 4U are stored, not 6U).
// ops/fused_jac.py contracts them into the per-sample weight rows.
//
// Bound on the H100: latency of the sequential site sweeps per sample, one
// 3U x U product per site on each; then the bytes: per (sample, site) B19
// storing writes 5U floats, and B20 reads them and two parts' 2U of dout
// and writes 8U, 200 MB in all at the flagship shape (S=500, N=100, U=50),
// 0.06 ms at the memory rate.
//
// B19 is built as K3's base pass (csrc/tfim_flip.cu): a block per kRollP
// samples whose kSlices x U32 threads split each site's 3U x U product by
// unit and by quarter of k (slice_product, gru_common.cuh), the first kRollP
// slices update one sample each, two barriers per site, and h_n (storing,
// and the gates from slice_update) stored coalesced along the sample's row.
//
// B20 is K2's reverse sweep seeded by the given cotangents (Sweep::kDouts,
// csrc/fused_gru_bwd.cu): a block per sample whose first two slices carry
// its Re and Im parts, which share the sample's loads of the stored gates
// and of h_{n-1}; per site dht = dh + dout, K2's gate cotangents, and one
// W_h dgh product over 4 k-slices with W_h's quarter in each thread's
// registers.  It writes dg and accumulates nothing across samples.  A call
// with another number of parts takes two (sample, part) trajectories a
// block, the last block padded.
#include "gru_common.cuh"

namespace rnnwf {

constexpr int kRollP = 2;  // samples per B19 block
static_assert(kRollP <= kSlices, "a B19 block's first slices update one sample each");

// B19: the weights, h and hn (kRollP*U floats each), the slices' sums.
size_t rollout_smem_bytes(int u) {
  return sizeof(float) * (weight_floats(u) + 2 * kRollP * u + slice_part_floats(u, kRollP));
}

// Copies the trunk (wx, wh, bx, bh) into shared memory in the layout of
// weights_at (whole block); the head's slots stay unused.
__device__ __forceinline__ Weights load_trunk(float* smem, const float* wx, const float* wh,
                                              const float* bx, const float* bh, int u) {
  const int g = 3 * u;
  const int sizes[4] = {2 * g, u * g, g, g};
  const float* srcs[4] = {wx, wh, bx, bh};
  float* dst = smem;
  for (int a = 0; a < 4; ++a) {
    for (int i = threadIdx.x; i < sizes[a]; i += blockDim.x) dst[i] = srcs[a][i];
    dst += sizes[a];
  }
  __syncthreads();
  return weights_at(smem, u);
}

// kGates: also store each site's gates [r | z | c | ghc] (B20's input).
template <bool kGates>
__global__ void rollout_hist_kernel(const int32_t* __restrict__ samples, const float* wx,
                                    const float* wh, const float* bx, const float* bh,
                                    float* __restrict__ hist, float* __restrict__ gates,
                                    int b_total, int n_sites, int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_trunk(smem, wx, wh, bx, bh, u);
  const int u32 = warp_round(u), ks = threadIdx.x / u32, j = threadIdx.x - ks * u32;
  float* h = smem + weight_floats(u);
  float* hn = h + kRollP * u;
  float* part = hn + kRollP * u;
  for (int i = threadIdx.x; i < kRollP * u; i += blockDim.x) h[i] = 0.0f;
  // thread (p, j) of the first kRollP slices updates unit j of sample p; a
  // padding slot past the batch repeats the last sample and stores nothing
  const int b = blockIdx.x * kRollP + min(ks, kRollP - 1);
  const int64_t my_row = static_cast<int64_t>(min(b, b_total - 1)) * n_sites;
  const bool mine = ks < kRollP && j < u && b < b_total;
  __syncthreads();
  float x = 0.0f;
  for (int n = 0; n < n_sites; ++n) {
    if (j < u) slice_product<kRollP>(w, u, ks, j, h, part);
    __syncthreads();
    if (ks < kRollP && j < u) {
      const GateStep st = slice_update<kRollP>(w, u, j, ks, h, part, x, n > 0 ? 1.0f : 0.0f);
      hn[j * kRollP + ks] = st.h;
      if (mine) {
        hist[(my_row + n) * u + j] = st.h;
        if constexpr (kGates) {
          float* gt = gates + (my_row + n) * 4 * u;
          gt[j] = st.r;
          gt[u + j] = st.z;
          gt[2 * u + j] = st.c;
          gt[3 * u + j] = st.ghc;
        }
      }
      x = static_cast<float>(samples[my_row + n]);
    }
    __syncthreads();
    float* tmp = h; h = hn; hn = tmp;
  }
}

template <bool kGates>
cudaError_t launch_rollout(const void* samples, const void* wx, const void* wh, const void* bx,
                           const void* bh, void* hist, void* gates, int b_total, int n_sites,
                           int u, cudaStream_t st) {
  const size_t smem = rollout_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(rollout_hist_kernel<kGates>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rollout_hist_kernel<kGates><<<(b_total + kRollP - 1) / kRollP, kSlices * warp_round(u), smem,
                                st>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(bx),
      static_cast<const float*>(bh), static_cast<float*>(hist), static_cast<float*>(gates),
      b_total, n_sites, u);
  return cudaGetLastError();
}

}  // namespace rnnwf

// hist: B*N*U floats (output); gates: B*N*4U floats (output), or null for
// the history alone.
extern "C" int rnnwf_rollout_hist(const void* samples, const void* wx, const void* wh,
                                  const void* bx, const void* bh, void* hist, void* gates,
                                  int b_total, int n_sites, int u, void* stream) {
  using namespace rnnwf;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      gates ? launch_rollout<true>(samples, wx, wh, bx, bh, hist, gates, b_total, n_sites, u, st)
            : launch_rollout<false>(samples, wx, wh, bx, bh, hist, gates, b_total, n_sites, u,
                                    st));
}

// hist: B*N*U, gates: B*N*4U (B19 storing), dout: P*B*N*U (inputs); dg:
// P*B*N*4U (output).
extern "C" int rnnwf_sweep_dgates(const void* samples, const void* wh, const void* hist,
                                  const void* gates, const void* dout, void* dg, int b_total,
                                  int parts, int n_sites, int u, void* stream) {
  using namespace rnnwf;
  SweepArgs a{};
  a.samples = static_cast<const int32_t*>(samples);
  a.wh = static_cast<const float*>(wh);
  a.hist = static_cast<const float*>(hist);
  a.gates = static_cast<const float*>(gates);
  a.douts = static_cast<const float*>(dout);
  a.out = static_cast<float*>(dg);
  a.b_total = b_total;
  a.parts = parts;
  a.n_sites = n_sites;
  a.u = u;
  return static_cast<int>(
      launch_reverse_sweep(Sweep::kDouts, a, static_cast<cudaStream_t>(stream)));
}
