// K3 and K4: the single-flip amplitude-ratio sum of the TFIM estimator,
//     ratio[b] = sum_f exp(0.5 * (log p(sigma_b with site f flipped) - log p(sigma_b))),
// with the base log p as a by-product.  K4 reads the given samples; K3
// (sample mode) draws them first, autoregressively, in the same base pass.
// B6 returns the per-flip log p, lpf[b, f] = log p(sigma_b with site f
// flipped), in place of the ratio sum (the parity-symmetrized estimator
// combines two directions before the ratio), teacher-forced or in sample
// mode.  B5 is the stand-alone sampler: the sample-mode base pass alone.
//
// Replaces: rnnwavefunctions_tpu/ops/tfim_flip_kernel.py::tfim_flip_ratio_sum
// (K4), ::tfim_sample_and_flip_sum with per_flip=False (K3) and
// per_flip=True (B6, sample mode), ::tfim_flip_log_probs (B6, teacher-forced),
// all _make_flip_kernel + _flip_wavefront; and
// rnnwavefunctions_tpu/ops/fused_gru.py::_sample_pallas (B5,
// _make_sample_kernel).
//
// Bound on the H100: the flip suffixes.  Flipping site f leaves sites < f
// untouched, so only sites f+1..N-1 are recomputed, starting from the stored
// hidden state h_f with the flipped input (prefix sharing): B*N*(N-1)/2
// GRU site steps, about 37 GFLOP per flagship step (B=500, N=100, U=50),
// over 90% of the step's arithmetic.  Each step is a 3U x U product out of
// shared memory, so the limit is shared-memory load bandwidth and issue
// rate, not HBM.  B5 does only the B*N base steps (K1's work) and is bound,
// as K1, by the latency of N dependent site steps per sample.
//
// Design: three launches.
//   1. Base pass, one warp per sample: (in sample mode) draws each spin from
//      a Philox uniform, and stores the hidden history h_n, the corrected
//      prefix pfx[n] = log p(sites <= n), the flipped-site log-prob fl[n] and
//      the base log p.  B5 runs this launch alone and stores no history
//      (10 MB at the flagship), only the spins and log p; the arithmetic is
//      the same code, so B5 draws K3's spins and log p bit for bit.
//   2. Suffix pass, one warp per (flip f, group of 4 samples): the 4
//      trajectories of a warp share the flip site, so they have the same
//      length and run in lockstep, and each weight load feeds 4 products.
//      Warps are ordered by flip, longest suffix first.  Flip f starts from
//      h_hist[f] with input 1 - s_f and acc = pfx[f-1] + fl[f], then
//      Kahan-adds sites f+1..N-1; the last flip has an empty suffix.  K3/K4
//      write the ratio term exp(0.5 (lpf - lp)); B6 writes lpf itself (the
//      log of a term would be -inf where the term underflows).
//   3. (K3/K4) A per-sample sum of the N ratio terms in flip order, so the
//      result does not depend on how warps were scheduled.
// The TPU kernel's wavefront groups, lane packing and VMEM spill rings are
// TPU-only and have no counterpart here.
#include "gru_common.cuh"

namespace rnnwf {

constexpr int kBaseWarps = 4;
constexpr int kSufWarps = 8;
constexpr int kSufT = 4;

size_t flip_base_smem_bytes(int u) {
  return sizeof(float) * (weight_floats(u) + kBaseWarps * 2 * u);
}
size_t flip_suffix_smem_bytes(int u) {
  return sizeof(float) * (weight_floats(u) + kSufWarps * 2 * u * kSufT);
}

// kHistory: store hist, pfx and fl for the suffix pass (off for B5).
template <bool kSample, bool kHistory>
__global__ void flip_base_kernel(int32_t* __restrict__ samples, uint32_t seed,
                                 uint32_t offset, const float* wx, const float* wh,
                                 const float* bx, const float* bh, const float* hw,
                                 const float* hb, float* __restrict__ hist,
                                 float* __restrict__ pfx, float* __restrict__ fl,
                                 float* __restrict__ lp, int b_total, int n_sites, int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_weights(smem, wx, wh, bx, bh, hw, hb, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kBaseWarps + warp;
  if (b >= b_total) return;
  float* h = smem + weight_floats(u) + warp * 2 * u;
  float* hn = h + u;
  for (int j = lane; j < u; j += kWarp) h[j] = 0.0f;
  __syncwarp();

  const int64_t row = static_cast<int64_t>(b) * n_sites;
  float* h_row = kHistory ? hist + row * u : nullptr;
  float x[1] = {0.0f}, l0[1], l1[1];
  float acc = 0.0f, cmp = 0.0f;
  for (int n = 0; n < n_sites; ++n) {
    gru_site<1>(w, u, h, hn, x, n > 0 ? 1.0f : 0.0f, l0, l1, lane);
    float s;
    if constexpr (kSample) {
      const float p0 = sigmoidf_(l0[0] - l1[0]);
      s = uniform23(seed, offset, static_cast<uint32_t>(b), static_cast<uint32_t>(n)) >= p0
              ? 1.0f : 0.0f;
    } else {
      s = static_cast<float>(samples[row + n]);
    }
    kadd(acc, cmp, logp2(l0[0], l1[0], s));
    if constexpr (kHistory) {
      for (int j = lane; j < u; j += kWarp) h_row[n * u + j] = hn[j];
    }
    if (lane == 0) {
      if constexpr (kSample) samples[row + n] = static_cast<int32_t>(s);
      if constexpr (kHistory) {
        pfx[row + n] = acc - cmp;
        fl[row + n] = logp2(l0[0], l1[0], 1.0f - s);
      }
    }
    x[0] = s;
    float* tmp = h; h = hn; hn = tmp;
  }
  if (lane == 0) lp[b] = acc - cmp;
}

// kPerFlip: out[b, f] is the flipped configuration's log p (B6), else its
// ratio term exp(0.5 (lpf - lp)) (K3/K4).
template <bool kPerFlip>
__global__ void flip_suffix_kernel(const int32_t* __restrict__ samples, const float* wx,
                                   const float* wh, const float* bx, const float* bh,
                                   const float* hw, const float* hb,
                                   const float* __restrict__ hist,
                                   const float* __restrict__ pfx,
                                   const float* __restrict__ fl,
                                   const float* __restrict__ lp,
                                   float* __restrict__ out, int b_total, int n_sites,
                                   int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_weights(smem, wx, wh, bx, bh, hw, hb, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int groups = (b_total + kSufT - 1) / kSufT;
  const int gw = blockIdx.x * kSufWarps + warp;
  const int f = gw / groups;
  if (f >= n_sites) return;
  const int grp = gw - f * groups;
  float* h = smem + weight_floats(u) + warp * 2 * u * kSufT;
  float* hn = h + u * kSufT;

  int64_t rows[kSufT];
  float x[kSufT], acc[kSufT], cmp[kSufT], l0[kSufT], l1[kSufT];
#pragma unroll
  for (int t = 0; t < kSufT; ++t) {
    const int b = min(grp * kSufT + t, b_total - 1);  // padding rows repeat the last sample
    rows[t] = static_cast<int64_t>(b) * n_sites;
    const float* hf = hist + (rows[t] + f) * u;
    for (int j = lane; j < u; j += kWarp) h[j * kSufT + t] = hf[j];
    x[t] = 1.0f - static_cast<float>(samples[rows[t] + f]);
    acc[t] = (f > 0 ? pfx[rows[t] + f - 1] : 0.0f) + fl[rows[t] + f];
    cmp[t] = 0.0f;
  }
  __syncwarp();
  for (int n = f + 1; n < n_sites; ++n) {
    gru_site<kSufT>(w, u, h, hn, x, 1.0f, l0, l1, lane);
#pragma unroll
    for (int t = 0; t < kSufT; ++t) {
      const float s = static_cast<float>(samples[rows[t] + n]);
      kadd(acc[t], cmp[t], logp2(l0[t], l1[t], s));
      x[t] = s;
    }
    float* tmp = h; h = hn; hn = tmp;
  }
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kSufT; ++t) {
      const int b = grp * kSufT + t;
      if (b >= b_total) continue;
      const float lpf = acc[t] - cmp[t];
      out[rows[t] + f] = kPerFlip ? lpf : expf(0.5f * (lpf - lp[b]));
    }
  }
}

__global__ void flip_sum_kernel(const float* __restrict__ terms, float* __restrict__ ratio,
                                int b_total, int n_sites) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= b_total) return;
  const float* t = terms + static_cast<int64_t>(b) * n_sites;
  float v = 0.0f;
  for (int f = 0; f < n_sites; ++f) v += t[f];
  ratio[b] = v;
}

template <bool kSample, bool kHistory>
cudaError_t launch_base(int32_t* samples, uint32_t seed, uint32_t offset, const float* const* W,
                        float* hist, float* pfx, float* fl, float* lp, int b_total, int n_sites,
                        int u, cudaStream_t st) {
  const size_t smem = flip_base_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(flip_base_kernel<kSample, kHistory>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flip_base_kernel<kSample, kHistory><<<(b_total + kBaseWarps - 1) / kBaseWarps,
                                        kBaseWarps * kWarp, smem, st>>>(
      samples, seed, offset, W[0], W[1], W[2], W[3], W[4], W[5], hist, pfx, fl, lp, b_total,
      n_sites, u);
  return cudaGetLastError();
}

// The base pass, then the suffix pass into out (ratio terms, or the per-flip
// log p when kPerFlip), then (unless kPerFlip) the flip-order ratio sum.
template <bool kSample, bool kPerFlip>
int launch_flip(void* samples, uint32_t seed, uint32_t offset, const void* wx,
                const void* wh, const void* bx, const void* bh, const void* hw,
                const void* hb, void* hist, void* pfx, void* fl, void* out, void* lp,
                void* ratio, int b_total, int n_sites, int u, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* W[6] = {static_cast<const float*>(wx), static_cast<const float*>(wh),
                       static_cast<const float*>(bx), static_cast<const float*>(bh),
                       static_cast<const float*>(hw), static_cast<const float*>(hb)};
  cudaError_t err = launch_base<kSample, true>(
      static_cast<int32_t*>(samples), seed, offset, W, static_cast<float*>(hist),
      static_cast<float*>(pfx), static_cast<float*>(fl), static_cast<float*>(lp), b_total,
      n_sites, u, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_suf = flip_suffix_smem_bytes(u);
  err = cudaFuncSetAttribute(flip_suffix_kernel<kPerFlip>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_suf));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps = static_cast<int64_t>(n_sites) * ((b_total + kSufT - 1) / kSufT);
  const int blocks = static_cast<int>((warps + kSufWarps - 1) / kSufWarps);
  flip_suffix_kernel<kPerFlip><<<blocks, kSufWarps * kWarp, smem_suf, st>>>(
      static_cast<const int32_t*>(samples), W[0], W[1], W[2], W[3], W[4], W[5],
      static_cast<const float*>(hist), static_cast<const float*>(pfx),
      static_cast<const float*>(fl), static_cast<const float*>(lp),
      static_cast<float*>(out), b_total, n_sites, u);
  err = cudaGetLastError();
  if (err != cudaSuccess || kPerFlip) return static_cast<int>(err);

  flip_sum_kernel<<<(b_total + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(out), static_cast<float*>(ratio), b_total, n_sites);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rnnwf

// Scratch (allocated by the caller): hist B*N*U, pfx/fl/terms B*N floats each.
extern "C" int rnnwf_tfim_flip_ratio_sum(const void* samples, const void* wx, const void* wh,
                                         const void* bx, const void* bh, const void* hw,
                                         const void* hb, void* hist, void* pfx, void* fl,
                                         void* terms, void* lp, void* ratio, int b_total,
                                         int n_sites, int u, void* stream) {
  return rnnwf::launch_flip<false, false>(const_cast<void*>(samples), 0u, 0u, wx, wh, bx, bh,
                                          hw, hb, hist, pfx, fl, terms, lp, ratio, b_total,
                                          n_sites, u, stream);
}

extern "C" int rnnwf_tfim_sample_and_flip_sum(unsigned int seed, unsigned int offset,
                                              const void* wx, const void* wh, const void* bx,
                                              const void* bh, const void* hw, const void* hb,
                                              void* samples, void* hist, void* pfx, void* fl,
                                              void* terms, void* lp, void* ratio, int b_total,
                                              int n_sites, int u, void* stream) {
  return rnnwf::launch_flip<true, false>(samples, seed, offset, wx, wh, bx, bh, hw, hb, hist,
                                         pfx, fl, terms, lp, ratio, b_total, n_sites, u, stream);
}

// B6, teacher-forced.  Scratch: hist B*N*U, pfx/fl B*N floats; out: lpf B*N
// and lp B floats.
extern "C" int rnnwf_tfim_flip_log_probs(const void* samples, const void* wx, const void* wh,
                                         const void* bx, const void* bh, const void* hw,
                                         const void* hb, void* hist, void* pfx, void* fl,
                                         void* lpf, void* lp, int b_total, int n_sites, int u,
                                         void* stream) {
  return rnnwf::launch_flip<false, true>(const_cast<void*>(samples), 0u, 0u, wx, wh, bx, bh,
                                         hw, hb, hist, pfx, fl, lpf, lp, nullptr, b_total,
                                         n_sites, u, stream);
}

// B6 in sample mode: as above, with samples (B*N ints) drawn from Philox
// keyed by (seed, offset), the same draws as K3 and B5.
extern "C" int rnnwf_tfim_sample_and_flip_log_probs(unsigned int seed, unsigned int offset,
                                                    const void* wx, const void* wh,
                                                    const void* bx, const void* bh,
                                                    const void* hw, const void* hb,
                                                    void* samples, void* hist, void* pfx,
                                                    void* fl, void* lpf, void* lp, int b_total,
                                                    int n_sites, int u, void* stream) {
  return rnnwf::launch_flip<true, true>(samples, seed, offset, wx, wh, bx, bh, hw, hb, hist,
                                        pfx, fl, lpf, lp, nullptr, b_total, n_sites, u, stream);
}

// B5: samples (B*N ints) and their log p (B floats), no scratch.
extern "C" int rnnwf_gru_sample(unsigned int seed, unsigned int offset, const void* wx,
                                const void* wh, const void* bx, const void* bh, const void* hw,
                                const void* hb, void* samples, void* lp, int b_total,
                                int n_sites, int u, void* stream) {
  const float* W[6] = {static_cast<const float*>(wx), static_cast<const float*>(wh),
                       static_cast<const float*>(bx), static_cast<const float*>(bh),
                       static_cast<const float*>(hw), static_cast<const float*>(hb)};
  return static_cast<int>(rnnwf::launch_base<true, false>(
      static_cast<int32_t*>(samples), seed, offset, W, nullptr, nullptr, nullptr,
      static_cast<float*>(lp), b_total, n_sites, u, static_cast<cudaStream_t>(stream)));
}
