// B10 and B11: the J1-J2 off-diagonal local energy of the U(1) cRNN,
//     eoff[b] = sum_k el_k exp(dRe_k) (cos dIm_k, sin dIm_k),
//     dRe_k + i dIm_k = log psi(sigma_b with bond k exchanged) - log psi(sigma_b),
// over the anti-aligned bonds k, with the base (Re, Im) log psi as a
// by-product.  B10 reads the given samples; B11 (sample mode) draws them
// first, autoregressively, in the same base pass.  B8 is the stand-alone
// U(1)-masked sampler: B11's sample-mode base pass alone, returning the
// samples and log |psi|^2 = 2 Re log psi.
//
// Replaces: rnnwavefunctions_tpu/ops/j1j2_exchange_kernel.py::
// j1j2_exchange_offdiag (B10) and ::j1j2_sample_and_exchange (B11), both
// _make_kernel; and rnnwavefunctions_tpu/ops/fused_crnn.py::crnn_sample (B8,
// _make_sample_kernel).
//
// Bound on the H100: the exchange suffixes.  Exchanging bond (a, b) leaves
// sites < a untouched, so only sites a..N-1 are recomputed, from the stored
// hidden state h[a-1] (prefix sharing): about B * (number of anti-aligned
// bonds) * N/2 cRNN site steps, ~2.5e6 at the J1-J2 flagship (B=500,
// N=100, U=50, J2 != 0), each a 3U x U product plus two heads and the mask,
// ~40 GFLOP per call.  The products read their weights from shared memory,
// so the limit is shared-memory bandwidth and issue rate, not HBM.  B8 does
// only the B*N base steps (B7's work) and is bound, as B7, by the latency of
// N dependent site steps per sample.
//
// Design: four launches.
//   1. Base pass, one warp per sample: (in sample mode) draws each spin from
//      a Philox uniform with the mask's clamp, and stores the hidden history
//      h[n], the Kahan-corrected prefixes pfx_re[n], pfx_im[n] and the
//      up-counts before each site, cup[n].  B8 runs this launch alone in
//      sample mode and stores no history, only the spins and log |psi|^2;
//      the arithmetic is the same code, so B8 draws B11's spins bit for bit.
//   2. Bond lists, one warp per bond: the samples whose bond is
//      anti-aligned, in sample order (a ballot per 32 samples); the others
//      get a term of exactly 0 and no work.  The TPU kernel ran every bond
//      and multiplied the aligned ones by 0.
//   3. Suffix pass, one warp per (bond, group of 4 listed samples): the 4
//      trajectories restart at site a from h[a-1] (zero at a = 0), the
//      prefix pfx[a-1] and the up-count cup[a], and teacher-force sites
//      a..N-1 with the targets flipped at a and b; the U(1) mask uses each
//      exchanged trajectory's own running count.  They share the bond, so
//      they have one length and run in lockstep, and each weight load feeds
//      4 products.  Warps run longest suffix first: the periodic wrap bonds
//      (0, N-1), (0, N-2) and (1, N-1), which are full-length trajectories,
//      then the NN and NNN bonds by start site.
//   4. A per-sample sum of the bond terms in a fixed order (NN bonds
//      ascending, then NNN, then the wraps), as the TPU kernel adds them, so
//      the result does not depend on how warps were scheduled.
// The TPU kernel's wavefront groups, lane packing and VMEM spill rings are
// TPU-only and have no counterpart here.
#include "crnn_common.cuh"

namespace rnnwf {

constexpr int kExBaseWarps = 4;
constexpr int kExSufWarps = 8;
constexpr int kExSufT = 4;
constexpr int kExListWarps = 4;

size_t exchange_base_smem_bytes(int u) {
  return sizeof(float) * (crnn_weight_floats(u) + kExBaseWarps * 2 * u);
}
size_t exchange_suffix_smem_bytes(int u) {
  return sizeof(float) * (crnn_weight_floats(u) + kExSufWarps * 2 * u * kExSufT);
}

// The bond families of one call.
struct Bonds {
  int n;
  int has_nnn;
  int periodic;
  float el_nn;
  float el_nnn;
};

__host__ __device__ inline int num_bonds(int n, int has_nnn, int periodic) {
  return (n - 1) + (has_nnn ? n - 2 : 0) + (periodic ? (has_nnn ? 3 : 1) : 0);
}

// Bond k in the summation order: NN (k, k+1), then NNN (k, k+2), then the
// wraps (0, N-1) at el_nn and (0, N-2), (1, N-1) at el_nnn.
__device__ __forceinline__ void bond_at(const Bonds& bs, int k, int& a, int& b, float& el) {
  const int nn = bs.n - 1, nnn = bs.has_nnn ? bs.n - 2 : 0;
  if (k < nn) { a = k; b = k + 1; el = bs.el_nn; return; }
  k -= nn;
  if (k < nnn) { a = k; b = k + 2; el = bs.el_nnn; return; }
  k -= nnn;
  a = k == 2 ? 1 : 0;
  b = k == 1 ? bs.n - 2 : bs.n - 1;
  el = k == 0 ? bs.el_nn : bs.el_nnn;
}

// Launch slot -> bond, longest suffix first: the wraps, then NN a and
// NNN a side by side for a = 0, 1, ...
__device__ __forceinline__ int bond_of_slot(const Bonds& bs, int slot) {
  const int nn = bs.n - 1, nnn = bs.has_nnn ? bs.n - 2 : 0;
  const int wraps = num_bonds(bs.n, bs.has_nnn, bs.periodic) - nn - nnn;
  if (slot < wraps) return nn + nnn + slot;
  slot -= wraps;
  if (!bs.has_nnn) return slot;
  return (slot & 1) ? nn + (slot >> 1) : (slot >> 1);
}

// kHistory: store hist, the prefixes and the up-counts for the suffix pass
// and write (Re, Im) log psi; off (B8), only lp_re is written, as
// log |psi|^2 = 2 Re log psi.
template <bool kSample, bool kHistory>
__global__ void exchange_base_kernel(int32_t* __restrict__ samples, uint32_t seed,
                                     uint32_t offset, WeightPtrs wp, float* __restrict__ hist,
                                     float* __restrict__ pfx_re, float* __restrict__ pfx_im,
                                     float* __restrict__ cup, float* __restrict__ lp_re,
                                     float* __restrict__ lp_im, int b_total, int n_sites,
                                     int u, int u1) {
  extern __shared__ __align__(16) float smem[];
  const CWeights c = load_crnn_weights(smem, wp, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kExBaseWarps + warp;
  if (b >= b_total) return;
  float* h = smem + crnn_weight_floats(u) + warp * 2 * u;
  float* hn = h + u;
  for (int j = lane; j < u; j += kWarp) h[j] = 0.0f;
  __syncwarp();

  const int64_t row = static_cast<int64_t>(b) * n_sites;
  float* h_row = kHistory ? hist + row * u : nullptr;
  float x[1] = {0.0f}, up[1] = {0.0f}, lp0[1], lp1[1], ph0[1], ph1[1];
  float re = 0.0f, rec = 0.0f, im = 0.0f, imc = 0.0f;
  for (int n = 0; n < n_sites; ++n) {
    crnn_site<1>(c, u, h, hn, x, n > 0 ? 1.0f : 0.0f, n, up, n_sites, u1 != 0, lp0, lp1, ph0,
                 ph1, lane);
    float s;
    if constexpr (kSample) {
      s = crnn_draw(uniform23(seed, offset, static_cast<uint32_t>(b), static_cast<uint32_t>(n)),
                    lp0[0], lp1[0]);
    } else {
      s = static_cast<float>(samples[row + n]);
    }
    kadd(re, rec, 0.5f * (s > 0.5f ? lp1[0] : lp0[0]));
    kadd(im, imc, s > 0.5f ? ph1[0] : ph0[0]);
    if constexpr (kHistory) {
      for (int j = lane; j < u; j += kWarp) h_row[n * u + j] = hn[j];
    }
    if (lane == 0) {
      if constexpr (kSample) samples[row + n] = static_cast<int32_t>(s);
      if constexpr (kHistory) {
        pfx_re[row + n] = re - rec;
        pfx_im[row + n] = im - imc;
        cup[row + n] = up[0];
      }
    }
    x[0] = s;
    up[0] += s;
    float* tmp = h; h = hn; hn = tmp;
  }
  if (lane == 0) {
    if constexpr (kHistory) {
      lp_re[b] = re - rec;
      lp_im[b] = im - imc;
    } else {
      lp_re[b] = 2.0f * (re - rec);
    }
  }
}

// Bond k's list of the samples it exchanges (anti-aligned, nonzero element),
// in sample order, and their count; the other samples' terms are set to 0.
__global__ void exchange_list_kernel(const int32_t* __restrict__ samples, Bonds bs,
                                     int32_t* __restrict__ lists, int32_t* __restrict__ counts,
                                     float* __restrict__ terms_re, float* __restrict__ terms_im,
                                     int b_total, int n_bonds) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int k = blockIdx.x * kExListWarps + warp;
  if (k >= n_bonds) return;
  int a, bsite;
  float el;
  bond_at(bs, k, a, bsite, el);
  const int64_t base = static_cast<int64_t>(k) * b_total;
  int count = 0;
  for (int b0 = 0; b0 < b_total; b0 += kWarp) {
    const int b = b0 + lane;
    bool live = false;
    if (b < b_total) {
      const int32_t* s_row = samples + static_cast<int64_t>(b) * bs.n;
      live = el != 0.0f && s_row[a] != s_row[bsite];
      if (!live) {
        terms_re[base + b] = 0.0f;
        terms_im[base + b] = 0.0f;
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) lists[base + count + __popc(mask & ((1u << lane) - 1u))] = b;
    count += __popc(mask);
  }
  if (lane == 0) counts[k] = count;
}

__global__ void exchange_suffix_kernel(const int32_t* __restrict__ samples, WeightPtrs wp,
                                       Bonds bs, const float* __restrict__ hist,
                                       const float* __restrict__ pfx_re,
                                       const float* __restrict__ pfx_im,
                                       const float* __restrict__ cup,
                                       const float* __restrict__ lp_re,
                                       const float* __restrict__ lp_im,
                                       const int32_t* __restrict__ lists,
                                       const int32_t* __restrict__ counts,
                                       float* __restrict__ terms_re, float* __restrict__ terms_im,
                                       int b_total, int n_bonds, int u, int u1) {
  extern __shared__ __align__(16) float smem[];
  const CWeights c = load_crnn_weights(smem, wp, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_sites = bs.n;
  const int groups = (b_total + kExSufT - 1) / kExSufT;
  const int gw = blockIdx.x * kExSufWarps + warp;
  const int slot = gw / groups;
  if (slot >= n_bonds) return;
  const int k = bond_of_slot(bs, slot);
  const int grp = gw - slot * groups;
  const int count = counts[k];
  if (grp * kExSufT >= count) return;
  int a, bsite;
  float el;
  bond_at(bs, k, a, bsite, el);
  float* h = smem + crnn_weight_floats(u) + warp * 2 * u * kExSufT;
  float* hn = h + u * kExSufT;

  const int32_t* list = lists + static_cast<int64_t>(k) * b_total;
  int sample_of[kExSufT];
  int64_t rows[kExSufT];
  float x[kExSufT], up[kExSufT], re[kExSufT], rec[kExSufT], im[kExSufT], imc[kExSufT];
  float lp0[kExSufT], lp1[kExSufT], ph0[kExSufT], ph1[kExSufT];
#pragma unroll
  for (int t = 0; t < kExSufT; ++t) {
    sample_of[t] = list[min(grp * kExSufT + t, count - 1)];  // padding repeats the last listed sample
    rows[t] = static_cast<int64_t>(sample_of[t]) * n_sites;
    if (a > 0) {
      const float* hf = hist + (rows[t] + a - 1) * u;
      for (int j = lane; j < u; j += kWarp) h[j * kExSufT + t] = hf[j];
      x[t] = static_cast<float>(samples[rows[t] + a - 1]);
      re[t] = pfx_re[rows[t] + a - 1];
      im[t] = pfx_im[rows[t] + a - 1];
    } else {
      for (int j = lane; j < u; j += kWarp) h[j * kExSufT + t] = 0.0f;
      x[t] = 0.0f;
      re[t] = 0.0f;
      im[t] = 0.0f;
    }
    up[t] = cup[rows[t] + a];
    rec[t] = 0.0f;
    imc[t] = 0.0f;
  }
  __syncwarp();
  for (int n = a; n < n_sites; ++n) {
    crnn_site<kExSufT>(c, u, h, hn, x, n > 0 ? 1.0f : 0.0f, n, up, n_sites, u1 != 0, lp0, lp1,
                       ph0, ph1, lane);
    const bool flip = n == a || n == bsite;
#pragma unroll
    for (int t = 0; t < kExSufT; ++t) {
      float s = static_cast<float>(samples[rows[t] + n]);
      if (flip) s = 1.0f - s;
      kadd(re[t], rec[t], 0.5f * (s > 0.5f ? lp1[t] : lp0[t]));
      kadd(im[t], imc[t], s > 0.5f ? ph1[t] : ph0[t]);
      x[t] = s;
      up[t] += s;
    }
    float* tmp = h; h = hn; hn = tmp;
  }
  if (lane == 0) {
    const int64_t base = static_cast<int64_t>(k) * b_total;
#pragma unroll
    for (int t = 0; t < kExSufT; ++t) {
      if (grp * kExSufT + t >= count) continue;
      const int b = sample_of[t];
      const float d_re = (re[t] - rec[t]) - lp_re[b];
      const float d_im = (im[t] - imc[t]) - lp_im[b];
      const float mag = el * expf(d_re);
      terms_re[base + b] = mag * cosf(d_im);
      terms_im[base + b] = mag * sinf(d_im);
    }
  }
}

__global__ void exchange_sum_kernel(const float* __restrict__ terms_re,
                                    const float* __restrict__ terms_im,
                                    float* __restrict__ eoff_re, float* __restrict__ eoff_im,
                                    int b_total, int n_bonds) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= b_total) return;
  float vr = 0.0f, vi = 0.0f;
  for (int k = 0; k < n_bonds; ++k) {
    vr += terms_re[static_cast<int64_t>(k) * b_total + b];
    vi += terms_im[static_cast<int64_t>(k) * b_total + b];
  }
  eoff_re[b] = vr;
  eoff_im[b] = vi;
}

template <bool kSample, bool kHistory>
cudaError_t launch_exchange_base(int32_t* samples, uint32_t seed, uint32_t offset,
                                 const WeightPtrs& wp, float* hist, float* pfx_re,
                                 float* pfx_im, float* cup, float* lp_re, float* lp_im,
                                 int b_total, int n_sites, int u, int u1, cudaStream_t st) {
  const size_t smem = exchange_base_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(exchange_base_kernel<kSample, kHistory>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  exchange_base_kernel<kSample, kHistory><<<(b_total + kExBaseWarps - 1) / kExBaseWarps,
                                            kExBaseWarps * kWarp, smem, st>>>(
      samples, seed, offset, wp, hist, pfx_re, pfx_im, cup, lp_re, lp_im, b_total, n_sites, u,
      u1);
  return cudaGetLastError();
}

template <bool kSample>
int launch_exchange(void* samples_v, uint32_t seed, uint32_t offset, const WeightPtrs& wp,
                    void* hist_v, void* pfx_v, void* terms_v, void* order_v, void* out_v,
                    int b_total, int n_sites, int u, int u1, float el_nn, float el_nnn,
                    int has_nnn, int periodic, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* samples = static_cast<int32_t*>(samples_v);
  float* hist = static_cast<float*>(hist_v);
  const int64_t bn = static_cast<int64_t>(b_total) * n_sites;
  float* pfx_re = static_cast<float*>(pfx_v);
  float* pfx_im = pfx_re + bn;
  float* cup = pfx_im + bn;
  const int n_bonds = num_bonds(n_sites, has_nnn, periodic);
  const int64_t kb = static_cast<int64_t>(n_bonds) * b_total;
  float* terms_re = static_cast<float*>(terms_v);
  float* terms_im = terms_re + kb;
  int32_t* lists = static_cast<int32_t*>(order_v);
  int32_t* counts = lists + kb;
  float* eoff_re = static_cast<float*>(out_v);
  float* eoff_im = eoff_re + b_total;
  float* lp_re = eoff_im + b_total;
  float* lp_im = lp_re + b_total;
  const Bonds bs{n_sites, has_nnn, periodic, el_nn, el_nnn};

  cudaError_t err = launch_exchange_base<kSample, true>(
      samples, seed, offset, wp, hist, pfx_re, pfx_im, cup, lp_re, lp_im, b_total, n_sites, u,
      u1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  exchange_list_kernel<<<(n_bonds + kExListWarps - 1) / kExListWarps, kExListWarps * kWarp, 0,
                         st>>>(samples, bs, lists, counts, terms_re, terms_im, b_total, n_bonds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_suf = exchange_suffix_smem_bytes(u);
  err = cudaFuncSetAttribute(exchange_suffix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_suf));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps = static_cast<int64_t>(n_bonds) * ((b_total + kExSufT - 1) / kExSufT);
  const int blocks = static_cast<int>((warps + kExSufWarps - 1) / kExSufWarps);
  exchange_suffix_kernel<<<blocks, kExSufWarps * kWarp, smem_suf, st>>>(
      samples, wp, bs, hist, pfx_re, pfx_im, cup, lp_re, lp_im, lists, counts, terms_re,
      terms_im, b_total, n_bonds, u, u1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  exchange_sum_kernel<<<(b_total + 127) / 128, 128, 0, st>>>(terms_re, terms_im, eoff_re,
                                                             eoff_im, b_total, n_bonds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rnnwf

// The number of bonds one call sums, the row count of its term and list
// scratch.
extern "C" int rnnwf_j1j2_num_bonds(int n_sites, int has_nnn, int periodic) {
  return rnnwf::num_bonds(n_sites, has_nnn, periodic);
}

// Scratch (allocated by the caller): hist B*N*U floats; pfx 3*B*N floats
// (Re and Im prefixes, up-counts); terms 2*K*B floats; order K*B + K ints
// (the bond lists, then their counts), K = rnnwf_j1j2_num_bonds.  out: 4*B
// floats (eoff_re, eoff_im, lp_re, lp_im).  seed and offset are unused.
extern "C" int rnnwf_j1j2_exchange_offdiag(const void* samples, unsigned int seed,
                                           unsigned int offset, const void* wx, const void* wh,
                                           const void* bx, const void* bh, const void* aw,
                                           const void* ab, const void* pw, const void* pb,
                                           void* hist, void* pfx, void* terms, void* order,
                                           void* out, int b_total, int n_sites, int u, int u1,
                                           float el_nn, float el_nnn, int has_nnn, int periodic,
                                           void* stream) {
  return rnnwf::launch_exchange<false>(
      const_cast<void*>(samples), seed, offset,
      rnnwf::weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb), hist, pfx, terms, order, out,
      b_total, n_sites, u, u1, el_nn, el_nnn, has_nnn, periodic, stream);
}

// As above, with samples written: B*N ints drawn from Philox keyed by
// (seed, offset).
extern "C" int rnnwf_j1j2_sample_and_exchange(void* samples, unsigned int seed,
                                              unsigned int offset, const void* wx,
                                              const void* wh, const void* bx, const void* bh,
                                              const void* aw, const void* ab, const void* pw,
                                              const void* pb, void* hist, void* pfx,
                                              void* terms, void* order, void* out, int b_total,
                                              int n_sites, int u, int u1, float el_nn,
                                              float el_nnn, int has_nnn, int periodic,
                                              void* stream) {
  return rnnwf::launch_exchange<true>(
      samples, seed, offset, rnnwf::weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb), hist, pfx,
      terms, order, out, b_total, n_sites, u, u1, el_nn, el_nnn, has_nnn, periodic, stream);
}

// B8: samples (B*N ints) drawn from Philox keyed by (seed, offset), the same
// draws as B11, and their log |psi|^2 (B floats); no scratch.
extern "C" int rnnwf_crnn_sample(unsigned int seed, unsigned int offset, const void* wx,
                                 const void* wh, const void* bx, const void* bh, const void* aw,
                                 const void* ab, const void* pw, const void* pb, void* samples,
                                 void* lp, int b_total, int n_sites, int u, int u1,
                                 void* stream) {
  return static_cast<int>(rnnwf::launch_exchange_base<true, false>(
      static_cast<int32_t*>(samples), seed, offset,
      rnnwf::weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb), nullptr, nullptr, nullptr, nullptr,
      static_cast<float*>(lp), nullptr, b_total, n_sites, u, u1,
      static_cast<cudaStream_t>(stream)));
}
