// B10 and B11: the J1-J2 off-diagonal local energy of the U(1) cRNN,
//     eoff[b] = sum_k el_k exp(dRe_k) (cos dIm_k, sin dIm_k),
//     dRe_k + i dIm_k = log psi(sigma_b with bond k exchanged) - log psi(sigma_b),
// over the anti-aligned bonds k, with the base (Re, Im) log psi as a
// by-product.  B10 reads the given samples; B11 (sample mode) draws them
// first, autoregressively, in the same base pass.  B8 is the stand-alone
// U(1)-masked sampler: B11's sample-mode base pass alone, returning the
// samples and log |psi|^2 = 2 Re log psi.  B7 is B10's teacher-forced base
// pass alone, returning (Re, Im) log psi of the given samples.
//
// Replaces: rnnwavefunctions_tpu/ops/j1j2_exchange_kernel.py::
// j1j2_exchange_offdiag (B10) and ::j1j2_sample_and_exchange (B11), both
// _make_kernel; and rnnwavefunctions_tpu/ops/fused_crnn.py::crnn_sample (B8,
// _make_sample_kernel) and ::crnn_log_amp_parts (B7, _make_log_amp_kernel).
//
// Bound on the H100: the exchange suffixes.  Exchanging bond (a, b) leaves
// sites < a untouched and site a's state, so only sites a+1..N-1 are
// recomputed, from the stored hidden state h[a] (prefix sharing): about
// B * (number of anti-aligned bonds) * N/2 cRNN site steps, ~2.5e6 at the
// J1-J2 flagship (B=500, N=100, U=50, J2 != 0), each a 3U x U product
// (6U^2 of its 6U^2 + 38U + 20 operations) plus two heads and the mask,
// ~40 GFLOP per call.  B7 and B8 do only the B*N base steps and are bound
// by the latency of N dependent site steps per sample.
//
// Design: four launches (K3's, csrc/tfim_flip.cu, with a second head, the
// U(1) mask and bond lists).
//   1. Base pass, a block per kExP samples: its kSlices x U32 threads split
//      each site's product by unit and by quarter of k (slice_product,
//      gru_common.cuh); after a barrier the first kExP slices update one
//      sample each, store h[n] to the history and reduce their four head
//      terms (amplitude and phase logits) by shuffles per warp; after a
//      second barrier every thread sums the warps' terms in warp order, so
//      all hold the same logits and (in sample mode) take the same decision
//      from a Philox uniform (crnn_decide: one tanhf, the mask's clamp).
//      One more warp keeps the samples' books off that path: it draws the
//      uniforms of 32 sites at once (a lane per site) ahead of the
//      decisions; then its lane p, for both samples at once, forms sample
//      p's masked log-probabilities and phases (crnn_logps), Kahan-adds
//      both parts of log psi and stores the spins,
//      the corrected prefixes pfx_re[n], pfx_im[n], the up-counts before
//      each site cup[n], and site n's amplitude and phase terms with the
//      target flipped, fl_re[n], fl_im[n].  B8 runs this launch alone in
//      sample mode and stores no history, only the spins and
//      log |psi|^2; the arithmetic is the same code, so B8 draws B11's
//      spins bit for bit.  B7 is this launch teacher-forced, storing
//      nothing but (Re, Im) log psi: the samples enter where the sample
//      mode takes its decisions, so B7 on B11's draws gives B11's log psi
//      bit for bit.  B9's replay is this launch teacher-forced,
//      storing K2's A rows and the gates from its first slices and the two
//      heads' seeds of B9's reverse sweep from the books warp
//      (ExStore::kReplay, rnnwf_crnn_replay).
//   2. Bond lists, one warp per start site a: the (bond, sample) terms of
//      the bonds that start at a (NN (a, a+1), NNN (a, a+2), the wraps
//      (0, N-1), (0, N-2), (1, N-1)) whose bond is anti-aligned, by bond,
//      then sample (a ballot per 32 samples); the others get a term of
//      exactly 0 and no work.  The TPU kernel ran every bond and multiplied
//      the aligned ones by 0.  The last block to finish (a counter the base
//      pass zeroes) sums the lists' lengths in start-site order, the packed
//      offsets that the turned-around suffix pass reads.
//   3. Suffix pass on the tensor cores.  A trajectory of start site a
//      starts at site a+1 from h[a] with input 1 - s_a, up-count
//      cup[a] + 1 - s_a and the sums pfx[a-1] + fl[a] (site a's state is
//      the base pass's own; its flipped terms come from it), and keeps its
//      own second flip site, up-count, two Kahan pairs and U(1) mask.
//      Every product is 3xTF32 (tf32_wgmma.cuh) with both operands split
//      to nearest (split_tf32_nearest: a truncating split shrinks every
//      product, which biases the ratios of long suffixes alike, ~4e-5 of
//      E_loc at 1000 sites).  Turned around as K3's (csrc/tfim_flip.cu,
//      exchange_suffix_rs_kernel, where pad8(U) <= 56): a tile is 64
//      consecutive terms of all start sites' lists taken in start-site
//      order (the lists' offsets through the list launch's prefix sum of
//      their lengths), so a tile spans start sites and is full but for the
//      last.  Each site is Gates (64 x 24 KS) =
//      H (64 trajectories x Kp) . W_h (Kp x 24 KS) by wgmma m64nNk8, H the
//      A operand in the registers of the thread that updates it (its part
//      rounded to TF32 and the exact remainder, whose sum the update
//      reads), W_h's split tables resident in shared memory, one wgmma
//      group a site.  Each thread sums the amplitude and phase logits over
//      its own units in order, two shuffles within the quad give both rows'
//      four logits, and one lane per trajectory applies the mask and adds
//      to its Kahan pairs while the next site's products run: no barrier
//      and no shared-memory store a site.  A row whose start lies past the
//      tile's first start idles, and adds nothing, until it joins at its
//      start from h[a] (its L1 line prefetched a site ahead).  Persistent
//      blocks of kRsGroups warpgroups walk the tiles longest suffix first
//      in rounds, every other round reversed; the number of tiles is read
//      on the card.  Past pad8(U) = 56 the first design,
//      exchange_suffix_kernel, stays the path (to the family's U = 120): a
//      block (one warpgroup) per tile of 32 listed trajectories of one
//      start site (tiles run by start site, longest first, the wraps with
//      sites 0 and 1), each site the product W_h^T (3U x U) . H^T (U x 32)
//      by wgmma m64n32k8 (each gate padded to 64 rows, so a unit's r, z, c
//      land in one thread's accumulators, which start from b_h), the four
//      logits of a trajectory shuffle sums over each warp's units, added
//      over the warps in order after a barrier, where warp 3's lane t keeps
//      trajectory t's books.  The launch chooses by U alone.  In both,
//      padding rows or columns repeat the last listed term and write
//      nothing, and a trajectory's arithmetic does not depend on its tile
//      or row.
//   4. A per-sample sum of the bond terms in a fixed order (NN bonds
//      ascending, then NNN, then the wraps), as the TPU kernel adds them, so
//      the result does not depend on how blocks were scheduled.
// The TPU kernel's wavefront groups, lane packing and VMEM spill rings are
// TPU-only and have no counterpart here.
#include "crnn_common.cuh"
#include "tf32_wgmma.cuh"

namespace rnnwf {

constexpr int kExP = 2;        // samples per base-pass block
static_assert(kExP <= kSlices, "a base block's first slices update one sample each");
constexpr int kExTraj = 32;    // trajectories per suffix block (its N)
constexpr int kExListWarps = 4;

// The base pass's threads: the slices and the bookkeeping warp.
__host__ __device__ inline int ex_base_threads(int u) { return kSlices * warp_round(u) + kWarp; }

// Base pass, after the weights: h and hn (kExP*U each), the slices' sums,
// the head partials [sample][warp of its slice][4] and two blocks of
// uniforms [block parity][site % 32][sample].
__host__ __device__ inline int ex_base_buffer_floats(int u) {
  return 2 * kExP * u + slice_part_floats(u, kExP) + (warp_round(u) / kWarp) * kExP * 4 +
         2 * kWarp * kExP;
}

// Suffix pass, in this order: the states of the block's trajectories as the
// product's B operand in two parts (the state rounded to TF32 and its exact
// remainder, whose sum is the state),
// each kExTraj x Kp in wgmma's core-matrix layout (Kp = U rounded up to 8);
// W_h^T in wgmma's A-fragment order (Kp/8 k-steps x 3 Ug/64 tiles x 4 warps
// x 32 lanes x 4, Ug = U rounded up to 64); the input gates wx[x] + bx for
// x = 0, 1 (2 x 3 x Ug); b_h (3 x Ug); the amplitude and phase heads (Ug x 2
// each) and their biases (4), every padded entry zero; the head partials
// [site parity][warp][trajectory][4].
__host__ __device__ inline int ex_suffix_floats(int u) {
  const int ug = pad64(u);
  return 2 * kExTraj * pad8(u) + (pad8(u) / 8) * (3 * ug / kGateRows) * 4 * kWarp * 4 +
         6 * ug + 3 * ug + 4 * ug + 4 + 2 * 4 * kExTraj * 4;
}

size_t exchange_base_smem_bytes(int u) {
  return sizeof(float) * (crnn_weight_floats(u) + ex_base_buffer_floats(u));
}
size_t exchange_suffix_smem_bytes(int u) { return sizeof(float) * ex_suffix_floats(u); }

// The turned-around suffix pass, in this order: W_h's two parts and the
// input gates and b_h as rs_gru_tables lays them out (split to nearest);
// the heads [octet][t][amplitude | phase][unit 2 t, 2 t + 1 of the octet][2];
// their biases (amplitude 2, phase 2).  The lists' packed offsets are read
// from the list launch's scratch, so the size does not depend on N.
__host__ __device__ inline int ex_rs_floats(int ks) {
  return 2 * rs_table_floats(ks) + 48 * ks + 24 * ks + 32 * ks + 4;
}
size_t exchange_suffix_rs_smem_bytes(int u) {
  return rs_steps(u) <= kRsSteps ? sizeof(float) * ex_rs_floats(rs_steps(u)) : 0;
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
  return (n > 1 ? n - 1 : 0) + (has_nnn && n > 2 ? n - 2 : 0) +
         (periodic ? (has_nnn ? 3 : 1) : 0);
}

// Bond k in the summation order: NN (k, k+1), then NNN (k, k+2), then the
// wraps (0, N-1) at el_nn and (0, N-2), (1, N-1) at el_nnn.
__host__ __device__ inline void bond_at(const Bonds& bs, int k, int& a, int& b, float& el) {
  const int nn = bs.n > 1 ? bs.n - 1 : 0, nnn = bs.has_nnn && bs.n > 2 ? bs.n - 2 : 0;
  if (k < nn) { a = k; b = k + 1; el = bs.el_nn; return; }
  k -= nn;
  if (k < nnn) { a = k; b = k + 2; el = bs.el_nnn; return; }
  k -= nnn;
  a = k == 2 ? 1 : 0;
  b = k == 1 ? bs.n - 2 : bs.n - 1;
  el = k == 0 ? bs.el_nn : bs.el_nnn;
}

// What the base pass stores beside log psi: nothing (B7, B8), the suffix pass's
// inputs (B10, B11: hist, pfx_*, cup, fl_*) or B9's replay (rows, gates,
// seeds).
enum class ExStore { kNone, kFlip, kReplay };

// The base pass's outputs, each (B, N) unless stated; only those of the
// store mode are written.
struct ExBase {
  float* hist;    // (B, N, U) states h[n]
  float* pfx_re;  // corrected prefix Re log psi(sites <= n)
  float* pfx_im;
  float* cup;     // ups before site n
  float* fl_re;   // site n's Re term with its target flipped, 0.5 log p
  float* fl_im;   // and its phase
  float* rows;    // (B, N + 1, U + 3) K2's A rows, [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}]
  float* gates;   // (B, N, 4U) [r | z | c | ghc] of site n
  float* seeds;   // (B, N, 2) [a_n, q_n], the heads' seeds of B9's reverse sweep
  float* lp_re;   // (B,) Re log psi; log |psi|^2 in B8's mode (sampling, kNone)
  float* lp_im;   // (B,) Im log psi
  int* ticket;    // the list launch's count of finished blocks, zeroed here (kFlip)
};

// B9's seeds at site n from the amplitude logits' difference d = l0 - l1,
// the phase logit of the target qs, the target s and the ups before n: a,
// the cotangent of d of Re_n = 0.5 lp_s (the unmasked d lp0/dd = p1, d lp1/dd
// = -p0; under the U(1) mask through the renormalisation, the gradient
// passing max(raw, 1e-30) only unclamped, as ops/fused_crnn_bwd.py:11-25 of
// the JAX package); q = pi / (1 + |qs|)^2, d Im_n / d qs.  Both are the
// cotangents at g = 1: the sweep scales them by g_re and g_im.
__device__ __forceinline__ float2 crnn_seeds(float d, float qs, float s, int n, float num_up,
                                             int n_sites, bool u1) {
  const float p0 = sigmoidf_(d), p1 = sigmoidf_(-d);
  float dlp0 = 0.5f * (1.0f - s), dlp1 = 0.5f * s;
  if (u1 && 2 * n >= n_sites) {
    const float baseline = static_cast<float>(n_sites / 2 - 1);
    const float act_up = baseline - num_up >= 0.0f ? 1.0f : 0.0f;
    const float act_down = baseline - (static_cast<float>(n) - num_up) >= 0.0f ? 1.0f : 0.0f;
    const float raw = act_down * p0 + act_up * p1;
    const float gsum = raw > 1e-30f ? (dlp0 + dlp1) / fmaxf(raw, 1e-30f) : 0.0f;
    const float m0 = dlp0 * act_down - gsum * act_down * p0;
    const float m1 = dlp1 * act_up - gsum * act_up * p1;
    dlp0 = m0;
    dlp1 = m1;
  }
  const float den = 1.0f + fabsf(qs);
  return make_float2(dlp0 * p1 - dlp1 * p0, kPi / (den * den));
}

// B8 (sampling under kNone) writes only lp_re, as log |psi|^2 = 2 Re log psi.
// At most 96 registers a thread: an SM sub-partition's 16,384 then hold 5
// warps, so a block of kSlices x 128 threads and the books warp (17 warps)
// launches, and two blocks of the flagship's 9 warps share an SM (one block
// per SM would take two waves at B=500).
template <bool kSample, ExStore kStore>
__global__ void __maxnreg__(96)
exchange_base_kernel(int32_t* __restrict__ samples, uint32_t seed, uint32_t offset,
                     WeightPtrs wp, ExBase out, int b_total, int n_sites, int u, int u1) {
  extern __shared__ __align__(16) float smem[];
  const CWeights c = load_crnn_weights(smem, wp, u);
  const int u32 = warp_round(u), nw = u32 / kWarp;
  const int ks = threadIdx.x / u32, j = threadIdx.x - ks * u32;
  const int lane = threadIdx.x % kWarp;
  const bool books = ks == kSlices;  // the last warp: lane p keeps sample p
  float* h = smem + crnn_weight_floats(u);
  float* hn = h + kExP * u;
  float* part = hn + kExP * u;
  float* red = part + slice_part_floats(u, kExP);
  float* uni = red + nw * kExP * 4;
  for (int i = threadIdx.x; i < kExP * u; i += blockDim.x) h[i] = 0.0f;
  // padding slots past the batch repeat the last sample and store nothing
  int bs[kExP];
  int64_t row[kExP];
  bool own[kExP];
#pragma unroll
  for (int p = 0; p < kExP; ++p) {
    const int b = blockIdx.x * kExP + p;
    own[p] = b < b_total;
    bs[p] = min(b, b_total - 1);
    row[p] = static_cast<int64_t>(bs[p]) * n_sites;
  }
  // thread (p, j) of the first kExP slices updates unit j of sample p
  const int b_mine = blockIdx.x * kExP + min(ks, kExP - 1);
  const int64_t row_mine = static_cast<int64_t>(min(b_mine, b_total - 1)) * n_sites;
  // the A rows of sample b (kReplay): row n of (b (N + 1) + n) (U + 3); thread
  // (p, j) writes unit j's entries, thread (p, 0) the inputs
  const int64_t arow_mine = static_cast<int64_t>(min(b_mine, b_total - 1)) * (n_sites + 1);
  if constexpr (kStore == ExStore::kReplay) {
    if (ks < kExP && j < u && b_mine < b_total) out.rows[arow_mine * (u + 3) + j] = 0.0f;
  }
  if constexpr (kStore == ExStore::kFlip) {
    if (blockIdx.x == 0 && threadIdx.x == 0) *out.ticket = 0;
  }
  __syncthreads();

  float x[kExP], up[kExP];
  float re = 0.0f, rec = 0.0f, im = 0.0f, imc = 0.0f;
#pragma unroll
  for (int p = 0; p < kExP; ++p) { x[p] = 0.0f; up[p] = 0.0f; }
  for (int n = 0; n < n_sites; ++n) {
    // the uniforms of sites n..n+31, drawn at once, lane = site - n
    float* uni_n = uni + ((n / kWarp) & 1) * kWarp * kExP + (n % kWarp) * kExP;
    if (books) {
      if constexpr (kSample) {
        if (n % kWarp == 0) {
#pragma unroll
          for (int p = 0; p < kExP; ++p)
            uni_n[lane * kExP + p] = uniform23(seed, offset, static_cast<uint32_t>(bs[p]),
                                               static_cast<uint32_t>(n + lane));
        }
      }
    } else if (j < u) {
      slice_product<kExP>(c.w, u, ks, j, h, part);
    }
    __syncthreads();
    if (ks < kExP) {
      float q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j < u) {
        float xt = x[0];
#pragma unroll
        for (int p = 1; p < kExP; ++p) xt = ks == p ? x[p] : xt;
        const GateStep st = slice_update<kExP>(c.w, u, j, ks, h, part, xt, n > 0 ? 1.0f : 0.0f);
        const float hv = st.h;
        hn[j * kExP + ks] = hv;
        if (b_mine < b_total) {
          if constexpr (kStore == ExStore::kFlip) out.hist[(row_mine + n) * u + j] = hv;
          if constexpr (kStore == ExStore::kReplay) {
            float* rn = out.rows + (arow_mine + n) * (u + 3);
            rn[u + 3 + j] = hv;  // row n + 1
            if (j == 0) {
              const float xs = n > 0 ? 1.0f : 0.0f;
              rn[u] = 1.0f;
              rn[u + 1] = xs * (1.0f - xt);
              rn[u + 2] = xs * xt;
            }
            float* gt = out.gates + (row_mine + n) * 4 * u;
            gt[j] = st.r;
            gt[u + j] = st.z;
            gt[2 * u + j] = st.c;
            gt[3 * u + j] = st.ghc;
          }
        }
        q[0] = hv * c.w.hw[2 * j];
        q[1] = hv * c.w.hw[2 * j + 1];
        q[2] = hv * c.pw[2 * j];
        q[3] = hv * c.pw[2 * j + 1];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = warp_sum(q[i]);
      if (lane == 0)
        *reinterpret_cast<float4*>(red + (ks * nw + j / kWarp) * 4) =
            make_float4(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();
    // every thread: the samples' logits, spins and decisions; the books
    // lane p then keeps sample p, both lanes at once
    float lg[kExP][4], sv[kExP], upv[kExP];
#pragma unroll
    for (int p = 0; p < kExP; ++p) {
      float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int v = 0; v < nw; ++v) {
        const float4 r = reinterpret_cast<const float4*>(red)[p * nw + v];
        l[0] += r.x;
        l[1] += r.y;
        l[2] += r.z;
        l[3] += r.w;
      }
      lg[p][0] = l[0] + c.w.hb[0];
      lg[p][1] = l[1] + c.w.hb[1];
      lg[p][2] = l[2] + c.pb[0];
      lg[p][3] = l[3] + c.pb[1];
      float sp;
      if constexpr (kSample) {
        sp = crnn_decide(uni_n[p], lg[p][0], lg[p][1], n, up[p], n_sites, u1 != 0);
      } else {
        sp = static_cast<float>(samples[row[p] + n]);
      }
      sv[p] = sp;
      upv[p] = up[p];
      x[p] = sp;
      up[p] += sp;
    }
    if (books && lane < kExP) {
      float l[4], sp = sv[0], upn = upv[0];
      bool mine = own[0];
      int64_t rp = row[0];
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i] = lg[0][i];
#pragma unroll
      for (int p = 1; p < kExP; ++p) {
        if (lane == p) {
#pragma unroll
          for (int i = 0; i < 4; ++i) l[i] = lg[p][i];
          sp = sv[p];
          upn = upv[p];
          mine = own[p];
          rp = row[p];
        }
      }
      float lp0, lp1, ph0, ph1;
      crnn_logps(l[0], l[1], l[2], l[3], n, upn, n_sites, u1 != 0, lp0, lp1, ph0, ph1);
      const bool one = sp > 0.5f;
      kadd(re, rec, 0.5f * (one ? lp1 : lp0));
      kadd(im, imc, one ? ph1 : ph0);
      if (mine) {
        if constexpr (kSample) samples[rp + n] = static_cast<int32_t>(sp);
        if constexpr (kStore == ExStore::kFlip) {
          out.pfx_re[rp + n] = re - rec;
          out.pfx_im[rp + n] = im - imc;
          out.cup[rp + n] = upn;
          out.fl_re[rp + n] = 0.5f * (one ? lp0 : lp1);
          out.fl_im[rp + n] = one ? ph0 : ph1;
        }
        if constexpr (kStore == ExStore::kReplay)
          reinterpret_cast<float2*>(out.seeds)[rp + n] =
              crnn_seeds(l[0] - l[1], one ? l[3] : l[2], sp, n, upn, n_sites, u1 != 0);
      }
    }
    float* tmp = h; h = hn; hn = tmp;
  }
  if constexpr (kStore == ExStore::kReplay) {
    // row N's inputs: the last spin
    if (ks < kExP && j == 0 && b_mine < b_total) {
      float xt = x[0];
#pragma unroll
      for (int p = 1; p < kExP; ++p) xt = ks == p ? x[p] : xt;
      float* rn = out.rows + (arow_mine + n_sites) * (u + 3) + u;
      rn[0] = 1.0f;
      rn[1] = 1.0f - xt;
      rn[2] = xt;
    }
  }
  if (books) {
#pragma unroll
    for (int p = 0; p < kExP; ++p) {
      if (lane != p || !own[p]) continue;
      if constexpr (kSample && kStore == ExStore::kNone) {
        out.lp_re[bs[p]] = 2.0f * (re - rec);
      } else {
        out.lp_re[bs[p]] = re - rec;
        out.lp_im[bs[p]] = im - imc;
      }
    }
  }
}

// start[a] = the count[a'] of a' < a summed, for a = 0..n (start[n] the
// total), whole block; count is read past L1, as other blocks wrote it.
__device__ void exclusive_scan(const int32_t* count, int32_t* start, int n) {
  __shared__ int warp_sums[32];
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * per, hi = min(lo + per, n);
  int sum = 0;
  for (int a = lo; a < hi; ++a) sum += __ldcg(count + a);  // other blocks' lengths
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int incl = sum;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == kWarp - 1) warp_sums[warp] = incl;
  __syncthreads();
  int before = incl - sum;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  for (int a = lo; a < hi; ++a) {
    start[a] = before;
    before += __ldcg(count + a);
  }
  if (threadIdx.x == blockDim.x - 1) start[n] = before;
}

// Start site a's list: the terms (k B + b) of the bonds k that start at a,
// by bond, then sample, whose bond is anti-aligned with a nonzero element;
// meta[a] is the list's offset in lists (B times the bonds that start
// before a), meta[N + a] its length and meta[2 N + a] its packed offset
// (exclusive_scan, by the last block; ticket, zeroed by the base pass,
// counts the blocks that have written their lengths).  The other terms
// are set to 0.
__global__ void exchange_list_kernel(const int32_t* __restrict__ samples, Bonds bs,
                                     int32_t* __restrict__ lists, int32_t* __restrict__ meta,
                                     int* __restrict__ ticket, float* __restrict__ terms_re,
                                     float* __restrict__ terms_im, int b_total, int n_bonds) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int a = blockIdx.x * kExListWarps + warp;
  if (a < bs.n) {
    int before = 0;
    for (int k = lane; k < n_bonds; k += kWarp) {
      int ka, kb;
      float el;
      bond_at(bs, k, ka, kb, el);
      before += ka < a;
    }
    before = __reduce_add_sync(0xffffffffu, before);
    int32_t* list = lists + static_cast<int64_t>(before) * b_total;
    int count = 0;
    for (int k = 0; k < n_bonds; ++k) {
      int ka, kb;
      float el;
      bond_at(bs, k, ka, kb, el);
      if (ka != a) continue;
      const int64_t base = static_cast<int64_t>(k) * b_total;
      for (int b0 = 0; b0 < b_total; b0 += kWarp) {
        const int b = b0 + lane;
        bool live = false;
        if (b < b_total) {
          const int32_t* s_row = samples + static_cast<int64_t>(b) * bs.n;
          live = el != 0.0f && kb < bs.n && s_row[a] != s_row[kb];
          if (!live) {
            terms_re[base + b] = 0.0f;
            terms_im[base + b] = 0.0f;
          }
        }
        const unsigned mask = __ballot_sync(0xffffffffu, live);
        if (live) list[count + __popc(mask & ((1u << lane) - 1u))] = static_cast<int32_t>(base + b);
        count += __popc(mask);
      }
    }
    if (lane == 0) {
      meta[a] = before * b_total;
      meta[bs.n + a] = count;
    }
  }
  // the last block to finish sums the lengths
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (last) exclusive_scan(meta + bs.n, meta + 2 * bs.n, bs.n);
}

// What the suffix pass reads of the base pass.
struct ExIn {
  const float* hist;
  const float* pfx_re;
  const float* pfx_im;
  const float* cup;
  const float* fl_re;
  const float* fl_im;
  const float* lp_re;
  const float* lp_im;
};

// MG: 64-row tiles per gate, U rounded up to 64 MG.  tiles: the blocks of
// each start site (enough for its longest possible list).
template <int MG>
__global__ void __launch_bounds__(4 * kWarp)
exchange_suffix_kernel(const int32_t* __restrict__ samples, WeightPtrs wp, Bonds bs, ExIn in,
                       const int32_t* __restrict__ lists, const int32_t* __restrict__ meta,
                       float* __restrict__ terms_re, float* __restrict__ terms_im, int b_total,
                       int tiles, int u, int u1) {
  constexpr int MT = 3 * MG, UG = MG * kGateRows;
  const int n_sites = bs.n;
  const int a = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - a * tiles) * kExTraj;
  const int count = meta[n_sites + a];
  if (t0 >= count) return;  // uniform over the block, before any barrier
  const int32_t* list = lists + meta[a];

  extern __shared__ __align__(16) float smem[];
  const int kp = pad8(u), ks_n = kp / 8, g3 = 3 * u, sf = kExTraj * kp;
  const float* wx = wp.p[0];
  const float* wh = wp.p[1];
  const float* bx = wp.p[2];
  const float* bh = wp.p[3];
  float* states = smem;                            // [state, lo][kExTraj x kp]
  float* wfrag = states + 2 * sf;                  // [k-step][tile][warp][lane][4]
  float* gxs = wfrag + ks_n * MT * 4 * kWarp * 4;  // [x][gate][unit]
  float* bhs = gxs + 6 * UG;                       // [gate][unit]
  float* hws = bhs + 3 * UG;                       // [unit][amplitude 2 | phase 2]
  float* hbs = hws + 4 * UG;                       // amplitude b (2), phase b (2)
  float* red = hbs + 4;                            // [parity][warp][trajectory][4]
  // A fragment i of lane (g, t) in warp w: rows 16 w + g (+8 for odd i),
  // columns t (+4 for i >= 2) of the tile; row (gate m / MG, unit
  // 64 (m % MG) + row) of W_h^T is W_h's column
  for (int i = threadIdx.x; i < ks_n * MT * 4 * kWarp * 4; i += blockDim.x) {
    const int e = i & 3, l = (i >> 2) & (kWarp - 1), w = (i >> 7) & 3, tile = i >> 9;
    const int ks = tile / MT, m = tile - ks * MT;
    const int k = 8 * ks + (l & 3) + 4 * (e >> 1);
    const int uu = (m % MG) * kGateRows + 16 * w + (l >> 2) + 8 * (e & 1);
    wfrag[i] = (k < u && uu < u) ? wh[k * g3 + (m / MG) * u + uu] : 0.0f;
  }
  for (int i = threadIdx.x; i < 3 * UG; i += blockDim.x) {
    const int gate = i / UG, unit = i - gate * UG, col = gate * u + unit;
    gxs[i] = unit < u ? wx[col] + bx[col] : 0.0f;
    gxs[3 * UG + i] = unit < u ? wx[g3 + col] + bx[col] : 0.0f;
    bhs[i] = unit < u ? bh[col] : 0.0f;
  }
  for (int i = threadIdx.x; i < UG; i += blockDim.x) {
    const bool on = i < u;
    hws[4 * i] = on ? wp.p[4][2 * i] : 0.0f;
    hws[4 * i + 1] = on ? wp.p[4][2 * i + 1] : 0.0f;
    hws[4 * i + 2] = on ? wp.p[6][2 * i] : 0.0f;
    hws[4 * i + 3] = on ? wp.p[6][2 * i + 1] : 0.0f;
  }
  if (threadIdx.x < 2) {
    hbs[threadIdx.x] = wp.p[5][threadIdx.x];
    hbs[2 + threadIdx.x] = wp.p[7][threadIdx.x];
  }
  // the trajectories' states h[a] as their TF32 part rounded to nearest and
  // its exact remainder (split_tf32_nearest; their sum is the state),
  // zero-padded to kp units; padding columns repeat the last listed term
  for (int i = threadIdx.x; i < kExTraj * kp; i += blockDim.x) {
    const int n = i / kp, k = i - n * kp;
    const int b = list[min(t0 + n, count - 1)] % b_total;
    const float v = k < u ? in.hist[(static_cast<int64_t>(b) * n_sites + a) * u + k] : 0.0f;
    const float hi = round_tf32(v);
    states[state_at(n, k, kp)] = hi;
    states[sf + state_at(n, k, kp)] = v - hi;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  // the thread's trajectories 8 cb + 2 t + v (e = 2 cb + v): their samples,
  // second flip sites and inputs
  int sample_of[8], second[8];
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int term = list[min(t0 + 8 * (e >> 1) + 2 * t + (e & 1), count - 1)];
    int ka;
    float el;
    bond_at(bs, term / b_total, ka, second[e], el);
    sample_of[e] = term % b_total;
    x[e] = 1.0f - static_cast<float>(samples[static_cast<int64_t>(sample_of[e]) * n_sites + a]);
  }
  // lane n of warp 3 (whose rows hold the padding units, so it updates the
  // fewest) keeps trajectory n's up-count and Kahan pairs
  const int my_term = list[min(t0 + lane, count - 1)];
  const int my_b = my_term % b_total;
  const int64_t my_row = static_cast<int64_t>(my_b) * n_sites;
  int my_second, my_a;
  float my_el;
  bond_at(bs, my_term / b_total, my_a, my_second, my_el);
  float re = 0.0f, rec = 0.0f, im = 0.0f, imc = 0.0f, up = 0.0f;
  if (warp == 3) {
    re = (a > 0 ? in.pfx_re[my_row + a - 1] : 0.0f) + in.fl_re[my_row + a];
    im = (a > 0 ? in.pfx_im[my_row + a - 1] : 0.0f) + in.fl_im[my_row + a];
    up = in.cup[my_row + a] + (1.0f - static_cast<float>(samples[my_row + a]));
  }

  for (int n = a + 1; n < n_sites; ++n) {
    const int par = (n - a - 1) & 1;
    // accumulators from b_h: tile m holds gate m / MG, units 64 (m % MG) + row
    float d[MT][16];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int base = (m / MG) * UG + (m % MG) * kGateRows + 16 * warp + g;
      const float b0 = bhs[base], b1 = bhs[base + 8];
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) {
        d[m][4 * cb] = b0; d[m][4 * cb + 1] = b0;
        d[m][4 * cb + 2] = b1; d[m][4 * cb + 3] = b1;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) pin(d[m][i]);
    }
    product_k_steps<MT, kExTraj, true>(d, wfrag, states, states + sf, kp * 32, 0, ks_n, warp,
                                       lane, [] {});
    // the gate update on the accumulators: the r, z, c of a unit are the
    // same register of tiles mg, MG + mg, 2 MG + mg
    float q[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) q[i][e] = 0.0f;
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int unit = mg * kGateRows + 16 * warp + g + 8 * rh;
        if (unit >= kp) continue;
        const float4 hw = reinterpret_cast<const float4*>(hws)[unit];
        const float* gx = gxs + unit;
        const float gx0[3] = {gx[0], gx[UG], gx[2 * UG]};
        const float gx1[3] = {gx[3 * UG], gx[4 * UG], gx[5 * UG]};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 4 * (e >> 1) + 2 * rh + (e & 1);
          const int at = state_at(8 * (e >> 1) + 2 * t + (e & 1), unit, kp);
          const bool up_spin = x[e] > 0.5f;
          const float rg = sigmoid_tanh((up_spin ? gx1[0] : gx0[0]) + d[mg][i]);
          const float zg = sigmoid_tanh((up_spin ? gx1[1] : gx0[1]) + d[MG + mg][i]);
          const float cg = tanhf((up_spin ? gx1[2] : gx0[2]) + rg * d[2 * MG + mg][i]);
          // in place: only this thread reads or writes the element here
          const float hu = zg * (states[at] + states[sf + at]) + (1.0f - zg) * cg;
          const float hv = unit < u ? hu : 0.0f;
          const float hi = round_tf32(hv);
          states[at] = hi;
          states[sf + at] = hv - hi;
          q[0][e] = fmaf(hv, hw.x, q[0][e]);
          q[1][e] = fmaf(hv, hw.y, q[1][e]);
          q[2][e] = fmaf(hv, hw.z, q[2][e]);
          q[3][e] = fmaf(hv, hw.w, q[3][e]);
        }
      }
    // the heads: sums over the warp's units (the lanes of one t), then over
    // the warps in order
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int off = 4; off < kWarp; off <<= 1)
          q[i][e] += __shfl_xor_sync(0xffffffffu, q[i][e], off);
    float* red_n = red + (par * 4 + warp) * kExTraj * 4;
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        reinterpret_cast<float4*>(red_n)[8 * (e >> 1) + 2 * t + (e & 1)] =
            make_float4(q[0][e], q[1][e], q[2][e], q[3][e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float s = static_cast<float>(samples[static_cast<int64_t>(sample_of[e]) * n_sites + n]);
      x[e] = n == second[e] ? 1.0f - s : s;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (warp == 3) {
      const float4* red_p = reinterpret_cast<const float4*>(red + par * 4 * kExTraj * 4);
      float l[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float4 r = red_p[w * kExTraj + lane];
        l[0] += r.x;
        l[1] += r.y;
        l[2] += r.z;
        l[3] += r.w;
      }
      float lp0, lp1, ph0, ph1;
      crnn_logps(l[0] + hbs[0], l[1] + hbs[1], l[2] + hbs[2], l[3] + hbs[3], n, up, n_sites,
                 u1 != 0, lp0, lp1, ph0, ph1);
      float s = static_cast<float>(samples[my_row + n]);
      if (n == my_second) s = 1.0f - s;
      const bool one = s > 0.5f;
      kadd(re, rec, 0.5f * (one ? lp1 : lp0));
      kadd(im, imc, one ? ph1 : ph0);
      up += s;
    }
  }
  if (warp == 3 && t0 + lane < count) {
    const float d_re = (re - rec) - in.lp_re[my_b];
    const float d_im = (im - imc) - in.lp_im[my_b];
    const float mag = my_el * expf(d_re);
    terms_re[my_term] = mag * cosf(d_im);
    terms_im[my_term] = mag * sinf(d_im);
  }
}

// The start site of packed term p < start[n]: the last a with start[a] <= p
// (its list is not empty, since start[a + 1] > p).
__device__ __forceinline__ int start_site_of(const int32_t* start, int n, int p) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= p) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The turned-around suffix pass (KS = pad8(U) / 8 <= kRsSteps).  Warpgroup
// wg of block b is slot kRsGroups b + wg; the slots walk the tiles of 64
// packed terms in order, longest suffix first, in rounds of the slots,
// every other round reversed.  Thread (warp, g, t) holds rows 16 warp + g
// and + 8 (rh = 0, 1) and, of k-step j, the units 8 j + 2 t + v; lanes t
// and t ^ 2 keep the books of row 16 warp + g + 8 (t & 1), and t < 2 write.
template <int KS>
__global__ void __launch_bounds__(kRsGroups * 4 * kWarp, 1)
exchange_suffix_rs_kernel(const int32_t* __restrict__ samples, WeightPtrs wp, Bonds bs, ExIn in,
                          const int32_t* __restrict__ lists, const int32_t* __restrict__ meta,
                          float* __restrict__ terms_re, float* __restrict__ terms_im,
                          int b_total, int u, int u1) {
  constexpr int KP = 8 * KS, TF = rs_table_floats(KS);
  const int n_sites = bs.n;
  extern __shared__ __align__(16) float smem[];
  float* whi = smem;
  float* wlo = whi + TF;
  float* gxs = wlo + TF;
  float* bhs = gxs + 48 * KS;
  float* hds = bhs + 24 * KS;
  float* hbs = hds + 4 * KP;
  const int32_t* start = meta + 2 * n_sites;  // the lists' packed offsets
  rs_gru_tables<KS, true>(whi, wlo, gxs, bhs, wp.p[0], wp.p[1], wp.p[2], wp.p[3], u);
  // entry ((j 4 + t) 2 + head) 4 + 2 v + l: logit l of head (amplitude,
  // phase) on unit 8 j + 2 t + v
  for (int i = threadIdx.x; i < 4 * KP; i += blockDim.x) {
    const int unit = 8 * (i >> 5) + 2 * ((i >> 3) & 3) + ((i >> 1) & 1);
    const float* w = (i >> 2) & 1 ? wp.p[6] : wp.p[4];
    hds[i] = unit < u ? w[2 * unit + (i & 1)] : 0.0f;
  }
  if (threadIdx.x < 2) {
    hbs[threadIdx.x] = wp.p[5][threadIdx.x];
    hbs[2 + threadIdx.x] = wp.p[7][threadIdx.x];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / (4 * kWarp), warp = (threadIdx.x / kWarp) % 4;
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, mine = t & 1;
  const float4* gx4 = reinterpret_cast<const float4*>(gxs) + t;      // [octet][gate][t]
  const float2* bh2 = reinterpret_cast<const float2*>(bhs) + t;      // [octet][gate][t]
  const float4* hd4 = reinterpret_cast<const float4*>(hds) + 2 * t;  // [octet][t][head]
  const float hb[4] = {hbs[0], hbs[1], hbs[2], hbs[3]};
  const int total = start[n_sites];
  const int tiles = (total + kGateRows - 1) / kGateRows;
  const int slots = gridDim.x * kRsGroups, slot = blockIdx.x * kRsGroups + wg;
  for (int round = 0;; ++round) {
    const int tile = rs_slot_tile(round, slots, slot);
    if (tile >= tiles) break;
    const int p0 = tile * kGateRows, a0 = start_site_of(start, n_sites, p0);
    // the thread's rows: start site, sample, second flip site; padding rows
    // repeat the last term
    int at[2], second[2], term[2];
    int64_t row[2];
    float el[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int p = min(p0 + r0 + 8 * rh, total - 1);
      const int a = start_site_of(start, n_sites, p);
      term[rh] = lists[meta[a] + p - start[a]];
      int ka;
      bond_at(bs, term[rh] / b_total, ka, second[rh], el[rh]);
      at[rh] = a;
      row[rh] = static_cast<int64_t>(term[rh] % b_total) * n_sites;
    }
    // the books of row r0 + 8 mine: its sums from pfx[a-1] + fl[a], its
    // up-count from cup[a] + 1 - s_a
    const int am = mine ? at[1] : at[0];
    const int64_t rm = mine ? row[1] : row[0];
    float re = (am > 0 ? in.pfx_re[rm + am - 1] : 0.0f) + in.fl_re[rm + am], rec = 0.0f;
    float im = (am > 0 ? in.pfx_im[rm + am - 1] : 0.0f) + in.fl_im[rm + am], imc = 0.0f;
    float up = in.cup[rm + am] + (1.0f - static_cast<float>(samples[rm + am]));
    // the target at site n: s_n, flipped at the second flip site
    const auto target = [&](int rh, int n) {
      const float s = static_cast<float>(samples[row[rh] + n]);
      return n == second[rh] ? 1.0f - s : s;
    };
    float h[KS][4], lo[KS][4], d[12 * KS], x[2] = {0.0f, 0.0f};
    const float nxt0 = target(0, a0 + 1), nxt1 = target(1, a0 + 1);
    float nxt[2] = {nxt0, nxt1};
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) { h[j][i] = 0.0f; lo[j][i] = 0.0f; }
    // the accumulators start from b_h: d[4 (3 j + gate) + 2 rh + v] is
    // (row r0 + 8 rh, unit 8 j + 2 t + v) of the gate
    const auto start_from_bh = [&](int j) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 b = bh2[4 * (3 * j + q)];
        d[4 * (3 * j + q)] = b.x;
        d[4 * (3 * j + q) + 1] = b.y;
        d[4 * (3 * j + q) + 2] = b.x;
        d[4 * (3 * j + q) + 3] = b.y;
      }
    };
#pragma unroll
    for (int j = 0; j < KS; ++j) start_from_bh(j);
    // the four logits' partial sums of the last site [rh][amplitude 2 |
    // phase 2], settled while the next site's products run: summed over the
    // quad, then, once the row has joined, its site terms added to the books
    bool pending = false;
    int pn = 0;
    float q[2][4] = {}, ptgt = 0.0f;
    const auto settle = [&] {
      if (!pending) return;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          q[rh][l] += __shfl_xor_sync(0xffffffffu, q[rh][l], 1);
          q[rh][l] += __shfl_xor_sync(0xffffffffu, q[rh][l], 2);
        }
      if (pn > am) {
        float l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i] = (mine ? q[1][i] : q[0][i]) + hb[i];
        float lp0, lp1, ph0, ph1;
        crnn_logps(l[0], l[1], l[2], l[3], pn, up, n_sites, u1 != 0, lp0, lp1, ph0, ph1);
        const bool one = ptgt > 0.5f;
        kadd(re, rec, 0.5f * (one ? lp1 : lp0));
        kadd(im, imc, one ? ph1 : ph0);
        up += ptgt;
      }
      pending = false;
    };

    for (int n = a0 + 1; n < n_sites; ++n) {
      // rows of start n - 1 join: h[n-1], its part rounded to TF32 and the
      // exact remainder, and input 1 - s_{n-1}
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        if (at[rh] == n - 1) {
          const float* hf = in.hist + (row[rh] + n - 1) * u;
#pragma unroll
          for (int j = 0; j < KS; ++j)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int unit = 8 * j + 2 * t + v;
              const float val = unit < u ? hf[unit] : 0.0f;
              const float hi = round_tf32(val);
              h[j][2 * v + rh] = hi;
              lo[j][2 * v + rh] = val - hi;
            }
          x[rh] = 1.0f - static_cast<float>(samples[row[rh] + n - 1]);
        } else if (at[rh] == n) {
          const float* hf = in.hist + (row[rh] + n) * u + 2 * t;
#pragma unroll
          for (int j = 0; j < KS; ++j)
            asm volatile("prefetch.global.L1 [%0];\n" ::"l"(hf + 8 * j));
        }
      }
      __syncwarp();
      const float tgt[2] = {nxt[0], nxt[1]};
      if (n + 1 < n_sites) {
        nxt[0] = target(0, n + 1);
        nxt[1] = target(1, n + 1);
      }
      rs_issue<KS>(d, h, lo, whi, wlo);
      settle();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) { pin(h[j][i]); pin(lo[j][i]); }
#pragma unroll
      for (int i = 0; i < 12 * KS; ++i) pin(d[i]);
      // the gate update on the accumulators, reading the state as hi + lo;
      // the new state becomes the next site's A fragment in place, and the
      // logits' partials follow the units in order
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int l = 0; l < 4; ++l) q[rh][l] = 0.0f;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float4 gr = gx4[4 * (3 * j)], gz = gx4[4 * (3 * j + 1)], gc = gx4[4 * (3 * j + 2)];
        const float4 ha = hd4[8 * j], hp = hd4[8 * j + 1];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const bool real = j + 1 < KS || 8 * j + 2 * t + v < u;  // only the last octet pads
          const float r0x = v ? gr.z : gr.x, r1x = v ? gr.w : gr.y;
          const float z0x = v ? gz.z : gz.x, z1x = v ? gz.w : gz.y;
          const float c0x = v ? gc.z : gc.x, c1x = v ? gc.w : gc.y;
          const float w[4] = {v ? ha.z : ha.x, v ? ha.w : ha.y, v ? hp.z : hp.x,
                              v ? hp.w : hp.y};
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int i = 2 * rh + v;
            const bool up_spin = x[rh] > 0.5f;
            const float rg = sigmoid_tanh((up_spin ? r1x : r0x) + d[4 * (3 * j) + i]);
            const float zg = sigmoid_tanh((up_spin ? z1x : z0x) + d[4 * (3 * j + 1) + i]);
            const float cg = tanhf((up_spin ? c1x : c0x) + rg * d[4 * (3 * j + 2) + i]);
            const float hu = zg * (h[j][2 * v + rh] + lo[j][2 * v + rh]) + (1.0f - zg) * cg;
            const float hv = real ? hu : 0.0f;
            const float hi = round_tf32(hv);
            h[j][2 * v + rh] = hi;
            lo[j][2 * v + rh] = hv - hi;
#pragma unroll
            for (int l = 0; l < 4; ++l) q[rh][l] = fmaf(hv, w[l], q[rh][l]);
          }
        }
        start_from_bh(j);
      }
      x[0] = tgt[0];
      x[1] = tgt[1];
      ptgt = mine ? tgt[1] : tgt[0];
      pn = n;
      pending = true;
    }
    settle();
    if (t < 2 && p0 + r0 + 8 * mine < total) {
      const int my_term = mine ? term[1] : term[0];
      const int my_b = my_term % b_total;
      const float d_re = (re - rec) - in.lp_re[my_b];
      const float d_im = (im - imc) - in.lp_im[my_b];
      const float mag = (mine ? el[1] : el[0]) * expf(d_re);
      terms_re[my_term] = mag * cosf(d_im);
      terms_im[my_term] = mag * sinf(d_im);
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

template <bool kSample, ExStore kStore>
cudaError_t launch_exchange_base(int32_t* samples, uint32_t seed, uint32_t offset,
                                 const WeightPtrs& wp, const ExBase& out, int b_total,
                                 int n_sites, int u, int u1, cudaStream_t st) {
  const size_t smem = exchange_base_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(exchange_base_kernel<kSample, kStore>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  exchange_base_kernel<kSample, kStore><<<(b_total + kExP - 1) / kExP, ex_base_threads(u),
                                          smem, st>>>(samples, seed, offset, wp, out,
                                                      b_total, n_sites, u, u1);
  return cudaGetLastError();
}

template <int MG>
cudaError_t launch_exchange_suffix(const int32_t* samples, const WeightPtrs& wp,
                                   const Bonds& bs, const ExIn& in, const int32_t* lists,
                                   const int32_t* meta, float* terms_re, float* terms_im,
                                   int b_total, int tiles, int u, int u1, cudaStream_t st) {
  const size_t smem = exchange_suffix_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(exchange_suffix_kernel<MG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  exchange_suffix_kernel<MG><<<bs.n * tiles, 4 * kWarp, smem, st>>>(
      samples, wp, bs, in, lists, meta, terms_re, terms_im, b_total, tiles, u, u1);
  return cudaGetLastError();
}

// The turned-around suffix pass: one block per SM (as many as fit), or
// fewer where the most tiles the lists could fill do not fill them; the
// blocks read the number of tiles from the list launch's packed offsets.
template <int KS>
cudaError_t launch_exchange_suffix_rs(const int32_t* samples, const WeightPtrs& wp,
                                      const Bonds& bs, const ExIn& in, const int32_t* lists,
                                      const int32_t* meta, float* terms_re, float* terms_im,
                                      int b_total, int n_bonds, int u, int u1,
                                      cudaStream_t st) {
  static_assert(KS <= kRsSteps, "the turned-around suffix pass takes pad8(U) <= 8 kRsSteps");
  const auto kernel = exchange_suffix_rs_kernel<KS>;
  const size_t smem = exchange_suffix_rs_smem_bytes(8 * KS);
  int grid = 0;
  const cudaError_t err = rs_persistent_grid(
      kernel, smem, (static_cast<int64_t>(n_bonds) * b_total + kGateRows - 1) / kGateRows, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRsGroups * 4 * kWarp, smem, st>>>(samples, wp, bs, in, lists, meta, terms_re,
                                                     terms_im, b_total, u, u1);
  return cudaGetLastError();
}

// Launch 3 by U alone: the turned-around suffix pass at its KS, else
// exchange_suffix_kernel with MG 64-row tiles per gate.
template <int KS = 1>
cudaError_t launch_exchange_suffix_by_u(const int32_t* samples, const WeightPtrs& wp,
                                        const Bonds& bs, const ExIn& in, const int32_t* lists,
                                        const int32_t* meta, float* terms_re, float* terms_im,
                                        int b_total, int n_bonds, int tiles, int u, int u1,
                                        cudaStream_t st) {
  if constexpr (KS <= kRsSteps) {
    return rs_steps(u) == KS
               ? launch_exchange_suffix_rs<KS>(samples, wp, bs, in, lists, meta, terms_re,
                                               terms_im, b_total, n_bonds, u, u1, st)
               : launch_exchange_suffix_by_u<KS + 1>(samples, wp, bs, in, lists, meta,
                                                     terms_re, terms_im, b_total, n_bonds,
                                                     tiles, u, u1, st);
  } else {
    return pad64(u) == kGateRows
               ? launch_exchange_suffix<1>(samples, wp, bs, in, lists, meta, terms_re,
                                           terms_im, b_total, tiles, u, u1, st)
               : launch_exchange_suffix<2>(samples, wp, bs, in, lists, meta, terms_re,
                                           terms_im, b_total, tiles, u, u1, st);
  }
}

// The most bonds that start at one site, those that start at site 0 (NN,
// NNN and the wraps (0, N-1), (0, N-2)): the suffix pass gives each start
// site the blocks of that many lists.
inline int max_bonds_per_start(const Bonds& bs) {
  return (bs.n > 1) + (bs.has_nnn && bs.n > 2) + (bs.periodic ? 1 + (bs.has_nnn != 0) : 0);
}

template <bool kSample>
int launch_exchange(void* samples_v, uint32_t seed, uint32_t offset, const WeightPtrs& wp,
                    void* hist_v, void* pfx_v, void* terms_v, void* order_v, void* out_v,
                    int b_total, int n_sites, int u, int u1, float el_nn, float el_nnn,
                    int has_nnn, int periodic, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pad64(u) > 2 * kGateRows) return static_cast<int>(cudaErrorInvalidValue);
  const int n_bonds = num_bonds(n_sites, has_nnn, periodic);
  const int64_t kb = static_cast<int64_t>(n_bonds) * b_total;
  if (kb > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);  // terms are int32
  int32_t* samples = static_cast<int32_t*>(samples_v);
  const int64_t bn = static_cast<int64_t>(b_total) * n_sites;
  float* pfx = static_cast<float*>(pfx_v);
  float* out = static_cast<float*>(out_v);
  ExBase base{};
  base.hist = static_cast<float*>(hist_v);
  base.pfx_re = pfx;
  base.pfx_im = pfx + bn;
  base.cup = pfx + 2 * bn;
  base.fl_re = pfx + 3 * bn;
  base.fl_im = pfx + 4 * bn;
  base.lp_re = out + 2 * b_total;
  base.lp_im = out + 3 * b_total;
  float* terms_re = static_cast<float*>(terms_v);
  float* terms_im = terms_re + kb;
  int32_t* lists = static_cast<int32_t*>(order_v);
  int32_t* meta = lists + kb;
  base.ticket = meta + 3 * n_sites + 1;
  const Bonds bs{n_sites, has_nnn, periodic, el_nn, el_nnn};

  cudaError_t err = launch_exchange_base<kSample, ExStore::kFlip>(samples, seed, offset, wp,
                                                                 base, b_total, n_sites, u, u1,
                                                                 st);
  if (err != cudaSuccess) return static_cast<int>(err);

  exchange_list_kernel<<<(n_sites + kExListWarps - 1) / kExListWarps, kExListWarps * kWarp, 0,
                         st>>>(samples, bs, lists, meta, base.ticket, terms_re, terms_im, b_total,
                               n_bonds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles = (max_bonds_per_start(bs) * b_total + kExTraj - 1) / kExTraj;
  if (tiles > 0) {
    const ExIn in{base.hist, base.pfx_re, base.pfx_im, base.cup, base.fl_re, base.fl_im,
                  base.lp_re, base.lp_im};
    err = launch_exchange_suffix_by_u(samples, wp, bs, in, lists, meta, terms_re, terms_im,
                                      b_total, n_bonds, tiles, u, u1, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  exchange_sum_kernel<<<(b_total + 127) / 128, 128, 0, st>>>(terms_re, terms_im, out,
                                                             out + b_total, b_total, n_bonds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rnnwf

// The number of bonds one call sums, the row count of its term and list
// scratch.
extern "C" int rnnwf_j1j2_num_bonds(int n_sites, int has_nnn, int periodic) {
  return rnnwf::num_bonds(n_sites, has_nnn, periodic);
}

// Scratch (allocated by the caller): hist B*N*U floats; pfx 5*B*N floats
// (the Re and Im prefixes, the up-counts, site n's flipped Re and Im
// terms); terms 2*K*B floats; order K*B + 3*N + 2 ints (the start sites'
// lists, then their offsets, lengths and N + 1 packed offsets, and a
// counter), K = rnnwf_j1j2_num_bonds.  out:
// 4*B floats (eoff_re, eoff_im, lp_re, lp_im).  seed and offset are unused.
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
  rnnwf::ExBase out{};
  out.lp_re = static_cast<float*>(lp);
  return static_cast<int>(rnnwf::launch_exchange_base<true, rnnwf::ExStore::kNone>(
      static_cast<int32_t*>(samples), seed, offset,
      rnnwf::weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb), out, b_total, n_sites, u, u1,
      static_cast<cudaStream_t>(stream)));
}

// B7: the teacher-forced base pass storing nothing but (Re, Im) log psi of
// the samples (B floats each); no scratch.
extern "C" int rnnwf_crnn_log_amp_parts(const void* samples, const void* wx, const void* wh,
                                        const void* bx, const void* bh, const void* aw,
                                        const void* ab, const void* pw, const void* pb,
                                        void* re, void* im, int b_total, int n_sites, int u,
                                        int u1, void* stream) {
  rnnwf::ExBase out{};
  out.lp_re = static_cast<float*>(re);
  out.lp_im = static_cast<float*>(im);
  return static_cast<int>(rnnwf::launch_exchange_base<false, rnnwf::ExStore::kNone>(
      const_cast<int32_t*>(static_cast<const int32_t*>(samples)), 0u, 0u,
      rnnwf::weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb), out, b_total, n_sites, u, u1,
      static_cast<cudaStream_t>(stream)));
}

// B9's replay (stage a of csrc/fused_crnn_bwd.cu): the teacher-forced base
// pass of B10 storing K2's A rows (B*(N+1)*(U+3) floats), the gates
// (B*N*4U), the heads' seeds [a_n, q_n] (B*N*2) and (Re, Im) log psi (B
// floats each).
extern "C" int rnnwf_crnn_replay(const void* samples, const void* wx, const void* wh,
                                 const void* bx, const void* bh, const void* aw, const void* ab,
                                 const void* pw, const void* pb, void* rows, void* gates,
                                 void* seeds, void* re, void* im, int b_total, int n_sites,
                                 int u, int u1, void* stream) {
  rnnwf::ExBase out{};
  out.rows = static_cast<float*>(rows);
  out.gates = static_cast<float*>(gates);
  out.seeds = static_cast<float*>(seeds);
  out.lp_re = static_cast<float*>(re);
  out.lp_im = static_cast<float*>(im);
  return static_cast<int>(rnnwf::launch_exchange_base<false, rnnwf::ExStore::kReplay>(
      const_cast<int32_t*>(static_cast<const int32_t*>(samples)), 0u, 0u,
      rnnwf::weight_ptrs(wx, wh, bx, bh, aw, ab, pw, pb), out, b_total, n_sites, u, u1,
      static_cast<cudaStream_t>(stream)));
}
