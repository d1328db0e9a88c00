// K3 and K4: the single-flip amplitude-ratio sum of the TFIM estimator,
//     ratio[b] = sum_f exp(0.5 * (log p(sigma_b with site f flipped) - log p(sigma_b))),
// with the base log p as a by-product.  K4 reads the given samples; K3
// (sample mode) draws them first, autoregressively, in the same base pass.
// B6 returns the per-flip log p, lpf[b, f] = log p(sigma_b with site f
// flipped), in place of the ratio sum (the parity-symmetrized estimator
// combines two directions before the ratio), teacher-forced or in sample
// mode.  B5 is the stand-alone sampler: the sample-mode base pass alone.
// K1 is the teacher-forced base pass alone: the joint log p of given
// samples; K2's forward replay (csrc/fused_gru_bwd.cu) is that pass storing
// the states, the gates and the head's probability for the reverse sweep.
//
// Replaces: rnnwavefunctions_tpu/ops/tfim_flip_kernel.py::tfim_flip_ratio_sum
// (K4), ::tfim_sample_and_flip_sum with per_flip=False (K3) and
// per_flip=True (B6, sample mode), ::tfim_flip_log_probs (B6, teacher-forced),
// all _make_flip_kernel + _flip_wavefront; and
// rnnwavefunctions_tpu/ops/fused_gru.py::_sample_pallas (B5,
// _make_sample_kernel) and ::_log_prob_pallas (K1, _make_log_prob_kernel).
//
// Bound on the H100: the flip suffixes.  Flipping site f leaves sites < f
// untouched, so only sites f+1..N-1 are recomputed, starting from the stored
// hidden state h_f with the flipped input (prefix sharing): B*N*(N-1)/2
// GRU site steps, about 37 GFLOP per flagship step (B=500, N=100, U=50),
// over 90% of the step's arithmetic, 6U^2 of every site's 6U^2 + 34U + 10
// operations in the 3U x U recurrent product.  The base pass (and B5, K1)
// does only the B*N base steps, N dependent sites per sample: it is bound
// by latency, not by work.
//
// Design: three launches.
//   1. Base pass, a block per kBaseP samples: its kSlices x U32 threads
//      split each site's product by unit and by quarter of k
//      (slice_product, gru_common.cuh), and after a barrier the first
//      kBaseP slices update one sample each, store h_n to the history and
//      reduce their head terms by shuffles per warp; after a second barrier
//      every thread sums the warps' head terms in warp order, so all hold
//      the same logits and (in sample mode) take the same decision from a
//      Philox uniform.  One more warp keeps the samples' books off that
//      path: it draws the uniforms of 32 sites at once (a lane per site)
//      ahead of the decisions, Kahan-adds log p and stores the spins, the
//      corrected prefix pfx[n] = log p(sites <= n), the flipped-site
//      log-prob fl[n] and the base log p.  B5 and K1 run
//      this launch alone and store no history, only the spins (B5) and log p;
//      the arithmetic is the same code, so B5 draws K3's spins bit for bit.
//   2. Suffix pass on the tensor cores, turned around for the H100
//      (flip_suffix_rs_kernel, where pad8(U) <= 56).  Each site is the
//      product Gates (64 x N) = H (64 trajectories x Kp) . W_h (Kp x N) by
//      wgmma m64nNk8 in TF32, made float32-accurate by the 3xTF32 split:
//      each operand x = hi + lo with hi = x with its low 13 mantissa bits
//      cleared and lo = (x - hi) cleared the same way, and per k-step of 8
//      units H_hi.W_lo, then H_lo.W_hi, then H_hi.W_hi accumulated in
//      float32, starting from b_h.  H is the A operand, from registers: a
//      thread's states are its A fragments (the tensor cores read their
//      TF32 part), lo split beside them.  W_h is the B operand, split once
//      into hi and lo tables that stay in shared memory.  Kp = U rounded up
//      to 8.  W_h's K rows are ordered so that the A fragment of k-step j
//      holds, at columns t and t + 4, the units 8 j + 2 t and 8 j + 2 t + 1
//      of the thread's rows g and g + 8; its N = 3 Kp columns by octet of
//      units, [r | z | c] blocks of 8 each (168 at U = 50, where the first
//      design padded each gate to 64 rows: 192).  The thread's accumulators
//      of columns 8 (3 j + gate) + 2 t + v then hold the gates of those
//      same units, so the thread that updates h (z h_prev included) already
//      holds it as the next site's A fragment, and no state leaves its
//      registers.  A site issues its 3 Kp / 8 wgmmas as one group and
//      waits once.  The head stays in float32 on the CUDA cores: each
//      thread sums hw . h over its units in order, two shuffles within the
//      quad give both logits of its two trajectories, and one lane per
//      trajectory adds its log-softmax to its Kahan pair while the next
//      site's products run.  No barrier and no shared-memory store per
//      site.  Each thread loads its two trajectories' spins a site ahead.
//      Persistent blocks, one per SM, of kRsGroups warpgroups, each
//      walking (flip, group of 64) items: flips in order, longest suffix
//      first, in rounds of the card's warpgroups, every other round
//      reversed so that the sums of the suffix lengths even out; padding
//      trajectories repeat the last sample.
//      Past pad8(U) = 56 the accumulators outgrow the registers, and
//      flip_suffix_kernel, the first H100 design, stays the path (to the
//      family's U = 120): a block (one warpgroup) per 32 trajectories of one
//      flip, W_h^T (3U x U, each gate padded to 64 rows) . H^T (U x 32) by
//      wgmma m64n32k8, A loaded from a fragment table per k-step, the states
//      in shared memory, the head summed over the warps after a barrier per
//      site.  The launch chooses by U alone.
//      Flip f starts from h_hist[f] with input 1 - s_f and acc = pfx[f-1] +
//      fl[f], then Kahan-adds sites f+1..N-1; the last flip has an empty
//      suffix.  K3/K4 write the ratio term exp(0.5 (lpf - lp)); B6 writes
//      lpf itself (the log of a term would be -inf where it underflows).
//      Every trajectory of a tile runs the same arithmetic, so its result
//      does not depend on the block, warpgroup or row it lands in.
//      Design steps at N=1000, S=64, U=50 (the suffix launch, ms; H100 at
//      700 W; PERF.md): the first design 12.85; turned around, two
//      warpgroups a block 7.48-7.54; three (168 registers, 36 bytes
//      spilled) 7.94-7.96, though 0.58 against 0.66 at N=100, B=500; the
//      product in two groups of columns, the first group's update under
//      the second group's products, 9.15-9.21; b_h held in registers 7.88.
//   3. (K3/K4) A per-sample sum of the N ratio terms in flip order, so the
//      result does not depend on how blocks were scheduled.
// The TPU kernel's wavefront groups, lane packing and VMEM spill rings are
// TPU-only and have no counterpart here.
#include "gru_common.cuh"
#include "tf32_wgmma.cuh"

namespace rnnwf {

constexpr int kBaseP = 2;      // samples per base-pass block
static_assert(kBaseP <= kSlices, "a base block's first slices update one sample each");
constexpr int kTraj = 32;      // trajectories per suffix block (its N)
// The slices' threads and the bookkeeping warp.
__host__ __device__ inline int base_threads(int u) { return kSlices * warp_round(u) + kWarp; }

// Base pass, after the weights: h and hn (kBaseP*U each), the slices' sums,
// the head partials [sample][warp of its slice][2] and two blocks of
// uniforms [block parity][site % 32][sample].
__host__ __device__ inline int base_buffer_floats(int u) {
  return 2 * kBaseP * u + slice_part_floats(u, kBaseP) + (warp_round(u) / kWarp) * kBaseP * 2 +
         2 * kWarp * kBaseP;
}

// The first suffix pass, in this order: the states of the block's trajectories as
// the product's B operand, in two parts (the state and its remainder below
// TF32, lo), each kTraj x Kp in the 8 x 4 core-matrix layout of wgmma
// (Kp = U rounded up to 8); W_h^T in the A-fragment order of wgmma
// (Kp/8 k-steps x 3 Ug/64 tiles x 4 warps x 32 lanes x 4, Ug = U rounded
// up to 64); the input gates wx[x] + bx for x = 0, 1 (2 x 3 x Ug), b_h
// (3 x Ug), the head (Ug x 2) and its bias (2, padded to 4), every padded
// entry zero; the head partials [site parity][warp][trajectory][2].
__host__ __device__ inline int suffix_state_floats(int u) { return kTraj * pad8(u); }
__host__ __device__ inline int suffix_table_floats(int u) {
  const int ug = pad64(u);
  return (pad8(u) / 8) * (3 * ug / kGateRows) * 4 * kWarp * 4 + 6 * ug + 3 * ug + 2 * ug + 4;
}

// The turned-around suffix pass (launch 2 where pad8(U) <= 8 kRsSteps,
// tf32_wgmma.cuh): kRsGroups warpgroups per block, each walking items of
// 64 trajectories.
constexpr int kRsTraj = kGateRows;  // trajectories per item (wgmma's M)

// In this order: W_h's two parts and the input gates and b_h as
// rs_gru_tables lays them out; the head [unit][2]; its bias (2, padded to
// 4).  Padding entries zero.
__host__ __device__ inline int rs_floats(int ks) {
  return 2 * rs_table_floats(ks) + 48 * ks + 24 * ks + 16 * ks + 4;
}

size_t flip_base_smem_bytes(int u) {
  return sizeof(float) * (weight_floats(u) + base_buffer_floats(u));
}
size_t flip_suffix_smem_bytes(int u) {
  return sizeof(float) * (2 * suffix_state_floats(u) + suffix_table_floats(u) +
                          2 * 4 * kTraj * 2);
}
size_t flip_suffix_rs_smem_bytes(int u) {
  return rs_steps(u) <= kRsSteps ? sizeof(float) * rs_floats(rs_steps(u)) : 0;
}

// What the base pass stores beside log p: nothing (K1, B5), the suffix
// pass's inputs (K3, K4, B6: hist, pfx, fl) or K2's replay (rows, gates, p1).
enum class Store { kNone, kFlip, kGates };

// The base pass's outputs, each (B, N) unless stated; only those of the
// Store mode are written.
struct BaseOut {
  float* hist;   // (B, N, U) states h_n
  float* pfx;    // corrected prefix log p(sites <= n)
  float* fl;     // log p of site n flipped
  float* rows;   // (B, N + 1, U + 3) K2's A rows, [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}]
  float* gates;  // (B, N, 4U) [r | z | c | ghc] of site n
  float* p1;     // the head's p(s_n = 1)
  float* lp;     // (B,) joint log p
};

template <bool kSample, Store kStore>
__global__ void flip_base_kernel(int32_t* __restrict__ samples, uint32_t seed,
                                 uint32_t offset, const float* wx, const float* wh,
                                 const float* bx, const float* bh, const float* hw,
                                 const float* hb, BaseOut out, int b_total, int n_sites,
                                 int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_weights(smem, wx, wh, bx, bh, hw, hb, u);
  const int u32 = warp_round(u), nw = u32 / kWarp;
  const int ks = threadIdx.x / u32, j = threadIdx.x - ks * u32;
  const int lane = threadIdx.x % kWarp;
  const bool books = ks == kSlices;  // the last warp: lane p keeps sample p
  float* h = smem + weight_floats(u);
  float* hn = h + kBaseP * u;
  float* part = hn + kBaseP * u;
  float* red = part + slice_part_floats(u, kBaseP);
  float* uni = red + nw * kBaseP * 2;
  for (int i = threadIdx.x; i < kBaseP * u; i += blockDim.x) h[i] = 0.0f;
  // padding slots past the batch repeat the last sample and store nothing
  int bs[kBaseP];
  int64_t row[kBaseP];
  bool own[kBaseP];
#pragma unroll
  for (int p = 0; p < kBaseP; ++p) {
    const int b = blockIdx.x * kBaseP + p;
    own[p] = b < b_total;
    bs[p] = min(b, b_total - 1);
    row[p] = static_cast<int64_t>(bs[p]) * n_sites;
  }
  // thread (p, j) of the first kBaseP slices updates unit j of sample p
  const int b_mine = blockIdx.x * kBaseP + min(ks, kBaseP - 1);
  const int64_t row_mine = static_cast<int64_t>(min(b_mine, b_total - 1)) * n_sites;
  // K2's A rows of sample b (Store::kGates): row n of (b (N + 1) + n) (U + 3)
  // holds [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}], row 0 [0 | 1 | 0 | 0];
  // thread (p, j) writes unit j's entries, thread (p, 0) the inputs
  const int64_t arow_mine = static_cast<int64_t>(min(b_mine, b_total - 1)) * (n_sites + 1);
  if constexpr (kStore == Store::kGates) {
    if (ks < kBaseP && j < u && b_mine < b_total) out.rows[arow_mine * (u + 3) + j] = 0.0f;
  }
  __syncthreads();

  float x[kBaseP], acc = 0.0f, cmp = 0.0f;
#pragma unroll
  for (int p = 0; p < kBaseP; ++p) x[p] = 0.0f;
  for (int n = 0; n < n_sites; ++n) {
    // the uniforms of sites n..n+31, drawn at once, lane = site - n
    float* uni_n = uni + ((n / kWarp) & 1) * kWarp * kBaseP + (n % kWarp) * kBaseP;
    if (books) {
      if constexpr (kSample) {
        if (n % kWarp == 0) {
#pragma unroll
          for (int p = 0; p < kBaseP; ++p)
            uni_n[lane * kBaseP + p] = uniform23(seed, offset, static_cast<uint32_t>(bs[p]),
                                                 static_cast<uint32_t>(n + lane));
        }
      }
    } else if (j < u) {
      slice_product<kBaseP>(w, u, ks, j, h, part);
    }
    __syncthreads();
    if (ks < kBaseP) {
      float q0 = 0.0f, q1 = 0.0f;
      if (j < u) {
        float xt = x[0];
#pragma unroll
        for (int p = 1; p < kBaseP; ++p) xt = ks == p ? x[p] : xt;
        const GateStep st =
            slice_update<kBaseP>(w, u, j, ks, h, part, xt, n > 0 ? 1.0f : 0.0f);
        const float hv = st.h;
        hn[j * kBaseP + ks] = hv;
        if (b_mine < b_total) {
          if constexpr (kStore == Store::kFlip) out.hist[(row_mine + n) * u + j] = hv;
          if constexpr (kStore == Store::kGates) {
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
        q0 = hv * w.hw[2 * j];
        q1 = hv * w.hw[2 * j + 1];
      }
      q0 = warp_sum(q0);
      q1 = warp_sum(q1);
      if (lane == 0) {
        red[(ks * nw + j / kWarp) * 2] = q0;
        red[(ks * nw + j / kWarp) * 2 + 1] = q1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kBaseP; ++p) {
      float l0 = 0.0f, l1 = 0.0f;
      for (int v = 0; v < nw; ++v) {
        l0 += red[(p * nw + v) * 2];
        l1 += red[(p * nw + v) * 2 + 1];
      }
      l0 += w.hb[0];
      l1 += w.hb[1];
      float s;
      if constexpr (kSample) {
        s = uni_n[p] >= sigmoid_tanh(l0 - l1) ? 1.0f : 0.0f;
      } else {
        s = static_cast<float>(samples[row[p] + n]);
      }
      if (books && lane == p) {
        // logp2 of both targets from one log-sum-exp
        const float m = fmaxf(l0, l1);
        const float lse = m + logf(expf(l0 - m) + expf(l1 - m));
        kadd(acc, cmp, (s > 0.5f ? l1 : l0) - lse);
        if (own[p]) {
          if constexpr (kSample) samples[row[p] + n] = static_cast<int32_t>(s);
          if constexpr (kStore == Store::kFlip) {
            out.pfx[row[p] + n] = acc - cmp;
            out.fl[row[p] + n] = (s > 0.5f ? l0 : l1) - lse;
          }
          if constexpr (kStore == Store::kGates) out.p1[row[p] + n] = expf(l1 - lse);
        }
      }
      x[p] = s;
    }
    float* tmp = h; h = hn; hn = tmp;
  }
  if constexpr (kStore == Store::kGates) {
    // row N's inputs: the last spin
    if (ks < kBaseP && j == 0 && b_mine < b_total) {
      float xt = x[0];
#pragma unroll
      for (int p = 1; p < kBaseP; ++p) xt = ks == p ? x[p] : xt;
      float* rn = out.rows + (arow_mine + n_sites) * (u + 3) + u;
      rn[0] = 1.0f;
      rn[1] = 1.0f - xt;
      rn[2] = xt;
    }
  }
  if (books) {
#pragma unroll
    for (int p = 0; p < kBaseP; ++p)
      if (lane == p && own[p]) out.lp[bs[p]] = acc - cmp;
  }
}

// The first suffix pass, the path past pad8(U) = 56.  kPerFlip: out[b, f]
// is the flipped configuration's log p (B6), else its ratio term
// exp(0.5 (lpf - lp)) (K3/K4).  MG: 64-row tiles per gate, U rounded up to
// 64 MG.
template <bool kPerFlip, int MG>
__global__ void __launch_bounds__(4 * kWarp)
flip_suffix_kernel(const int32_t* __restrict__ samples, const float* wx, const float* wh,
                   const float* bx, const float* bh, const float* hw, const float* hb,
                   const float* __restrict__ hist, const float* __restrict__ pfx,
                   const float* __restrict__ fl, const float* __restrict__ lp,
                   float* __restrict__ out, int b_total, int n_sites, int u) {
  constexpr int MT = 3 * MG, UG = MG * kGateRows;
  extern __shared__ __align__(16) float smem[];
  const int kp = pad8(u), ks_n = kp / 8, g3 = 3 * u, sf = suffix_state_floats(u);
  float* states = smem;                   // [state, lo][kTraj x kp]
  float* wfrag = states + 2 * sf;         // [k-step][tile][warp][lane][4]
  float* gxs = wfrag + ks_n * MT * 4 * kWarp * 4;  // [x][gate][unit]
  float* bhs = gxs + 6 * UG;              // [gate][unit]
  float* hws = bhs + 3 * UG;              // [unit][2]
  float* hbs = hws + 2 * UG;
  float* red = hbs + 4;                   // [parity][warp][trajectory][2]
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
  for (int i = threadIdx.x; i < 2 * UG; i += blockDim.x) hws[i] = i < 2 * u ? hw[i] : 0.0f;
  if (threadIdx.x < 2) hbs[threadIdx.x] = hb[threadIdx.x];

  const int groups = (b_total + kTraj - 1) / kTraj;
  const int f = blockIdx.x / groups;
  const int bt0 = (blockIdx.x - f * groups) * kTraj;
  // the trajectories' states h_f and their remainders below TF32,
  // zero-padded to kp units; padding trajectories repeat the last sample
  for (int i = threadIdx.x; i < kTraj * kp; i += blockDim.x) {
    const int n = i / kp, k = i - n * kp;
    const int b = min(bt0 + n, b_total - 1);
    const float v = k < u ? hist[(static_cast<int64_t>(b) * n_sites + f) * u + k] : 0.0f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    states[state_at(n, k, kp)] = v;
    states[sf + state_at(n, k, kp)] = __uint_as_float(lo);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  // the thread's trajectories 8 cb + 2 t + v (e = 2 cb + v), their rows
  // and previous spins
  int64_t rows[8];
  float x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int n = 8 * (e >> 1) + 2 * t + (e & 1);
    rows[e] = static_cast<int64_t>(min(bt0 + n, b_total - 1)) * n_sites;
    x[e] = 1.0f - static_cast<float>(samples[rows[e] + f]);
  }
  // lane n of warp 3 (whose rows hold the padding units, so it updates the
  // fewest) keeps trajectory n's Kahan pair
  const int64_t my_row = static_cast<int64_t>(min(bt0 + lane, b_total - 1)) * n_sites;
  float acc = 0.0f, cmp = 0.0f;
  if (warp == 3) acc = (f > 0 ? pfx[my_row + f - 1] : 0.0f) + fl[my_row + f];

  for (int n = f + 1; n < n_sites; ++n) {
    const int par = (n - f - 1) & 1;
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
    product_k_steps<MT, kTraj>(d, wfrag, states, states + sf, kp * 32, 0, ks_n, warp, lane,
                               [] {});
    // the gate update on the accumulators: the r, z, c of a unit are the
    // same register of tiles mg, MG + mg, 2 MG + mg
    float q0[8], q1[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) { q0[e] = 0.0f; q1[e] = 0.0f; }
#pragma unroll
    for (int mg = 0; mg < MG; ++mg)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int unit = mg * kGateRows + 16 * warp + g + 8 * rh;
        if (unit >= kp) continue;
        const float hw0 = hws[2 * unit], hw1 = hws[2 * unit + 1];
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
          const float hu = zg * states[at] + (1.0f - zg) * cg;
          const float hv = unit < u ? hu : 0.0f;
          uint32_t hi, lo;
          split_tf32(hv, hi, lo);
          states[at] = hv;
          states[sf + at] = __uint_as_float(lo);
          q0[e] = fmaf(hv, hw0, q0[e]);
          q1[e] = fmaf(hv, hw1, q1[e]);
        }
      }
    // the head: sums over the warp's units (the lanes of one t), then over
    // the warps in order
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = 4; off < kWarp; off <<= 1) {
        q0[e] += __shfl_xor_sync(0xffffffffu, q0[e], off);
        q1[e] += __shfl_xor_sync(0xffffffffu, q1[e], off);
      }
    float* red_n = red + (par * 4 + warp) * kTraj * 2;
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int traj = 8 * (e >> 1) + 2 * t + (e & 1);
        red_n[2 * traj] = q0[e];
        red_n[2 * traj + 1] = q1[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = static_cast<float>(samples[rows[e] + n]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (warp == 3) {
      const float* red_p = red + par * 4 * kTraj * 2;
      float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        l0 += red_p[w * kTraj * 2 + 2 * lane];
        l1 += red_p[w * kTraj * 2 + 2 * lane + 1];
      }
      kadd(acc, cmp, logp2(l0 + hbs[0], l1 + hbs[1],
                           static_cast<float>(samples[my_row + n])));
    }
  }
  if (warp == 3 && bt0 + lane < b_total) {
    const float lpf = acc - cmp;
    out[my_row + f] = kPerFlip ? lpf : expf(0.5f * (lpf - lp[bt0 + lane]));
  }
}

// The turned-around suffix pass (KS = pad8(U) / 8 <= kRsSteps): out as
// flip_suffix_kernel's for kPerFlip = per_flip (an argument here, so that
// the build compiles each KS once).  Warpgroup wg of block b is slot
// kRsGroups b + wg; the slots walk the (flip, group of 64) items in order
// of flip, longest suffix first, in rounds of the slots, every other round
// reversed.
template <int KS>
__global__ void __launch_bounds__(kRsGroups * 4 * kWarp, 1)
flip_suffix_rs_kernel(const int32_t* __restrict__ samples, const float* wx, const float* wh,
                      const float* bx, const float* bh, const float* hw, const float* hb,
                      const float* __restrict__ hist, const float* __restrict__ pfx,
                      const float* __restrict__ fl, const float* __restrict__ lp,
                      float* __restrict__ out, int b_total, int n_sites, int u, bool per_flip) {
  constexpr int KP = 8 * KS, TF = 24 * KS * KP;
  extern __shared__ __align__(16) float smem[];
  float* whi = smem;
  float* wlo = whi + TF;
  float* gxs = wlo + TF;
  float* bhs = gxs + 48 * KS;
  float* hws = bhs + 24 * KS;
  float* hbs = hws + 2 * KP;
  rs_gru_tables<KS, false>(whi, wlo, gxs, bhs, wx, wh, bx, bh, u);
  for (int i = threadIdx.x; i < 2 * KP; i += blockDim.x) hws[i] = i < 2 * u ? hw[i] : 0.0f;
  if (threadIdx.x < 2) hbs[threadIdx.x] = hb[threadIdx.x];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / (4 * kWarp), warp = (threadIdx.x / kWarp) % 4;
  const int lane = threadIdx.x % kWarp, g = lane >> 2, t = lane & 3;
  // the thread's rows (trajectories) 16 warp + g + 8 rh, and the one whose
  // Kahan pair it keeps (lanes t and t ^ 2 keep the same)
  const int r0 = 16 * warp + g, mine = t & 1;
  const float4* gx4 = reinterpret_cast<const float4*>(gxs) + t;  // [octet][gate][t]
  const float2* bh2 = reinterpret_cast<const float2*>(bhs) + t;  // [octet][gate][t]
  const float4* hw4 = reinterpret_cast<const float4*>(hws) + t;  // [octet][t]
  const float hb0 = hbs[0], hb1 = hbs[1];
  const int groups = (b_total + kRsTraj - 1) / kRsTraj, items = n_sites * groups;
  const int slots = gridDim.x * kRsGroups, slot = blockIdx.x * kRsGroups + wg;
  for (int round = 0;; ++round) {
    const int item = rs_slot_tile(round, slots, slot);
    if (item >= items) break;
    const int f = item / groups, bt0 = (item - f * groups) * kRsTraj;
    // padding trajectories repeat the last sample
    const int32_t* srow[2];
    float h[KS][4], lo[KS][4], d[12 * KS], x[2], nxt[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int64_t b = min(bt0 + r0 + 8 * rh, b_total - 1);
      srow[rh] = samples + b * n_sites;
      x[rh] = 1.0f - static_cast<float>(srow[rh][f]);
      if (f + 1 < n_sites) nxt[rh] = static_cast<float>(srow[rh][f + 1]);
      const float* hf = hist + (b * n_sites + f) * u;
#pragma unroll
      for (int j = 0; j < KS; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int unit = 8 * j + 2 * t + v;
          h[j][2 * v + rh] = unit < u ? hf[unit] : 0.0f;
          lo[j][2 * v + rh] = tf32_lo(h[j][2 * v + rh]);
        }
    }
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
    const int64_t row_mine = static_cast<int64_t>(min(bt0 + r0 + 8 * mine, b_total - 1)) *
                             n_sites;
    float acc = (f > 0 ? pfx[row_mine + f - 1] : 0.0f) + fl[row_mine + f], cmp = 0.0f;
    // the head's partial sums of the last site [rh][logit], settled while
    // the next site's products run: summed over the quad, then the lane's
    // trajectory's log p added to its Kahan pair
    bool pending = false;
    float q[2][2] = {}, ptgt = 0.0f;
    const auto settle = [&] {
      if (!pending) return;
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          q[rh][l] += __shfl_xor_sync(0xffffffffu, q[rh][l], 1);
          q[rh][l] += __shfl_xor_sync(0xffffffffu, q[rh][l], 2);
        }
      const float l0 = mine ? q[1][0] : q[0][0], l1 = mine ? q[1][1] : q[0][1];
      kadd(acc, cmp, logp2(l0 + hb0, l1 + hb1, ptgt));
      pending = false;
    };

    for (int n = f + 1; n < n_sites; ++n) {
      const float tgt[2] = {nxt[0], nxt[1]};  // s_n
      if (n + 1 < n_sites) {
        nxt[0] = static_cast<float>(srow[0][n + 1]);
        nxt[1] = static_cast<float>(srow[1][n + 1]);
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
      // the gate update on the accumulators; h becomes the next site's A
      // fragment in place, and the head's partials follow the units in order
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) { q[rh][0] = 0.0f; q[rh][1] = 0.0f; }
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float4 gr = gx4[4 * (3 * j)], gz = gx4[4 * (3 * j + 1)], gc = gx4[4 * (3 * j + 2)];
        const float4 hwj = hw4[4 * j];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const bool real = j + 1 < KS || 8 * j + 2 * t + v < u;  // only the last octet pads
          const float r0x = v ? gr.z : gr.x, r1x = v ? gr.w : gr.y;
          const float z0x = v ? gz.z : gz.x, z1x = v ? gz.w : gz.y;
          const float c0x = v ? gc.z : gc.x, c1x = v ? gc.w : gc.y;
          const float hw0 = v ? hwj.z : hwj.x, hw1 = v ? hwj.w : hwj.y;
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int i = 2 * rh + v;
            const bool up_spin = x[rh] > 0.5f;
            const float rg = sigmoid_tanh((up_spin ? r1x : r0x) + d[4 * (3 * j) + i]);
            const float zg = sigmoid_tanh((up_spin ? z1x : z0x) + d[4 * (3 * j + 1) + i]);
            const float cg = tanhf((up_spin ? c1x : c0x) + rg * d[4 * (3 * j + 2) + i]);
            const float hu = zg * h[j][2 * v + rh] + (1.0f - zg) * cg;
            const float hv = real ? hu : 0.0f;
            h[j][2 * v + rh] = hv;
            lo[j][2 * v + rh] = tf32_lo(hv);
            q[rh][0] = fmaf(hv, hw0, q[rh][0]);
            q[rh][1] = fmaf(hv, hw1, q[rh][1]);
          }
        }
        start_from_bh(j);
      }
      x[0] = tgt[0];
      x[1] = tgt[1];
      ptgt = mine ? tgt[1] : tgt[0];
      pending = true;
    }
    settle();
    const int b_mine = bt0 + r0 + 8 * mine;
    if (t < 2 && b_mine < b_total) {
      const float lpf = acc - cmp;
      out[row_mine + f] = per_flip ? lpf : expf(0.5f * (lpf - lp[b_mine]));
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

template <bool kSample, Store kStore>
cudaError_t launch_base(int32_t* samples, uint32_t seed, uint32_t offset, const float* const* W,
                        const BaseOut& out, int b_total, int n_sites, int u, cudaStream_t st) {
  const size_t smem = flip_base_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(flip_base_kernel<kSample, kStore>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flip_base_kernel<kSample, kStore><<<(b_total + kBaseP - 1) / kBaseP, base_threads(u), smem,
                                      st>>>(samples, seed, offset, W[0], W[1], W[2], W[3],
                                            W[4], W[5], out, b_total, n_sites, u);
  return cudaGetLastError();
}

// The six weight pointers of a C entry point.
inline void weight_ptrs(const float* (&W)[6], const void* wx, const void* wh, const void* bx,
                        const void* bh, const void* hw, const void* hb) {
  W[0] = static_cast<const float*>(wx);
  W[1] = static_cast<const float*>(wh);
  W[2] = static_cast<const float*>(bx);
  W[3] = static_cast<const float*>(bh);
  W[4] = static_cast<const float*>(hw);
  W[5] = static_cast<const float*>(hb);
}

// The first suffix pass (past pad8(U) = 56), for MG 64-row tiles per gate
// (U <= 128; the GRU family's shared memory stops at U = 120).
template <bool kPerFlip, int MG>
cudaError_t launch_suffix(void* samples, const float* const* W, void* hist, void* pfx,
                          void* fl, void* lp, void* out, int b_total, int n_sites, int u,
                          cudaStream_t st) {
  const size_t smem = flip_suffix_smem_bytes(u);
  cudaError_t err = cudaFuncSetAttribute(flip_suffix_kernel<kPerFlip, MG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = n_sites * ((b_total + kTraj - 1) / kTraj);
  flip_suffix_kernel<kPerFlip, MG><<<blocks, 4 * kWarp, smem, st>>>(
      static_cast<const int32_t*>(samples), W[0], W[1], W[2], W[3], W[4], W[5],
      static_cast<const float*>(hist), static_cast<const float*>(pfx),
      static_cast<const float*>(fl), static_cast<const float*>(lp), static_cast<float*>(out),
      b_total, n_sites, u);
  return cudaGetLastError();
}

// The turned-around suffix pass: one block per SM (as many as fit), or
// fewer where the items do not fill them.
template <bool kPerFlip, int KS>
cudaError_t launch_suffix_rs(void* samples, const float* const* W, void* hist, void* pfx,
                             void* fl, void* lp, void* out, int b_total, int n_sites, int u,
                             cudaStream_t st) {
  static_assert(KS <= kRsSteps, "the turned-around suffix pass takes pad8(U) <= 8 kRsSteps");
  const auto kernel = flip_suffix_rs_kernel<KS>;
  const size_t smem = sizeof(float) * rs_floats(KS);
  int grid = 0;
  const cudaError_t err = rs_persistent_grid(
      kernel, smem, static_cast<int64_t>(n_sites) * ((b_total + kRsTraj - 1) / kRsTraj), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRsGroups * 4 * kWarp, smem, st>>>(
      static_cast<const int32_t*>(samples), W[0], W[1], W[2], W[3], W[4], W[5],
      static_cast<const float*>(hist), static_cast<const float*>(pfx),
      static_cast<const float*>(fl), static_cast<const float*>(lp), static_cast<float*>(out),
      b_total, n_sites, u, kPerFlip);
  return cudaGetLastError();
}

// Launch 2 by U alone: the turned-around suffix pass at its KS, else
// flip_suffix_kernel.
template <bool kPerFlip, int KS = 1>
cudaError_t launch_suffix_by_u(void* samples, const float* const* W, void* hist, void* pfx,
                               void* fl, void* lp, void* out, int b_total, int n_sites, int u,
                               cudaStream_t st) {
  if constexpr (KS <= kRsSteps) {
    return rs_steps(u) == KS
               ? launch_suffix_rs<kPerFlip, KS>(samples, W, hist, pfx, fl, lp, out, b_total,
                                                n_sites, u, st)
               : launch_suffix_by_u<kPerFlip, KS + 1>(samples, W, hist, pfx, fl, lp, out,
                                                      b_total, n_sites, u, st);
  } else {
    return pad64(u) == kGateRows
               ? launch_suffix<kPerFlip, 1>(samples, W, hist, pfx, fl, lp, out, b_total,
                                            n_sites, u, st)
               : launch_suffix<kPerFlip, 2>(samples, W, hist, pfx, fl, lp, out, b_total,
                                            n_sites, u, st);
  }
}

// The base pass, then the suffix pass into out (ratio terms, or the per-flip
// log p when kPerFlip), then (unless kPerFlip) the flip-order ratio sum.
template <bool kSample, bool kPerFlip>
int launch_flip(void* samples, uint32_t seed, uint32_t offset, const void* wx,
                const void* wh, const void* bx, const void* bh, const void* hw,
                const void* hb, void* hist, void* pfx, void* fl, void* out, void* lp,
                void* ratio, int b_total, int n_sites, int u, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* W[6];
  weight_ptrs(W, wx, wh, bx, bh, hw, hb);
  BaseOut base{};
  base.hist = static_cast<float*>(hist);
  base.pfx = static_cast<float*>(pfx);
  base.fl = static_cast<float*>(fl);
  base.lp = static_cast<float*>(lp);
  cudaError_t err = launch_base<kSample, Store::kFlip>(static_cast<int32_t*>(samples), seed,
                                                       offset, W, base, b_total, n_sites, u, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  err = launch_suffix_by_u<kPerFlip>(samples, W, hist, pfx, fl, lp, out, b_total, n_sites, u,
                                     st);
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
  using namespace rnnwf;
  const float* W[6];
  weight_ptrs(W, wx, wh, bx, bh, hw, hb);
  BaseOut out{};
  out.lp = static_cast<float*>(lp);
  return static_cast<int>(launch_base<true, Store::kNone>(static_cast<int32_t*>(samples), seed,
                                                          offset, W, out, b_total, n_sites, u,
                                                          static_cast<cudaStream_t>(stream)));
}

// K1: the joint log p (B floats) of given samples (B*N ints), no scratch.
extern "C" int rnnwf_gru_log_prob(const void* samples, const void* wx, const void* wh,
                                  const void* bx, const void* bh, const void* hw,
                                  const void* hb, void* lp, int b_total, int n_sites, int u,
                                  void* stream) {
  using namespace rnnwf;
  const float* W[6];
  weight_ptrs(W, wx, wh, bx, bh, hw, hb);
  BaseOut out{};
  out.lp = static_cast<float*>(lp);
  return static_cast<int>(launch_base<false, Store::kNone>(
      static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u, W, out, b_total, n_sites, u,
      static_cast<cudaStream_t>(stream)));
}

// K1 storing K2's forward replay (stage a; stages b and c are in
// csrc/fused_gru_bwd.cu): the joint log p (lp, B floats) and K2's A rows
// (rows, B*(N+1)*(U+3): [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}], row 0 [0 |
// 1 | 0 | 0]), the gates [r | z | c | ghc] (gates, B*N*4U) and the head's
// p(s = 1) (p1, B*N) per (sample, site).
extern "C" int rnnwf_gru_replay(const void* samples, const void* wx, const void* wh,
                                const void* bx, const void* bh, const void* hw, const void* hb,
                                void* rows, void* gates, void* p1, void* lp, int b_total,
                                int n_sites, int u, void* stream) {
  using namespace rnnwf;
  const float* W[6];
  weight_ptrs(W, wx, wh, bx, bh, hw, hb);
  BaseOut out{};
  out.rows = static_cast<float*>(rows);
  out.gates = static_cast<float*>(gates);
  out.p1 = static_cast<float*>(p1);
  out.lp = static_cast<float*>(lp);
  return static_cast<int>(launch_base<false, Store::kGates>(
      static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u, W, out, b_total, n_sites, u,
      static_cast<cudaStream_t>(stream)));
}
