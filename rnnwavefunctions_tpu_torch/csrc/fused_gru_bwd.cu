// K2: the VJP of sum_b g_b log p(sigma_b) with respect to every weight of a
// single-layer GRU and its 2-logit head.  Its stages a and b with g = 1,
// without stage c's sum over samples, are B17, minSR's per-sample jacobian
// sweep (ops/fused_jac.py): each sample's weight rows are its own A^T C.
// Stages b and c also serve the cRNN: B9 (csrc/fused_crnn_bwd.cu) seeds the
// sweep from its two heads and sums C's three head columns in stage c; B20
// (csrc/fused_jac.cu) seeds it from given cotangents on the states and
// writes each site's gate cotangents (Sweep in gru_common.cuh).
//
// Replaces: rnnwavefunctions_tpu/ops/fused_gru_bwd.py::gru_log_prob_bwd
// (_make_bwd_kernel, run_history_bptt, gru_trunk_bwd_site), the backward
// half of the loss gradient; with stage a, rnnwavefunctions_tpu/ops/
// fused_jac.py::jac_sweep (B17) and ::_jac_sweep_spill (B18, its spill
// variant for long chains: here every output lies in device memory at
// every N).
//
// Bound on the H100: latency.  The work is three 3U x U products per
// (sample, site), about 2.4 GFLOP at the flagship shape (B=500, N=100,
// U=50): 36 us at the FP32 peak.  But a sample's sites form two dependent
// chains of N steps (the forward replay and the reverse sweep), and the
// TPU kernel's body, which recomputes the gates, carries dh_{n-1} and adds
// the weight cotangent at every site, would put all three products on the
// reverse chain.
//
// Design: three stages, one 3U x U product per site on each chain.
//   a. The forward replay is K1's teacher-forced base pass storing, per
//      (sample, site), the gates r, z, c and ghc = (h_{n-1} W_h)_c + bh_c,
//      the head's p1 = p(s_n = 1), and the rows of A below (the states and
//      inputs) (csrc/tfim_flip.cu, Store::kGates).  GRULogProb runs it as
//      its forward when a gradient follows, so that the backward starts at
//      stage b.
//   b. The reverse sweep (bwd_sweep_kernel), a block per P samples as
//      the base pass (P = 2, or 1 where the batch gives fewer blocks of 2
//      than the card has SMs, so that more SMs share a small batch's
//      sequential sites): at each site thread (p, j) of the first P slices
//      forms unit j's cotangents from the stored values (math in
//      fused_gru_bwd.py:29-39; the values of site n-1 are loaded while
//      site n computes), writes them as the row of C below and dgh =
//      [da_r | da_z | dac r] to shared memory; then kSlices x U threads
//      sum dh_{n-1} = dht z + W_h dgh, thread (ks, j) the terms of unit j
//      over the ks-th quarter of each gate's U columns (three chains a
//      quarter of U deep, added r + z, then + c) with its 3 U/4 entries of
//      W_h in registers for the whole sweep (so a term costs one broadcast
//      load of dgh for the block's samples), and thread (p, j) adds the
//      quarters in order.  No weight cotangent is accumulated on this
//      chain.
//   c. The weight cotangent (bwd_weights_kernel), a throughput kernel: one
//      product G = A^T C over B (N + 1) rows, row (b, n) for n = 0..N holding
//          A = [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}]   (U + 3; [0 | 1 | 0 | 0] at n = 0)
//          C = [dgh_n | dac_n | dl1_{n-1}]             (4U + 1; zero at n = N but dl1)
//      so G holds dW_h and db_h (rows h and 1 against dgh), dW_x and db_x
//      (rows x and 1 against da: dgh in the r and z columns, dac in the c
//      columns) and the head's cotangents (rows h and 1 against dl1 =
//      g (s - p1): row (b, n+1) carries h_n and dl1_n, and row (b, N) the
//      last site).  Stages a and b write A and C in this row-major layout,
//      so a block of stage c sums one 64 x 64 tile of G over a chunk of
//      kChunkRows rows with plain coalesced loads: 32 rows at a time
//      through shared memory (the next 32 rows' loads in flight while
//      these are multiplied), a 4 x 4 register tile per thread, in row
//      order; then launch_sum_partials adds the chunks' partials in chunk
//      order.  No atomics: the same bits on every run.
// The scratch (about 9U floats per (sample, site): 90 MB at the flagship)
// comes from the caller; rnnwf_gru_bwd_partial_floats sizes the partials.
#include "gru_common.cuh"

namespace rnnwf {

constexpr int kBwdP = 2;          // samples per reverse-sweep block (1 for small batches)
static_assert(kBwdP <= kSlices, "the first slices update one sample each");
constexpr int kChunkRows = 512;   // rows of G per stage-c block (ops/fused_gru_bwd.py)
constexpr int kTileG = 64;        // G's tile edge
constexpr int kRowTile = 32;      // rows staged at a time
constexpr int kGThreads = 256;    // 16 x 16 threads, 4 x 4 entries each
constexpr int kStage = kRowTile * kTileG / kGThreads;  // staged values per thread and tile

// Reverse sweep, in this order: the head vectors (U each, padded to 4): kGru
// hw[:, 1] - hw[:, 0]; kCrnn aw[:, 0] - aw[:, 1], pw[:, 0], pw[:, 1]; kDouts
// none; dgh [3U][P]; the slices' sums [slice][U32][P].
__host__ __device__ inline int sweep_head_floats(int u) { return (u + 3) & ~3; }

__host__ __device__ constexpr int head_vectors(Sweep m) {
  return m == Sweep::kCrnn ? 3 : m == Sweep::kGru ? 1 : 0;
}

size_t sweep_smem_bytes(int u, int p, int vectors) {
  return sizeof(float) *
         (vectors * sweep_head_floats(u) + 3 * u * p + kSlices * warp_round(u) * p);
}
size_t k2_smem_bytes(int u) { return sweep_smem_bytes(u, kBwdP, 1); }
size_t crnn_sweep_smem_bytes(int u) { return sweep_smem_bytes(u, kBwdP, 3); }

// The widest quarter of U the reverse sweep's register tiles take (U <= 128).
constexpr int kMaxQuarter = 32;

// C's columns: 4U gate columns and one (K2) or three (B9) head columns.
__host__ __device__ inline int cot_cols(int u, int heads) { return 4 * u + 2 * heads - 1; }

// Unit j's stored values at one site of one trajectory: the gates,
// h_{n-1}[j] and the raw seed values w (kGru: s_n, p1; kCrnn: s_n, a_n,
// q_n; kDouts: the given cotangent on h_n[j]).  They are loaded a site
// ahead and used only at their own site, so the loads stay in flight while
// the site before computes.
struct SiteValues {
  float r, z, c, ghc, hp;
  float w[3];
};

// Site n of the trajectory of sample rows row = b N and arow = b (N + 1);
// `dout` is the part's cotangents at the sample's first site (kDouts);
// prev holds h_{n-1}: A's rows (kGru, kCrnn) or the states h_n (kDouts).
template <Sweep M>
__device__ __forceinline__ SiteValues load_site(const int32_t* __restrict__ samples,
                                                const float* __restrict__ prev,
                                                const float* __restrict__ gates,
                                                const float* __restrict__ seeds,
                                                const float* __restrict__ dout, int64_t row,
                                                int64_t arow, int n, int j, int u) {
  const float* gt = gates + (row + n) * 4 * u;
  SiteValues v;
  v.r = gt[j];
  v.z = gt[u + j];
  v.c = gt[2 * u + j];
  v.ghc = gt[3 * u + j];
  if constexpr (M == Sweep::kDouts) {
    v.hp = n > 0 ? prev[(row + n - 1) * u + j] : 0.0f;
    v.w[0] = dout[static_cast<int64_t>(n) * u + j];
  } else {
    v.hp = prev[(arow + n) * (u + 3) + j];
    v.w[0] = static_cast<float>(samples[row + n]);
    if constexpr (M == Sweep::kGru) {
      v.w[1] = seeds[row + n];
    } else {
      const float2 sd = reinterpret_cast<const float2*>(seeds)[row + n];
      v.w[1] = sd.x;
      v.w[2] = sd.y;
    }
  }
  return v;
}

// dht = dh + the site's cotangent on h_n[j], and hd, the head columns of
// C's row n + 1 (kGru: dl1 = g (s - p1) through hw[:, 1] - hw[:, 0];
// kCrnn: dd = g_re a_n through aw[:, 0] - aw[:, 1], and g_im q_n in the
// target's phase column through pw[:, s_n]; kDouts: the given cotangent).
template <Sweep M>
__device__ __forceinline__ float site_dht(const SiteValues& v, const float* heads, int hf,
                                          int j, float dh, float gb, float gi,
                                          float (&hd)[3]) {
  if constexpr (M == Sweep::kDouts) {
    return dh + v.w[0];
  } else if constexpr (M == Sweep::kGru) {
    hd[0] = gb * (v.w[0] - v.w[1]);
    return dh + heads[j] * hd[0];
  } else {
    const bool up = v.w[0] > 0.5f;
    const float dd = gb * v.w[1], dq = gi * v.w[2];
    hd[0] = dd;
    hd[1] = up ? 0.0f : dq;
    hd[2] = up ? dq : 0.0f;
    return dh + (heads[j] * dd + (up ? heads[2 * hf + j] : heads[hf + j]) * dq);
  }
}

// KQ: the quarter of U rounded up to 8 (a thread's W_h entries per gate);
// P: trajectories per block.  At most kSlices x 128 threads: registers for 4
// warps of each SM sub-partition (16,384 / (4 x 32) = 128 a thread).  The
// pointers of SweepArgs come as restrict-qualified parameters (prev: rows,
// or hist under kDouts).
template <int KQ, int P, Sweep M>
__global__ void __launch_bounds__(kSlices * 128)
bwd_sweep_kernel(const int32_t* __restrict__ samples, const float* __restrict__ wh,
                 const float* __restrict__ hw, const float* __restrict__ pw,
                 const float* __restrict__ g, const float* __restrict__ g_im,
                 const float* __restrict__ prev, const float* __restrict__ gates,
                 const float* __restrict__ seeds, const float* __restrict__ douts,
                 float* __restrict__ out, int b_total, int parts, int n_sites, int u) {
  extern __shared__ __align__(16) float smem[];
  const int u32 = warp_round(u), hf = sweep_head_floats(u);
  float* heads = smem;
  float* dgh = smem + head_vectors(M) * hf;  // [q][p]
  float* part = dgh + 3 * u * P;             // [slice][k][p]
  for (int k = threadIdx.x; k < u; k += blockDim.x) {
    if constexpr (M == Sweep::kGru) heads[k] = hw[2 * k + 1] - hw[2 * k];
    if constexpr (M == Sweep::kCrnn) {
      heads[k] = hw[2 * k] - hw[2 * k + 1];
      heads[hf + k] = pw[2 * k];
      heads[2 * hf + k] = pw[2 * k + 1];
    }
  }
  const int ks = threadIdx.x / u32, j = threadIdx.x - ks * u32;
  // thread (ks, j) sums W_h[j, gate U + i] dgh[gate U + i] for i in the
  // ks-th quarter of U [i0, i0 + len): its W_h entries, in registers
  const int kc = (u + kSlices - 1) / kSlices, i0 = ks * kc, len = max(0, min(u, i0 + kc) - i0);
  float wq[3][KQ];
#pragma unroll
  for (int gt = 0; gt < 3; ++gt)
#pragma unroll
    for (int t = 0; t < KQ; ++t)
      wq[gt][t] = j < u && t < len ? wh[static_cast<int64_t>(j) * 3 * u + gt * u + i0 + t] : 0.0f;
  // thread (p, j) of the first P slices carries unit j of the block's
  // trajectory p, trajectory b parts + part; a padding slot past the last
  // repeats it and stores nothing
  const int trajs = b_total * parts;  // launch_reverse_sweep keeps it an int
  const int traj = blockIdx.x * P + min(ks, P - 1);
  const int t_row = min(traj, trajs - 1);
  int b_row = t_row, my_part = 0;
  if constexpr (M == Sweep::kDouts) {
    b_row = t_row / parts;
    my_part = t_row - b_row * parts;
  }
  const int64_t row = static_cast<int64_t>(b_row) * n_sites;
  const int64_t arow = static_cast<int64_t>(b_row) * (n_sites + 1);
  // the part's rows (P, B, N, U) of douts and (P, B, N, 4U) of dg
  const int64_t prow = static_cast<int64_t>(my_part) * b_total * n_sites + row;
  const float* dout = M == Sweep::kDouts ? douts + prow * u : nullptr;
  const bool carry = ks < P && j < u;
  const bool mine = carry && traj < trajs;
  float gb = 0.0f, gi = 0.0f;
  if constexpr (M != Sweep::kDouts) gb = g[b_row];
  if constexpr (M == Sweep::kCrnn) gi = g_im[b_row];
  const int rc = cot_cols(u, head_vectors(M) == 3 ? 2 : 1);
  if constexpr (M != Sweep::kDouts) {
    if (mine) {
      // C's row (b, N) is zero but its head columns, and row (b, 0) has
      // none
      float* last = out + (arow + n_sites) * rc;
      last[j] = 0.0f;
      last[u + j] = 0.0f;
      last[2 * u + j] = 0.0f;
      last[3 * u + j] = 0.0f;
      if (j == 0)
        for (int h = 4 * u; h < rc; ++h) out[arow * rc + h] = 0.0f;
    }
  }
  __syncthreads();

  SiteValues cur{}, nxt{};
  if (carry) cur = load_site<M>(samples, prev, gates, seeds, dout, row, arow, n_sites - 1, j, u);
  float dh = 0.0f;
  for (int n = n_sites - 1; n >= 0; --n) {
    if (carry && n > 0)
      nxt = load_site<M>(samples, prev, gates, seeds, dout, row, arow, n - 1, j, u);
    float hz = 0.0f;
    if (carry) {
      float hd[3];
      const float dht = site_dht<M>(cur, heads, hf, j, dh, gb, gi, hd);
      const float dz = dht * (cur.hp - cur.c);
      const float dc = dht * (1.0f - cur.z);
      const float dac = dc * (1.0f - cur.c * cur.c);
      const float dr = dac * cur.ghc;
      const float dar = dr * cur.r * (1.0f - cur.r);
      const float daz = dz * cur.z * (1.0f - cur.z);
      const float dgc = dac * cur.r;
      if (mine) {
        if constexpr (M == Sweep::kDouts) {
          float* g_row = out + (prow + n) * 4 * u;
          g_row[j] = dar;
          g_row[u + j] = daz;
          g_row[2 * u + j] = dac;
          g_row[3 * u + j] = dgc;
        } else {
          float* c_row = out + (arow + n) * rc;
          c_row[j] = dar;
          c_row[u + j] = daz;
          c_row[2 * u + j] = dgc;
          c_row[3 * u + j] = dac;
          if (j == 0) {  // row (b, n+1)
#pragma unroll
            for (int h = 0; h < (M == Sweep::kCrnn ? 3 : 1); ++h) c_row[rc + 4 * u + h] = hd[h];
          }
        }
      }
      dgh[j * P + ks] = dar;
      dgh[(u + j) * P + ks] = daz;
      dgh[(2 * u + j) * P + ks] = dgc;
      hz = dht * cur.z;
    }
    if (n == 0) break;
    __syncthreads();
    // slice ks of (W_h dgh)[j] for the P trajectories
    if (j < u) {
      float acc[3][P];
#pragma unroll
      for (int gt = 0; gt < 3; ++gt)
#pragma unroll
        for (int p = 0; p < P; ++p) acc[gt][p] = 0.0f;
#pragma unroll
      for (int t = 0; t < KQ; ++t) {
        if (t < len) {  // uniform over a warp: a warp's threads share ks
#pragma unroll
          for (int gt = 0; gt < 3; ++gt) {
            float d[P];
            load_h<P>(dgh, gt * u + i0 + t, d);
#pragma unroll
            for (int p = 0; p < P; ++p) acc[gt][p] = fmaf(d[p], wq[gt][t], acc[gt][p]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
        part[(ks * u32 + j) * P + p] = (acc[0][p] + acc[1][p]) + acc[2][p];
    }
    __syncthreads();
    if (carry) {
      float s = part[j * P + ks];
#pragma unroll
      for (int q = 1; q < kSlices; ++q) s += part[(q * u32 + j) * P + ks];
      dh = hz + s;
    }
    cur = nxt;
  }
}

template <int KQ, int P, Sweep M>
cudaError_t launch_sweep_p(const SweepArgs& a, cudaStream_t st) {
  const size_t smem = sweep_smem_bytes(a.u, P, head_vectors(M));
  cudaError_t err = cudaFuncSetAttribute(bwd_sweep_kernel<KQ, P, M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (static_cast<int64_t>(a.b_total) * a.parts + P - 1) / P;
  bwd_sweep_kernel<KQ, P, M><<<static_cast<unsigned>(blocks), kSlices * warp_round(a.u), smem,
                               st>>>(a.samples, a.wh, a.hw, a.pw, a.g, a.g_im,
                                     M == Sweep::kDouts ? a.hist : a.rows, a.gates, a.seeds,
                                     a.douts, a.out, a.b_total, a.parts, a.n_sites, a.u);
  return cudaGetLastError();
}

// K2 and B17 take blocks of 1 sample where blocks of kBwdP would leave SMs
// idle; B9 and B20 always take kBwdP trajectories a block.
template <int KQ>
cudaError_t launch_sweep_kq(Sweep mode, int p, const SweepArgs& a, cudaStream_t st) {
  if (mode == Sweep::kCrnn) return launch_sweep_p<KQ, kBwdP, Sweep::kCrnn>(a, st);
  if (mode == Sweep::kDouts) return launch_sweep_p<KQ, kBwdP, Sweep::kDouts>(a, st);
  return p == 1 ? launch_sweep_p<KQ, 1, Sweep::kGru>(a, st)
                : launch_sweep_p<KQ, kBwdP, Sweep::kGru>(a, st);
}

cudaError_t launch_reverse_sweep(Sweep mode, const SweepArgs& a, cudaStream_t st) {
  const int quarter = (a.u + kSlices - 1) / kSlices;
  if (quarter > kMaxQuarter || a.parts < 1) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(a.b_total) * a.parts > INT32_MAX - kBwdP) return cudaErrorInvalidValue;
  int p = kBwdP;
  if (mode == Sweep::kGru) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    p = (a.b_total + kBwdP - 1) / kBwdP < sms ? 1 : kBwdP;
  }
  return quarter <= 8    ? launch_sweep_kq<8>(mode, p, a, st)
         : quarter <= 16 ? launch_sweep_kq<16>(mode, p, a, st)
         : quarter <= 24 ? launch_sweep_kq<24>(mode, p, a, st)
                         : launch_sweep_kq<32>(mode, p, a, st);
}

// K2's sweep arguments (stage b of K2 and B17).
SweepArgs k2_sweep_args(const void* samples, const void* g, const void* wh, const void* hw,
                        const void* rows, const void* gates, const void* p1, void* cot,
                        int b_total, int n_sites, int u) {
  SweepArgs a{};
  a.samples = static_cast<const int32_t*>(samples);
  a.wh = static_cast<const float*>(wh);
  a.hw = static_cast<const float*>(hw);
  a.g = static_cast<const float*>(g);
  a.rows = static_cast<const float*>(rows);
  a.gates = static_cast<const float*>(gates);
  a.seeds = static_cast<const float*>(p1);
  a.out = static_cast<float*>(cot);
  a.b_total = b_total;
  a.parts = 1;
  a.n_sites = n_sites;
  a.u = u;
  return a;
}

// Offsets in the flat gradient [wx (2, 3U) | wh (U, 3U) | bx | bh | hw (U, 2) |
// hb (2)], with the cRNN's phase head [pw (U, 2) | pb (2)] after it.
struct GradLayout {
  int wx, wh, bx, bh, hw, hb, pw, pb;
  __device__ explicit GradLayout(int u) {
    const int g3 = 3 * u;
    wx = 0;
    wh = 2 * g3;
    bx = wh + u * g3;
    bh = bx + g3;
    hw = bh + g3;
    hb = hw + 2 * u;
    pw = hb + 2;
    pb = pw + 2 * u;
  }
};

__host__ __device__ inline int grad_floats(int u, int heads) {
  return weight_floats_exact(u) + (heads - 1) * (2 * u + 2);
}

// Writes G's entry (m, q) to the gradient entries it holds (each entry of
// the flat gradient is written by exactly one (m, q)).  The head columns of
// C: K2's dl1 (NH = 1), or the cRNN's dd, dq0, dq1 (NH = 2).
template <int NH>
__device__ __forceinline__ void put_grad(float* out, const GradLayout& L, int u, int m, int q,
                                         float v) {
  const int g3 = 3 * u;
  if (m >= u + 3) return;  // padding rows of the last tile
  if (q < g3) {
    if (m < u) out[L.wh + m * g3 + q] = v;
    if (m == u) {
      out[L.bh + q] = v;
      if (q < 2 * u) out[L.bx + q] = v;  // da = dgh in the r and z columns
    }
    if (m > u && q < 2 * u) out[L.wx + (m - u - 1) * g3 + q] = v;
  } else if (q < 4 * u) {
    const int qc = 2 * u + (q - g3);  // dac: the c columns of dW_x and db_x
    if (m == u) out[L.bx + qc] = v;
    if (m > u) out[L.wx + (m - u - 1) * g3 + qc] = v;
  } else if (q == 4 * u) {
    // the 2-logit head's two columns: K2's dlogit_0 = -dl1, the cRNN's
    // amplitude head (dd, -dd)
    const float v0 = NH == 1 ? -v : v;
    if (m < u) {
      out[L.hw + 2 * m] = v0;
      out[L.hw + 2 * m + 1] = -v0;
    }
    if (m == u) {
      out[L.hb] = v0;
      out[L.hb + 1] = -v0;
    }
  } else if (NH == 2 && q < 4 * u + 3) {
    const int cls = q - 4 * u - 1;  // the phase head's logit cls
    if (m < u) out[L.pw + 2 * m + cls] = v;
    if (m == u) out[L.pb + cls] = v;
  }
}

// The values thread column sc stages for rows v = rt + sr + 4 i of a tile:
// column m of A (ra columns) and column q of C (rc columns), zero past the
// chunk's end r1 or the matrix's last column.
__device__ __forceinline__ void fetch_rows(const float* __restrict__ a_rows,
                                           const float* __restrict__ c_rows, int rt, int r1,
                                           int sr, int m, int q, int ra, int rc,
                                           float (&av)[kStage], float (&cv)[kStage]) {
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int v = rt + sr + (kGThreads / kTileG) * i;
    av[i] = v < r1 && m < ra ? a_rows[static_cast<int64_t>(v) * ra + m] : 0.0f;
    cv[i] = v < r1 && q < rc ? c_rows[static_cast<int64_t>(v) * rc + q] : 0.0f;
  }
}

// blockIdx.x: the chunk of rows; blockIdx.y: the tile of G (row tiles of
// the U + 3 A columns, then column tiles of the 4U + 2 NH - 1 C columns).
template <int NH>
__global__ void __launch_bounds__(kGThreads)
bwd_weights_kernel(const float* __restrict__ a_rows, const float* __restrict__ c_rows,
                   float* __restrict__ partial, int n_rows, int u) {
  __shared__ __align__(16) float as[kRowTile][kTileG];
  __shared__ __align__(16) float cs[kRowTile][kTileG];
  const int ra = u + 3, rc = cot_cols(u, NH);
  const int tiles_c = (rc + kTileG - 1) / kTileG;
  const int m0 = (blockIdx.y / tiles_c) * kTileG, c0 = (blockIdx.y % tiles_c) * kTileG;
  const int r0 = blockIdx.x * kChunkRows, r1 = min(n_rows, r0 + kChunkRows);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the thread's staging column and its first row in a tile
  const int sc = threadIdx.x % kTileG, sr = threadIdx.x / kTileG;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;

  float av[kStage], cv[kStage];
  fetch_rows(a_rows, c_rows, r0, r1, sr, m0 + sc, c0 + sc, ra, rc, av, cv);
  for (int rt = r0; rt < r1; rt += kRowTile) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      as[sr + (kGThreads / kTileG) * i][sc] = av[i];
      cs[sr + (kGThreads / kTileG) * i][sc] = cv[i];
    }
    __syncthreads();
    if (rt + kRowTile < r1)
      fetch_rows(a_rows, c_rows, rt + kRowTile, r1, sr, m0 + sc, c0 + sc, ra, rc, av, cv);
#pragma unroll 8
    for (int rr = 0; rr < kRowTile; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&as[rr][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&cs[rr][4 * tx]);
      const float a4[4] = {a.x, a.y, a.z, a.w}, c4[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(a4[i], c4[k], acc[i][k]);
    }
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.x) * grad_floats(u, NH);
  const GradLayout layout(u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      put_grad<NH>(out, layout, u, m0 + 4 * ty + i, c0 + 4 * tx + k, acc[i][k]);
}

__host__ __device__ inline int g_chunks(int b_total, int n_sites) {
  return static_cast<int>((static_cast<int64_t>(b_total) * (n_sites + 1) + kChunkRows - 1) /
                          kChunkRows);
}

// Sums the per-block partial gradients in block order.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int blocks, int wfx) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= wfx) return;
  float v = 0.0f;
#pragma unroll 8
  for (int i = 0; i < blocks; ++i) v += partial[static_cast<int64_t>(i) * wfx + e];
  out[e] = v;
}

cudaError_t launch_sum_partials(const float* partial, float* out, int blocks, int wfx,
                                cudaStream_t stream) {
  sum_partials_kernel<<<(wfx + 255) / 256, 256, 0, stream>>>(partial, out, blocks, wfx);
  return cudaGetLastError();
}

int64_t weight_cotangent_partial_floats(int b_total, int n_sites, int u, int heads) {
  return static_cast<int64_t>(g_chunks(b_total, n_sites)) * grad_floats(u, heads);
}

cudaError_t launch_weight_cotangent(const float* a_rows, const float* c_rows, float* partial,
                                    float* out, int b_total, int n_sites, int u, int heads,
                                    cudaStream_t st) {
  // G's rows are counted in int
  const int64_t n_rows = static_cast<int64_t>(b_total) * (n_sites + 1);
  if (n_rows > INT32_MAX - kChunkRows || heads < 1 || heads > 2) return cudaErrorInvalidValue;
  const int chunks = g_chunks(b_total, n_sites);
  const dim3 grid(chunks, ((u + 3 + kTileG - 1) / kTileG) *
                              ((cot_cols(u, heads) + kTileG - 1) / kTileG));
  if (heads == 1) {
    bwd_weights_kernel<1><<<grid, kGThreads, 0, st>>>(a_rows, c_rows, partial,
                                                      static_cast<int>(n_rows), u);
  } else {
    bwd_weights_kernel<2><<<grid, kGThreads, 0, st>>>(a_rows, c_rows, partial,
                                                      static_cast<int>(n_rows), u);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_sum_partials(partial, out, chunks, grad_floats(u, heads), st);
}

}  // namespace rnnwf

// The floats of the per-chunk partial gradients rnnwf_gru_log_prob_bwd needs.
extern "C" long long rnnwf_gru_bwd_partial_floats(int b_total, int n_sites, int u) {
  return rnnwf::weight_cotangent_partial_floats(b_total, n_sites, u, 1);
}

// Stages b and c after the replay (rnnwf_gru_replay in csrc/tfim_flip.cu,
// which filled rows B*(N+1)*(U+3), gates B*N*4U and p1 B*N).  Scratch: cot
// B*(N+1)*(4U+1) (C) and partial rnnwf_gru_bwd_partial_floats(B, N, U)
// floats; out: weight_floats_exact(U) floats in the layout [wx | wh | bx |
// bh | head w | head b].
extern "C" int rnnwf_gru_log_prob_bwd(const void* samples, const void* g, const void* wh,
                                      const void* hw, const void* rows, const void* gates,
                                      const void* p1, void* cot, void* partial, void* out,
                                      int b_total, int n_sites, int u, void* stream) {
  using namespace rnnwf;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_reverse_sweep(
      Sweep::kGru, k2_sweep_args(samples, g, wh, hw, rows, gates, p1, cot, b_total, n_sites, u),
      st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_cotangent(
      static_cast<const float*>(rows), static_cast<const float*>(cot),
      static_cast<float*>(partial), static_cast<float*>(out), b_total, n_sites, u, 1, st));
}

// Stage b alone (B17, the per-sample jacobian sweep, runs it with g = 1 and
// reads A and C per sample): cot B*(N+1)*(4U+1) (output) from the replay's
// rows, gates and p1.
extern "C" int rnnwf_gru_bwd_sweep(const void* samples, const void* g, const void* wh,
                                   const void* hw, const void* rows, const void* gates,
                                   const void* p1, void* cot, int b_total, int n_sites, int u,
                                   void* stream) {
  using namespace rnnwf;
  return static_cast<int>(launch_reverse_sweep(
      Sweep::kGru, k2_sweep_args(samples, g, wh, hw, rows, gates, p1, cot, b_total, n_sites, u),
      static_cast<cudaStream_t>(stream)));
}
