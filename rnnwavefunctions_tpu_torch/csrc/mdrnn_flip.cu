// B15 and B16: the 2D TFIM single-flip amplitude-ratio sum of the MDRNN,
//     ratio[b] = sum_f exp(0.5 * (log p(sigma_b with site f flipped) - log p(sigma_b))),
// with the base log p as a by-product.  B15 reads the given samples; B16
// (sample mode) draws them first in the same base pass.
//
// Replaces: rnnwavefunctions_tpu/ops/mdrnn_flip_kernel.py::mdrnn_flip_ratio_sum
// (B15) and ::mdrnn_sample_and_flip_sum (B16), both _make_kernel.
//
// Bound on the H100: the flip suffixes.  The MDRNN is autoregressive in the
// boustrophedon visit order, so flipping the spin at visit position f leaves
// positions < f untouched and only positions f..NS-1 are recomputed (prefix
// sharing): B*NS*(NS+1)/2 site steps, 16.4 M at the flagship (B=500, 16x16,
// U=50), each two U x U products (4U^2 of its 4U^2 + 12U + 10 operations),
// ~164 GFLOP against ~1.4 for the base pass.  On the FP32 pipes that is
// 2.6 ms at the peak, bound by shared-memory loads and issue; on the
// tensor cores the products' share is 0.33 ms at the TF32 peak.
//
// Design: three launches.
//   1. The base pass (fused_mdrnn.cu's sliced sweep): in
//      sample mode it draws the spins; it stores the (B, NS, U) cell-output
//      history in visit order, the corrected prefix pfx[m] = log p(positions
//      <= m) and the base log p.
//   2. The suffix pass on the tensor cores: a block (one warpgroup) runs T
//      trajectories that share the flip f, so their control flow is
//      uniform, through sites f..NS-1.  Each site is one product
//          [W_h; W_v]^T (U x 2Kp) . [h_h; h_v] (2Kp x T)   (Kp = U rounded up to 8)
//      by wgmma m64nTk8 in 3xTF32 (csrc/tf32_wgmma.cuh; U padded to 64
//      rows per tile), the k-steps of an absent neighbour (a row start, the
//      first row) skipped.  A is held in registers for the whole kernel
//      where U <= 56 (112 registers; wider, loaded per k-step from a
//      fragment table in shared memory), so a site issues all its k-steps
//      as one wgmma group and waits once: with a wait per k-step the
//      product's latency set the site's time.  B is the two states in
//      shared memory in the core-matrix layout, written by the threads
//      whose accumulators hold them: the gate update writes h_m (split into
//      the state and its remainder lo) as the next site's h_h, and the same
//      thread stages the next site's h_v.  The update adds the input terms b + uh[x_h] + uv[x_v] (an
//      absent neighbour's term skipped, as in the base pass), applies the
//      ELU (one expf) and the head's partials, all elements' arithmetic
//      before their stores so that they interleave; the head's two logits
//      are shuffle sums over each warp's units, added over the warps in
//      order by one warp, which keeps each trajectory's Kahan pair and
//      log-softmax and settles a site's log p while the next site's
//      products run.  One barrier per site.
//      The row buffer holds each trajectory's recomputed states of the last
//      Nx visit positions, in plain float32 indexed by column, so the site
//      one row below reads its vertical state there where the site above
//      was recomputed (vis_up >= f); each element is written and read by
//      the one thread that owns it in the accumulators, so staging it needs
//      no barrier, and a column is laid out by thread for float4 accesses
//      that a warp makes contiguous.  It is loaded a site ahead, as is the
//      base history's state where vis_up < f.  The vertical spin is s[vis_up],
//      flipped iff vis_up == f.
//      T = 32, the widest product per wgmma (at the flagship on an H100,
//      T = 16 took 9.32-9.44 ms, T = 32 6.55-6.56; PERF.md).  Registers
//      bound a block of 32 to two per SM, so the
//      row buffers live in device memory (L2, read a site ahead), one set
//      per resident block: in shared memory, 102 KB of them at the
//      flagship would leave one block per SM.  The grid is the blocks that
//      fit on the card at once, each walking the (flip, group of T) items
//      in order of flip, longest suffix first, with a stride of the grid:
//      a trajectory's result does not depend on the block or the column
//      it lands in.
//   3. A per-sample sum of the NS ratio terms in flip order, so the result
//      does not depend on how blocks were scheduled.
// The TPU kernel's wavefront groups, flip-pair lane packing and row-window
// spill ring are TPU machinery and have no counterpart here.
#include <algorithm>

#include "mdrnn_common.cuh"
#include "tf32_wgmma.cuh"

namespace rnnwf {

constexpr int kSufThreads = 4 * kWarp;  // one warpgroup
// k-steps of A held in registers for the whole kernel where U <= 56 (one
// 64-row tile: 112 registers); wider U loads them per k-step
constexpr int kHeldSteps = 14;

// Suffix pass, in this order: the B operand in two parts (the state and its
// remainder lo), each T x 2Kp in the core-matrix layout ([h_h | h_v] along
// K); the A-fragment table ((2Kp / 8) k-steps x Ug / 64 tiles x 4 warps x
// 32 lanes x 4, Ug = U rounded up to 64); the head partials [site
// parity][warp][trajectory][2]; T = kSuffixTraj.  The row buffers
// (Nx x U x T per block) are in device memory.
__host__ __device__ inline int suffix_fixed_floats(int u) {
  constexpr int t = kSuffixTraj;
  const int k2 = 2 * pad8(u);
  return 2 * t * k2 + (k2 / 8) * (pad64(u) / kGateRows) * 4 * kWarp * 4 + 2 * 4 * t * 2;
}
// A block's row buffers: Nx columns of the states its threads own in the
// accumulators (Ug x T, the padding units zero), [column][float4 q][thread]
// [4], so that a warp's float4 access is 512 contiguous bytes.
__host__ __device__ inline int64_t suffix_row_floats(int nx, int u) {
  return static_cast<int64_t>(nx) * pad64(u) * kSuffixTraj;
}

size_t mdrnn_suffix_smem_bytes(int u) { return sizeof(float) * suffix_fixed_floats(u); }

// Stores / loads the thread's states v[mg][rh][e] of one column of its row
// buffer (rowbuf: the column's start, at the thread's first float4).
template <int MG, int E>
__device__ __forceinline__ void put_row(float* rowbuf, const float (&v)[MG][2][E]) {
  constexpr int Q = MG * 2 * E / 4;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      f[i] = v[j / (2 * E)][(j / E) % 2][j % E];
    }
    reinterpret_cast<float4*>(rowbuf)[q * kSufThreads] = make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <int MG, int E>
__device__ __forceinline__ void get_row(const float* rowbuf, float (&v)[MG][2][E]) {
  constexpr int Q = MG * 2 * E / 4;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 a = reinterpret_cast<const float4*>(rowbuf)[q * kSufThreads];
    const float f[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      v[j / (2 * E)][(j / E) % 2][j % E] = f[i];
    }
  }
}

// MG: 64-row tiles (U <= 64 MG).  row_scratch: the row buffers,
// suffix_row_floats per block.
template <int MG>
__global__ void __launch_bounds__(kSufThreads, 1)
mdrnn_tc_suffix_kernel(const int32_t* __restrict__ samples, MWeightPtrs w,
                       const float* __restrict__ hist, const float* __restrict__ pfx,
                       const float* __restrict__ lp, float* __restrict__ terms,
                       float* __restrict__ row_scratch, int b_total, int nx, int ny, int u) {
  constexpr int T = kSuffixTraj;
  constexpr int E = T / 4;  // trajectories per thread: 8 cb + 2 t + v, e = 2 cb + v
  extern __shared__ __align__(16) float smem[];
  const int kp = pad8(u), k2 = 2 * kp, ksh = kp / 8, ks_n = k2 / 8, ns = nx * ny;
  const int sf = T * k2;
  float* states = smem;                                    // [state, lo][T x k2]
  float* wfrag = states + 2 * sf;                          // [k-step][tile][warp][lane][4]
  float* red = wfrag + ks_n * MG * 4 * kWarp * 4;          // [parity][warp][traj][2]
  // the thread's first float4 of column 0; a column is Ug * T floats
  float* rowbuf = row_scratch + static_cast<int64_t>(blockIdx.x) * suffix_row_floats(nx, u) +
                  4 * threadIdx.x;
  const int col = MG * kGateRows * T;
  const float* wh = w.p[2];
  const float* wv = w.p[3];
  // A fragment e of lane (g, t) in warp wp: row 16 wp + g + 8 (e & 1),
  // column t + 4 (e >> 1) of the tile; row (tile m, r) is unit 64 m + r,
  // column k of K is W_h's row k (k < Kp) or W_v's row k - Kp
  for (int i = threadIdx.x; i < ks_n * MG * 4 * kWarp * 4; i += blockDim.x) {
    const int e = i & 3, l = (i >> 2) & (kWarp - 1), wp = (i >> 7) & 3, tile = i >> 9;
    const int ks = tile / MG, m = tile - ks * MG;
    const int k = 8 * ks + (l & 3) + 4 * (e >> 1);
    const int unit = m * kGateRows + 16 * wp + (l >> 2) + 8 * (e & 1);
    const bool vert = k >= kp;
    const int kk = vert ? k - kp : k;
    wfrag[i] = (kk < u && unit < u) ? (vert ? wv : wh)[kk * u + unit] : 0.0f;
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  // the input terms and head weights of the thread's units, in registers
  float tb[MG][2], tuh[MG][2][2], tuv[MG][2][2], thw[MG][2][2];
#pragma unroll
  for (int mg = 0; mg < MG; ++mg)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int unit = mg * kGateRows + 16 * warp + g + 8 * rh;
      const bool ok = unit < u;
      tb[mg][rh] = ok ? w.p[4][unit] : 0.0f;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        tuh[mg][rh][x] = ok ? w.p[0][x * u + unit] : 0.0f;
        tuv[mg][rh][x] = ok ? w.p[1][x * u + unit] : 0.0f;
        thw[mg][rh][x] = ok ? w.p[5][2 * unit + x] : 0.0f;
      }
    }
  const float hb0 = w.p[6][0], hb1 = w.p[6][1];
  const bool head = warp == 3 && lane < T;  // lane n keeps trajectory n's Kahan pair
  __syncthreads();  // the fragment table
  constexpr int KA = MG == 1 ? kHeldSteps : 1;
  const bool held = MG == 1 && ks_n <= kHeldSteps;
  uint32_t ahi[KA][MG][4], alo[KA][MG][4];
  if (held) load_a_all<KA, MG>(wfrag, ks_n, warp, lane, ahi, alo);

  const int groups = (b_total + T - 1) / T;
  const int items = ns * groups;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int f = item / groups;
    const int bt0 = (item - f * groups) * T;
    const int yf = f / nx, kf = f - yf * nx;
    const int upf = f - 2 * kf - 1;
    // the start: h_h = hist[f-1] (within a row), h_v = hist[vis_up(f)]
    // (below the first row), zeros where absent; padding trajectories
    // repeat the last sample
    for (int i = threadIdx.x; i < T * kp; i += blockDim.x) {
      const int n = i / kp, k = i - n * kp;
      const int64_t row = static_cast<int64_t>(min(bt0 + n, b_total - 1)) * ns;
      const float hh = kf > 0 && k < u ? hist[(row + f - 1) * u + k] : 0.0f;
      const float hv = yf > 0 && k < u ? hist[(row + upf) * u + k] : 0.0f;
      states[state_at(n, k, k2)] = hh;
      states[sf + state_at(n, k, k2)] = tf32_lo(hh);
      states[state_at(n, kp + k, k2)] = hv;
      states[sf + state_at(n, kp + k, k2)] = tf32_lo(hv);
    }
    const int32_t* srow[E];
    float xh[E], xv[E];  // the current site's neighbour spins
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int n = 8 * (e >> 1) + 2 * t + (e & 1);
      srow[e] = samples + static_cast<int64_t>(min(bt0 + n, b_total - 1)) * ns;
      xh[e] = kf > 0 ? spin_at(srow[e], f - 1, nx, ny) : 0.0f;
      xv[e] = yf > 0 ? spin_at(srow[e], upf, nx, ny) : 0.0f;
    }
    const int64_t my_row = static_cast<int64_t>(min(bt0 + lane, b_total - 1)) * ns;
    float acc = 0.0f, cmp = 0.0f;
    if (head && f > 0) acc = pfx[my_row + f - 1];
    // the head's last site, added to the Kahan pair while the next site's
    // products run
    bool pending = false;
    float pl0 = 0.0f, pl1 = 0.0f, ptgt = 0.0f;
    const auto settle = [&] {
      if (pending) kadd(acc, cmp, logp2(pl0 + hb0, pl1 + hb1, ptgt));
      pending = false;
    };
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    int y = yf, k = kf;
    for (int m = f; m < ns; ++m) {
      const int x = (y & 1) ? nx - 1 - k : k;
      const int k1 = k + 1 == nx ? 0 : k + 1, y1 = k + 1 == nx ? y + 1 : y;
      const bool more = m + 1 < ns;
      const int x1 = (y1 & 1) ? nx - 1 - k1 : k1;
      const int up1 = m + 1 - 2 * k1 - 1;
      const bool vnext = more && y1 > 0;       // the next site has a vertical neighbour
      const bool vhist = vnext && up1 < f;     // ... from the base history
      // loads ahead of the product, used after it: this site's spins (the
      // next site's x_h), the next site's vertical spins and its vertical
      // state, from the history or from the row buffer (where the site
      // above is not this one)
      const bool vsame = vnext && !vhist && x1 == x;
      int32_t rs[E], rv[E];
      float vpre[MG][2][E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        rs[e] = srow[e][x * ny + y];
        rv[e] = vnext ? srow[e][x1 * ny + y1 - 1] : 0;
      }
      if (vhist) {
#pragma unroll
        for (int mg = 0; mg < MG; ++mg)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const int unit = mg * kGateRows + 16 * warp + g + 8 * rh;
#pragma unroll
            for (int e = 0; e < E; ++e)
              vpre[mg][rh][e] =
                  unit < u ? hist[((srow[e] - samples) + up1) * u + unit] : 0.0f;
          }
      } else if (vnext && !vsame) {
        get_row<MG, E>(rowbuf + x1 * col, vpre);
      }
      const int32_t rt = head ? samples[my_row + x * ny + y] : 0;

      // the product; the head's last site is settled while it runs
      const bool hon = k > 0, von = y > 0;
      float d[MG][T / 2];
#pragma unroll
      for (int mg = 0; mg < MG; ++mg)
#pragma unroll
        for (int i = 0; i < T / 2; ++i) {
          d[mg][i] = 0.0f;
          pin(d[mg][i]);
        }
      const int ks0 = hon ? 0 : ksh, ks1 = von ? ks_n : ksh;
      if (ks0 < ks1) {
        if (held) {
          product_held_a<KA, MG, T>(d, ahi, alo, states, states + sf, k2 * 32, ks0, ks1, settle);
        } else {
          product_k_steps<MG, T>(d, wfrag, states, states + sf, k2 * 32, ks0, ks1, warp, lane,
                                 settle);
        }
      }
      settle();

      // the gate update on the accumulators: the states (arithmetic only, so
      // the elements interleave), the head's partials, then the stores: the
      // next site's h_h in place, the row buffer, the next site's h_v
      float hs[MG][2][E];
#pragma unroll
      for (int mg = 0; mg < MG; ++mg)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const bool real = mg * kGateRows + 16 * warp + g + 8 * rh < u;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float a = tb[mg][rh];
            if (hon) a += xh[e] > 0.5f ? tuh[mg][rh][1] : tuh[mg][rh][0];
            if (von) a += xv[e] > 0.5f ? tuv[mg][rh][1] : tuv[mg][rh][0];
            const float pre = a + d[mg][4 * (e >> 1) + 2 * rh + (e & 1)];
            const float em1 = expf(fminf(pre, 0.0f)) - 1.0f;
            hs[mg][rh][e] = real ? (pre > 0.0f ? pre : em1) : 0.0f;
          }
        }
      float q0[E], q1[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        q0[e] = 0.0f;
        q1[e] = 0.0f;
#pragma unroll
        for (int mg = 0; mg < MG; ++mg)
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            q0[e] = fmaf(hs[mg][rh][e], thw[mg][rh][0], q0[e]);
            q1[e] = fmaf(hs[mg][rh][e], thw[mg][rh][1], q1[e]);
          }
      }
#pragma unroll
      for (int mg = 0; mg < MG; ++mg)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int unit = mg * kGateRows + 16 * warp + g + 8 * rh;
          if (unit >= kp) continue;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int traj = 8 * (e >> 1) + 2 * t + (e & 1);
            const float hv = hs[mg][rh][e];
            // in place: only this thread reads or writes the element here
            const int at = state_at(traj, unit, k2);
            states[at] = hv;
            states[sf + at] = tf32_lo(hv);
            if (vnext) {
              const float v = vsame ? hv : vpre[mg][rh][e];
              states[at + 8 * kp] = v;  // state_at(traj, kp + unit, k2)
              states[sf + at + 8 * kp] = tf32_lo(v);
            }
          }
        }
      put_row<MG, E>(rowbuf + x * col, hs);
      // the head: sums over the warp's units (the lanes of one t), then over
      // the warps in order
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int off = 4; off < kWarp; off <<= 1) {
          q0[e] += __shfl_xor_sync(0xffffffffu, q0[e], off);
          q1[e] += __shfl_xor_sync(0xffffffffu, q1[e], off);
        }
      const int par = (m - f) & 1;
      float* red_n = red + (par * 4 + warp) * T * 2;
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int traj = 8 * (e >> 1) + 2 * t + (e & 1);
          red_n[2 * traj] = q0[e];
          red_n[2 * traj + 1] = q1[e];
        }
      }
      // the next site's inputs: x_h the target here (flipped at f), x_v the
      // spin above it (flipped where that is f)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float sh = static_cast<float>(rs[e]), sv = static_cast<float>(rv[e]);
        xh[e] = m == f ? 1.0f - sh : sh;
        xv[e] = up1 == f ? 1.0f - sv : sv;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (head) {
        const float* red_p = red + par * 4 * T * 2;
        pl0 = 0.0f;
        pl1 = 0.0f;
#pragma unroll
        for (int wp = 0; wp < 4; ++wp) {
          pl0 += red_p[wp * T * 2 + 2 * lane];
          pl1 += red_p[wp * T * 2 + 2 * lane + 1];
        }
        const float st = static_cast<float>(rt);
        ptgt = m == f ? 1.0f - st : st;
        pending = true;
      }
      k = k1;
      y = y1;
    }
    settle();
    if (head && bt0 + lane < b_total)
      terms[my_row + f] = expf(0.5f * ((acc - cmp) - lp[bt0 + lane]));
  }
}

__global__ void mdrnn_flip_sum_kernel(const float* __restrict__ terms,
                                      float* __restrict__ ratio, int b_total, int ns) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= b_total) return;
  const float* t = terms + static_cast<int64_t>(b) * ns;
  float v = 0.0f;
  for (int f = 0; f < ns; ++f) v += t[f];
  ratio[b] = v;
}

// The suffix pass's launch: its shared memory and its grid.
struct SuffixPlan {
  size_t smem = 0;
  int grid = 0;
  int64_t scratch_floats = 0;  // the row buffers of all blocks
};

template <int MG>
cudaError_t plan_grid(SuffixPlan& plan, int items) {
  cudaError_t err = cudaFuncSetAttribute(mdrnn_tc_suffix_kernel<MG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mdrnn_tc_suffix_kernel<MG>,
                                                      kSufThreads, plan.smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan.grid = std::min(items, per_sm * sms);
  return cudaSuccess;
}

cudaError_t plan_suffix(SuffixPlan& plan, int b_total, int nx, int ny, int u) {
  if (u > 2 * kGateRows) return cudaErrorInvalidValue;
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  plan = SuffixPlan{};
  plan.smem = mdrnn_suffix_smem_bytes(u);
  if (plan.smem > static_cast<size_t>(limit)) return cudaErrorInvalidConfiguration;
  const int items = nx * ny * ((b_total + kSuffixTraj - 1) / kSuffixTraj);
  err = pad64(u) == kGateRows ? plan_grid<1>(plan, items) : plan_grid<2>(plan, items);
  if (err != cudaSuccess) return err;
  plan.scratch_floats = static_cast<int64_t>(plan.grid) * suffix_row_floats(nx, u);
  return cudaSuccess;
}

template <int MG>
cudaError_t launch_suffix(const SuffixPlan& plan, const int32_t* samples, const MWeightPtrs& w,
                          const float* hist, const float* pfx, const float* lp, float* terms,
                          float* row_scratch, int b_total, int nx, int ny, int u,
                          cudaStream_t st) {
  mdrnn_tc_suffix_kernel<MG><<<plan.grid, kSufThreads, plan.smem, st>>>(
      samples, w, hist, pfx, lp, terms, row_scratch, b_total, nx, ny, u);
  return cudaGetLastError();
}

int launch_mdrnn_flip(bool sample, int32_t* samples, uint32_t seed, uint32_t offset,
                      const MWeightPtrs& w, void* hist, void* pfx, void* terms, void* lp,
                      void* ratio, void* row_scratch, long long scratch_floats, int b_total,
                      int nx, int ny, int u, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SuffixPlan plan;
  cudaError_t err = plan_suffix(plan, b_total, nx, ny, u);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.scratch_floats > scratch_floats) return static_cast<int>(cudaErrorInvalidValue);
  err = launch_mdrnn_sweep(sample, samples, seed, offset, w, static_cast<float*>(hist),
                           static_cast<float*>(pfx), static_cast<float*>(lp), b_total, nx, ny, u,
                           st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* h = static_cast<const float*>(hist);
  const float* p = static_cast<const float*>(pfx);
  const float* l = static_cast<const float*>(lp);
  float* tm = static_cast<float*>(terms);
  float* rs = static_cast<float*>(row_scratch);
  err = pad64(u) == kGateRows
            ? launch_suffix<1>(plan, samples, w, h, p, l, tm, rs, b_total, nx, ny, u, st)
            : launch_suffix<2>(plan, samples, w, h, p, l, tm, rs, b_total, nx, ny, u, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  mdrnn_flip_sum_kernel<<<(b_total + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(terms), static_cast<float*>(ratio), b_total, nx * ny);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rnnwf

// The floats of device memory the suffix pass needs for its row buffers at
// this shape.  Returns the CUDA error of the planning.
extern "C" int rnnwf_mdrnn_suffix_scratch_floats(int b_total, int nx, int ny, int u,
                                                 long long* floats) {
  rnnwf::SuffixPlan plan;
  const cudaError_t err = rnnwf::plan_suffix(plan, b_total, nx, ny, u);
  *floats = plan.scratch_floats;
  return static_cast<int>(err);
}

// Scratch (allocated by the caller): hist B*NS*U, pfx and terms B*NS floats,
// row_scratch rnnwf_mdrnn_suffix_scratch_floats (scratch_floats its size).
extern "C" int rnnwf_mdrnn_flip_ratio_sum(const void* samples, const void* uh, const void* uv,
                                          const void* wh, const void* wv, const void* b,
                                          const void* hw, const void* hb, void* hist,
                                          void* pfx, void* terms, void* lp, void* ratio,
                                          void* row_scratch, long long scratch_floats,
                                          int b_total, int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return launch_mdrnn_flip(false, static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u,
                           mweight_ptrs(uh, uv, wh, wv, b, hw, hb), hist, pfx, terms, lp,
                           ratio, row_scratch, scratch_floats, b_total, nx, ny, u, stream);
}

extern "C" int rnnwf_mdrnn_sample_and_flip_sum(unsigned int seed, unsigned int offset,
                                               const void* uh, const void* uv, const void* wh,
                                               const void* wv, const void* b, const void* hw,
                                               const void* hb, void* samples, void* hist,
                                               void* pfx, void* terms, void* lp, void* ratio,
                                               void* row_scratch, long long scratch_floats,
                                               int b_total, int nx, int ny, int u,
                                               void* stream) {
  using namespace rnnwf;
  return launch_mdrnn_flip(true, static_cast<int32_t*>(samples), seed, offset,
                           mweight_ptrs(uh, uv, wh, wv, b, hw, hb), hist, pfx, terms, lp, ratio,
                           row_scratch, scratch_floats, b_total, nx, ny, u, stream);
}
