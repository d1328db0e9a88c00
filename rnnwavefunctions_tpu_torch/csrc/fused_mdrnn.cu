// B12 and B13: the 2D MDRNN's boustrophedon sweep, teacher-forced (joint
// log p of given samples) or sampling (draws the samples and their log p),
// the base pass of B15/B16, which also stores the history and the prefixes,
// and B14's replay (its stage 1, csrc/fused_mdrnn_bwd.cu), which stores the
// history and the head's p(s = 1) per (sample, site).
//
// Replaces: rnnwavefunctions_tpu/ops/fused_mdrnn.py::mdrnn_log_prob (B12)
// and ::mdrnn_sample (B13), both _make_sweep_kernel; and the base pass of
// ops/mdrnn_flip_kernel.py::_make_kernel.
//
// Bound on the H100: latency of the NS dependent sites of a sample, each
// one product [h_h; h_v] . [W_h; W_v] (2U inputs, U outputs).  At the
// flagship (B=500, 16x16, U=50) the sweep is ~1.4 GFLOP, far from the FP32
// peak, so a site's time is the length of its dependent chain.
//
// Design: the sliced base pass of K1, K3, B5 and B6 (csrc/tfim_flip.cu),
// fitted to the MDRNN site.  A block takes kSweepP samples with kSlices x
// U32 threads (U32 = U rounded up to a warp) and one more warp for the
// books.  Thread (ks, j) keeps its entries of W_h and W_v (rows k of the
// ks-th quarter of U, column j) in registers for the whole sweep, and per
// site sums, for the block's samples, the terms of unit j over its quarter:
// the horizontal half (k > 0) and the vertical half (y > 0) each as one
// chain in k order, the half of an absent neighbour skipped, never
// multiplied by zero; the slice's sum is the two halves added.  After a
// barrier, thread (p, j) of the first kSweepP slices adds the slices' sums
// in slice order, then the input terms b + uh[x_h] + uv[x_v] (an absent
// neighbour's term skipped), applies the ELU and stores h into the row
// buffer (and the history).  After a second barrier the next site's
// products start; the books warp meanwhile reads the site's states from
// the row buffer, forms the head's two logits of each sample (a chain per
// lane, then a butterfly, so every lane holds the same bits), takes the
// decision in sample mode from a Philox uniform (keyed by (seed, offset),
// counter (sample, visit position), drawn 32 sites at a time while the
// gate update runs, as K3 does, so B13 and B16 draw the same samples for
// the same key), Kahan-adds log p in visit order, stores the spins, the
// corrected prefix pfx (kFlip) or p1 (kReplay), and writes the spin into
// the block's spin row, where the next site's update reads it.  The head,
// the draw and the books are off the sites' chain: two barriers a site.
// The row buffer keeps each sample's last state of every column
// ((Nx, U, kSweepP) floats, the samples innermost for one broadcast load
// per k): column x holds the site above the current one until the update
// overwrites it, and the previous site's column is the horizontal state.
// kSweepP = 2: at B=500 that is 250 blocks of 9 warps (U=50), two per SM.
// The TPU kernel's lane tiles, feature-major layout and hard selects on
// uninitialised scratch have no counterpart: the boundary reads nothing.
#include "mdrnn_common.cuh"

namespace rnnwf {

constexpr int kSweepP = 2;            // samples per block
static_assert(kSweepP <= kSlices, "the first slices update one sample each");
constexpr int kSweepMaxQuarter = 32;  // the widest quarter of U the registers take

__host__ __device__ inline int sweep_threads(int u) { return kSlices * warp_round(u) + kWarp; }

// Shared memory, in this order: the slices' sums [slice][U32][P], the row
// buffer [Nx][U][P] and the spin rows [P][Nx].
__host__ __device__ inline int sweep_floats(int nx, int u) {
  return kSlices * warp_round(u) * kSweepP + nx * u * kSweepP + kSweepP * nx;
}

size_t mdrnn_sweep_smem_bytes(int nx, int u) {
  if ((u + kSlices - 1) / kSlices > kSweepMaxQuarter) return SIZE_MAX;  // past the registers
  return sizeof(float) * sweep_floats(nx, u);
}

// What the sweep stores beside log p: nothing (B12, B13), B15/B16's base
// pass (the history and the corrected running prefix pfx) or B14's replay
// (the history and p1 = p(s = 1)); `extra` is pfx or p1, (B, NS).
enum class MStore { kNone, kFlip, kReplay };

// KQ: the quarter of U rounded up to 8, a thread's entries of W_h and of
// W_v.  Every U that KQ serves has U32 <= 4 KQ, so the block has at most
// kSlices x 4 KQ + 32 threads; up to KQ = 16 (U <= 64) two blocks share an
// SM.
template <bool kSample, MStore kStore, int KQ>
__global__ void __launch_bounds__(kSlices * 4 * KQ + kWarp, KQ <= 16 ? 2 : 1)
mdrnn_sweep_kernel(int32_t* __restrict__ samples, uint32_t seed, uint32_t offset,
                   MWeightPtrs src, float* __restrict__ hist, float* __restrict__ extra,
                   float* __restrict__ lp, int b_total, int nx, int ny, int u) {
  constexpr int P = kSweepP;
  constexpr int kGroups = KQ / 8;  // the books lanes' units j = lane + 32 q, q < U32 / 32
  constexpr bool kHist = kStore != MStore::kNone;
  extern __shared__ __align__(16) float smem[];
  const int u32 = warp_round(u), ns = nx * ny;
  float* part = smem;                        // [slice][j][p]
  float* rowbuf = part + kSlices * u32 * P;  // [x][k][p]
  float* srow = rowbuf + nx * u * P;         // [p][x]
  const int ks = threadIdx.x / u32, j = threadIdx.x - ks * u32;
  const int lane = threadIdx.x % kWarp;
  const bool books = ks == kSlices;  // the last warp; its lane p keeps sample p
  const float* uh = src.p[0];
  const float* uv = src.p[1];
  const float* wh = src.p[2];
  const float* wv = src.p[3];
  const float* bias = src.p[4];
  const float* hw = src.p[5];
  const float* hb = src.p[6];

  // thread (ks, j): W_h[k, j] and W_v[k, j] for k in [i0, i0 + len)
  const int kc = (u + kSlices - 1) / kSlices, i0 = ks * kc;
  const int len = books ? 0 : max(0, min(u, i0 + kc) - i0);
  float wq[2][KQ];
#pragma unroll
  for (int t = 0; t < KQ; ++t) {
    const bool on = j < u && t < len;
    wq[0][t] = on ? wh[(i0 + t) * u + j] : 0.0f;
    wq[1][t] = on ? wv[(i0 + t) * u + j] : 0.0f;
  }
  // thread (p, j) of the first P slices updates unit j of sample p; a
  // padding slot past the batch repeats the last sample and stores nothing
  const bool upd = ks < P && j < u;
  const int b_mine = blockIdx.x * P + min(ks, P - 1);
  float in_b = 0.0f, in_h[2] = {0.0f, 0.0f}, in_v[2] = {0.0f, 0.0f};
  if (upd) {
    in_b = bias[j];
    in_h[0] = uh[j];
    in_h[1] = uh[u + j];
    in_v[0] = uv[j];
    in_v[1] = uv[u + j];
  }
  // the books: the head's columns of units lane + 32 q, and each sample's
  // row of the lattice
  float hw0[kGroups], hw1[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int jj = lane + kWarp * q;
    hw0[q] = books && jj < u ? hw[2 * jj] : 0.0f;
    hw1[q] = books && jj < u ? hw[2 * jj + 1] : 0.0f;
  }
  const float hb0 = hb[0], hb1 = hb[1];
  int bs[P];
  bool own[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int b = blockIdx.x * P + p;
    own[p] = b < b_total;
    bs[p] = min(b, b_total - 1);
  }
  // books lane p < P: its sample's lattice and row of the (B, NS) outputs
  int bl = bs[0];
  bool own_l = own[0];
#pragma unroll
  for (int p = 1; p < P; ++p) {
    if (lane == p) {
      bl = bs[p];
      own_l = own[p];
    }
  }
  int32_t* s_lat = samples + static_cast<int64_t>(bl) * ns;
  float* ex_row = kStore != MStore::kNone ? extra + static_cast<int64_t>(bl) * ns : nullptr;
  float acc = 0.0f, cmp = 0.0f;
  float uni[P];  // books lane i: the uniforms of site 32 (m / 32) + i
  float s_next = 0.0f;  // teacher-forced: the spin of the next site, loaded ahead
  if (!kSample && books && lane < P) s_next = spin_at(s_lat, 0, nx, ny);

  int x_prev = 0;
  for (int m = 0; m < ns; ++m) {
    const int y = m / nx, k = m - y * nx;
    const int x = (y & 1) ? nx - 1 - k : k;
    // slice ks of unit j's pre-activation for the P samples
    if (!books && j < u) {
      float ah[P], av[P];
#pragma unroll
      for (int p = 0; p < P; ++p) { ah[p] = 0.0f; av[p] = 0.0f; }
      if (k > 0) {
        const float* hh = rowbuf + x_prev * u * P;
#pragma unroll
        for (int t = 0; t < KQ; ++t) {
          if (t < len) {  // uniform over a warp: a warp's threads share ks
            float v[P];
            load_h<P>(hh, i0 + t, v);
#pragma unroll
            for (int p = 0; p < P; ++p) ah[p] = fmaf(v[p], wq[0][t], ah[p]);
          }
        }
      }
      if (y > 0) {
        const float* hv = rowbuf + x * u * P;
#pragma unroll
        for (int t = 0; t < KQ; ++t) {
          if (t < len) {
            float v[P];
            load_h<P>(hv, i0 + t, v);
#pragma unroll
            for (int p = 0; p < P; ++p) av[p] = fmaf(v[p], wq[1][t], av[p]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) part[(ks * u32 + j) * P + p] = ah[p] + av[p];
    }
    __syncthreads();
    if (upd) {
      float a = part[j * P + ks];
#pragma unroll
      for (int s2 = 1; s2 < kSlices; ++s2) a += part[(s2 * u32 + j) * P + ks];
      float in = in_b;
      if (k > 0) in += srow[ks * nx + x_prev] > 0.5f ? in_h[1] : in_h[0];
      if (y > 0) in += srow[ks * nx + x] > 0.5f ? in_v[1] : in_v[0];
      const float pre = a + in;
      const float h = pre > 0.0f ? pre : expf(fminf(pre, 0.0f)) - 1.0f;
      rowbuf[(x * u + j) * P + ks] = h;
      if constexpr (kHist) {
        if (b_mine < b_total) hist[(static_cast<int64_t>(b_mine) * ns + m) * u + j] = h;
      }
    } else if (books) {
      if constexpr (kSample) {
        if (m % kWarp == 0) {
#pragma unroll
          for (int p = 0; p < P; ++p)
            uni[p] = uniform23(seed, offset, static_cast<uint32_t>(bs[p]),
                               static_cast<uint32_t>(m + lane));
        }
      }
    }
    __syncthreads();
    if (books) {
      // the head's logits of site m for the P samples, the same bits on
      // every lane
      float q0[P], q1[P];
#pragma unroll
      for (int p = 0; p < P; ++p) { q0[p] = 0.0f; q1[p] = 0.0f; }
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int jj = lane + kWarp * q;
        if (jj < u) {
          float hv[P];
          load_h<P>(rowbuf + x * u * P, jj, hv);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            q0[p] = fmaf(hv[p], hw0[q], q0[p]);
            q1[p] = fmaf(hv[p], hw1[q], q1[p]);
          }
        }
      }
      float l0 = 0.0f, l1 = 0.0f, ul = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float a0 = warp_sum(q0[p]) + hb0, a1 = warp_sum(q1[p]) + hb1;
        float up = 0.0f;
        if constexpr (kSample) up = __shfl_sync(0xffffffffu, uni[p], m % kWarp);
        if (lane == p) {
          l0 = a0;
          l1 = a1;
          ul = up;
        }
      }
      if (lane < P) {
        float s;
        if constexpr (kSample) {
          s = ul >= sigmoidf_(l0 - l1) ? 1.0f : 0.0f;
        } else {
          s = s_next;
          if (m + 1 < ns) s_next = spin_at(s_lat, m + 1, nx, ny);
        }
        srow[lane * nx + x] = s;
        // log p of both targets from one log-sum-exp
        const float mx = fmaxf(l0, l1);
        const float lse = mx + logf(expf(l0 - mx) + expf(l1 - mx));
        kadd(acc, cmp, (s > 0.5f ? l1 : l0) - lse);
        if (own_l) {
          if constexpr (kSample) s_lat[x * ny + y] = static_cast<int32_t>(s);
          if constexpr (kStore == MStore::kFlip) ex_row[m] = acc - cmp;
          if constexpr (kStore == MStore::kReplay) ex_row[m] = expf(l1 - lse);
        }
      }
    }
    x_prev = x;
  }
  if (books && lane < P && own_l) lp[bl] = acc - cmp;
}

template <bool kSample, MStore kStore, int KQ>
cudaError_t launch_sweep_kq(int32_t* samples, uint32_t seed, uint32_t offset,
                            const MWeightPtrs& w, float* hist, float* extra, float* lp,
                            int b_total, int nx, int ny, int u, cudaStream_t stream) {
  const size_t smem = mdrnn_sweep_smem_bytes(nx, u);
  cudaError_t err = cudaFuncSetAttribute(mdrnn_sweep_kernel<kSample, kStore, KQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b_total + kSweepP - 1) / kSweepP;
  mdrnn_sweep_kernel<kSample, kStore, KQ><<<blocks, sweep_threads(u), smem, stream>>>(
      samples, seed, offset, w, hist, extra, lp, b_total, nx, ny, u);
  return cudaGetLastError();
}

template <bool kSample, MStore kStore>
cudaError_t launch_sweep(int32_t* samples, uint32_t seed, uint32_t offset, const MWeightPtrs& w,
                         float* hist, float* extra, float* lp, int b_total, int nx, int ny,
                         int u, cudaStream_t stream) {
  const int quarter = (u + kSlices - 1) / kSlices;
  if (quarter > kSweepMaxQuarter) return cudaErrorInvalidValue;
  return quarter <= 8    ? launch_sweep_kq<kSample, kStore, 8>(samples, seed, offset, w, hist,
                                                               extra, lp, b_total, nx, ny, u,
                                                               stream)
         : quarter <= 16 ? launch_sweep_kq<kSample, kStore, 16>(samples, seed, offset, w, hist,
                                                                extra, lp, b_total, nx, ny, u,
                                                                stream)
         : quarter <= 24 ? launch_sweep_kq<kSample, kStore, 24>(samples, seed, offset, w, hist,
                                                                extra, lp, b_total, nx, ny, u,
                                                                stream)
                         : launch_sweep_kq<kSample, kStore, 32>(samples, seed, offset, w, hist,
                                                                extra, lp, b_total, nx, ny, u,
                                                                stream);
}

cudaError_t launch_mdrnn_sweep(bool sample, int32_t* samples, uint32_t seed, uint32_t offset,
                               const MWeightPtrs& w, float* hist, float* pfx, float* lp,
                               int b_total, int nx, int ny, int u, cudaStream_t stream) {
  if (hist != nullptr) {
    return sample ? launch_sweep<true, MStore::kFlip>(samples, seed, offset, w, hist, pfx, lp,
                                                      b_total, nx, ny, u, stream)
                  : launch_sweep<false, MStore::kFlip>(samples, seed, offset, w, hist, pfx, lp,
                                                       b_total, nx, ny, u, stream);
  }
  return sample ? launch_sweep<true, MStore::kNone>(samples, seed, offset, w, hist, pfx, lp,
                                                    b_total, nx, ny, u, stream)
                : launch_sweep<false, MStore::kNone>(samples, seed, offset, w, hist, pfx, lp,
                                                     b_total, nx, ny, u, stream);
}

}  // namespace rnnwf

// B12: samples (B, Nx, Ny) int32 -> out (B) joint log p.
extern "C" int rnnwf_mdrnn_log_prob(const void* samples, const void* uh, const void* uv,
                                    const void* wh, const void* wv, const void* b,
                                    const void* hw, const void* hb, void* out, int b_total,
                                    int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return static_cast<int>(launch_mdrnn_sweep(
      false, static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u,
      mweight_ptrs(uh, uv, wh, wv, b, hw, hb), nullptr, nullptr, static_cast<float*>(out),
      b_total, nx, ny, u, static_cast<cudaStream_t>(stream)));
}

// B13: draws samples (B, Nx, Ny) int32 and writes their log p (B).
extern "C" int rnnwf_mdrnn_sample(unsigned int seed, unsigned int offset, const void* uh,
                                  const void* uv, const void* wh, const void* wv, const void* b,
                                  const void* hw, const void* hb, void* samples, void* lp,
                                  int b_total, int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return static_cast<int>(launch_mdrnn_sweep(
      true, static_cast<int32_t*>(samples), seed, offset, mweight_ptrs(uh, uv, wh, wv, b, hw, hb),
      nullptr, nullptr, static_cast<float*>(lp), b_total, nx, ny, u,
      static_cast<cudaStream_t>(stream)));
}

// B12 storing B14's replay: the joint log p (lp, B floats), the cell-output
// history in visit order (hist, B*NS*U) and the head's p(s = 1) per (sample,
// visit position) (p1, B*NS).
extern "C" int rnnwf_mdrnn_replay(const void* samples, const void* uh, const void* uv,
                                  const void* wh, const void* wv, const void* b, const void* hw,
                                  const void* hb, void* hist, void* p1, void* lp, int b_total,
                                  int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  return static_cast<int>(launch_sweep<false, MStore::kReplay>(
      static_cast<int32_t*>(const_cast<void*>(samples)), 0u, 0u,
      mweight_ptrs(uh, uv, wh, wv, b, hw, hb), static_cast<float*>(hist),
      static_cast<float*>(p1), static_cast<float*>(lp), b_total, nx, ny, u,
      static_cast<cudaStream_t>(stream)));
}
