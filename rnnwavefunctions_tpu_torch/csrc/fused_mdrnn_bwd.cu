// B14: the VJP of sum_b g_b log p(sigma_b) with respect to every weight of
// the 2D MDRNN cell and its 2-logit head.
//
// Replaces: rnnwavefunctions_tpu/ops/fused_mdrnn_bwd.py::mdrnn_log_prob_bwd
// (_make_bwd_kernel), the backward half of the loss gradient.
//
// Bound on the H100: latency.  The work is six U x U products per (sample,
// site), about 1.6 GFLOP at the flagship (B=500, 16x16, U=50): 0.06 ms at
// the FP32 peak.  But a sample's sites form two dependent chains of NS
// steps (the forward replay and the reverse sweep), and the TPU kernel's
// body, which adds the two U x U weight cotangents' outer products at every
// site, puts them on the reverse chain.
//
// Design: K2's three stages (csrc/fused_gru_bwd.cu), with two recurrent
// products per site.
//   1. The replay is B12's sweep storing each sample's cell-output history
//      h_m in visit order and the head's p1 = p(s_m = 1) (csrc/
//      fused_mdrnn.cu, MStore::kReplay).  MDRNNLogProb runs it as its
//      forward when a gradient follows, so that the backward starts at
//      stage 2.
//   2. The reverse sweep (mdrnn_bwd_sweep_kernel), a block per P = 2
//      samples (a ragged batch pads its last block), m = NS-1..0 (math in
//      fused_mdrnn_bwd.py:12-20 of the JAX package): thread (p, j) of the
//      first P slices forms unit j's
//          dl1 = g (s - p1),
//          dh = (hw[:,1] - hw[:,0]) dl1 + horizontal carry + column buffer,
//          dpre = dh elu'(h), elu'(h) = 1 if h > 0 else h + 1,
//      writes the row C = [dpre | dl1] and dpre to shared memory (its values
//      of site m-1 are loaded while site m computes); then kSlices x U
//      threads sum the carry to m-1, Wh dpre (k > 0), and the column
//      buffer for the site above, Wv dpre (y > 0), thread (ks, j) the terms
//      of unit j over the ks-th quarter of U with its entries of Wh and Wv
//      in registers for the whole sweep, and thread (p, j) adds the
//      quarters in order.  The column buffer (Nx x U per sample) stays in
//      shared memory, each entry read and written by its owner thread.  No
//      weight cotangent is accumulated on this chain.
//   3. The weight cotangent (mdrnn_bwd_weights_kernel), a throughput
//      kernel: one product G = A^T C over the B NS rows (b, m) with
//          A = [h_h | h_v | sh (1 - x_h) | sh x_h | sv (1 - x_v) | sv x_v | 1]
//      (2U + 5; h_h = h_{m-1}, h_v = h_{m-2k-1}, sh = k > 0, sv = y > 0),
//      gathered from the history and the samples inside the product (A is
//      not written; each row's neighbours are found once per block, into
//      shared memory), against C = [dpre | dl1]: G holds dWh, dWv, dUh,
//      dUv, db and the head bias; one more block per chunk sums the head
//      weight's h_m^T dl1.  A block sums one 64 x 64 tile of G over a chunk
//      of kMChunkRows rows, 32 rows at a time through shared memory (the next
//      32 rows' loads in flight while these are multiplied), a 4 x 4
//      register tile per thread, in row order; then launch_sum_partials adds
//      the chunks' partials in chunk order.  No atomics: the same bits on
//      every run.
// The scratch (U + 1 floats of C per (sample, site) beside the replay's U + 1:
// 26 MB each at the flagship) comes from the caller;
// rnnwf_mdrnn_bwd_partial_floats sizes the partials.
#include <climits>

#include "mdrnn_common.cuh"

namespace rnnwf {

constexpr int kMBwdP = 2;          // samples per reverse-sweep block
static_assert(kMBwdP <= kSlices, "the first slices update one sample each");
constexpr int kMMaxQuarter = 32;   // the widest quarter of U the sweep's registers take
constexpr int kMChunkRows = 512;   // rows of G per stage-3 block
constexpr int kMTile = 64;         // G's tile edge
constexpr int kMRowTile = 32;      // rows staged at a time
constexpr int kMThreads = 256;     // 16 x 16 threads, 4 x 4 entries each
constexpr int kMStage = kMRowTile * kMTile / kMThreads;  // staged values per thread and tile

// Reverse sweep, in this order: hw[:, 1] - hw[:, 0] (U, padded to 4); dpre
// [U][P]; the slices' sums [slice][Wh, Wv][U32][P]; the column buffers
// [P][Nx][U].
__host__ __device__ inline int msweep_floats(int nx, int u) {
  constexpr int p = kMBwdP;
  return ((u + 3) & ~3) + u * p + kSlices * 2 * warp_round(u) * p + p * nx * u;
}

size_t mdrnn_bwd_smem_bytes(int nx, int u) {
  if ((u + kSlices - 1) / kSlices > kMMaxQuarter) return SIZE_MAX;  // past the registers
  return sizeof(float) * msweep_floats(nx, u);
}

// KQ: the quarter of U rounded up to 8 (a thread's entries of Wh and of Wv).
// At most kSlices x 128 threads: registers for 4 warps of each SM
// sub-partition (16,384 / (4 x 32) = 128 a thread).
template <int KQ>
__global__ void __launch_bounds__(kSlices * 128)
mdrnn_bwd_sweep_kernel(const int32_t* __restrict__ samples, const float* __restrict__ g,
                       const float* __restrict__ wh, const float* __restrict__ wv,
                       const float* __restrict__ hw, const float* __restrict__ hist,
                       const float* __restrict__ p1, float* __restrict__ cot, int b_total,
                       int nx, int ny, int u) {
  constexpr int P = kMBwdP;
  extern __shared__ __align__(16) float smem[];
  const int u32 = warp_round(u), ns = nx * ny, rc = u + 1;
  float* hwd = smem;
  float* dpre = hwd + ((u + 3) & ~3);     // [j][p]
  float* part = dpre + u * P;             // [slice][Wh, Wv][j][p]
  float* colbuf = part + kSlices * 2 * u32 * P;  // [p][x][j]
  for (int k = threadIdx.x; k < u; k += blockDim.x) hwd[k] = hw[2 * k + 1] - hw[2 * k];
  for (int i = threadIdx.x; i < P * nx * u; i += blockDim.x) colbuf[i] = 0.0f;
  const int ks = threadIdx.x / u32, j = threadIdx.x - ks * u32;
  // thread (ks, j) sums W[j, i] dpre[i] for i in the ks-th quarter of U
  // [i0, i0 + len): its entries of Wh and Wv, in registers
  const int kc = (u + kSlices - 1) / kSlices, i0 = ks * kc, len = max(0, min(u, i0 + kc) - i0);
  float wq[2][KQ];
#pragma unroll
  for (int t = 0; t < KQ; ++t) {
    const bool on = j < u && t < len;
    wq[0][t] = on ? wh[static_cast<int64_t>(j) * u + i0 + t] : 0.0f;
    wq[1][t] = on ? wv[static_cast<int64_t>(j) * u + i0 + t] : 0.0f;
  }
  // thread (p, j) of the first P slices carries unit j of sample p; a
  // padding slot past the batch repeats the last sample and stores nothing
  const int b = blockIdx.x * P + min(ks, P - 1);
  const int b_row = min(b, b_total - 1);
  const bool carry = ks < P && j < u;
  const bool mine = carry && b < b_total;
  const float gb = g[b_row];
  const int32_t* s_lat = samples + static_cast<int64_t>(b_row) * ns;
  const float* h_row = hist + static_cast<int64_t>(b_row) * ns * u;
  const float* p_row = p1 + static_cast<int64_t>(b_row) * ns;
  float* c_rows = cot + static_cast<int64_t>(b_row) * ns * rc;
  float* col = colbuf + min(ks, P - 1) * nx * u;
  __syncthreads();

  // unit j's values at visit position m: h_m[j], p1_m, s_m
  auto load = [&](int m, float& h, float& p, float& s) {
    h = h_row[static_cast<int64_t>(m) * u + j];
    p = p_row[m];
    s = spin_at(s_lat, m, nx, ny);
  };
  float h_cur = 0.0f, p_cur = 0.0f, s_cur = 0.0f, h_nxt = 0.0f, p_nxt = 0.0f, s_nxt = 0.0f;
  if (carry) load(ns - 1, h_cur, p_cur, s_cur);
  float dhc = 0.0f;  // the horizontal carry from m+1
  for (int m = ns - 1; m >= 0; --m) {
    const int y = m / nx, k = m - y * nx;
    const int x = (y & 1) ? nx - 1 - k : k;
    if (carry && m > 0) load(m - 1, h_nxt, p_nxt, s_nxt);
    if (carry) {
      const float dl1 = gb * (s_cur - p_cur);
      float dh = hwd[j] * dl1;
      if (k < nx - 1) dh += dhc;
      if (y < ny - 1) dh += col[x * u + j];
      const float dp = dh * (h_cur > 0.0f ? 1.0f : h_cur + 1.0f);
      if (mine) {
        float* c_row = c_rows + static_cast<int64_t>(m) * rc;
        c_row[j] = dp;
        if (j == 0) c_row[u] = dl1;
      }
      dpre[j * P + ks] = dp;
    }
    if (m == 0) break;
    __syncthreads();
    // slice ks of (Wh dpre)[j] and (Wv dpre)[j] for the P samples, each
    // only where the site it goes to exists (uniform over the block)
    if (j < u) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 0 ? k == 0 : y == 0) continue;
        float a[P];
#pragma unroll
        for (int p = 0; p < P; ++p) a[p] = 0.0f;
#pragma unroll
        for (int t = 0; t < KQ; ++t) {
          if (t < len) {  // uniform over a warp: a warp's threads share ks
            float d[P];
            load_h<P>(dpre, i0 + t, d);
#pragma unroll
            for (int p = 0; p < P; ++p) a[p] = fmaf(d[p], wq[q][t], a[p]);
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) part[((ks * 2 + q) * u32 + j) * P + p] = a[p];
      }
    }
    __syncthreads();
    if (carry) {
      float a[2] = {0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        a[q] = part[(q * u32 + j) * P + ks];
#pragma unroll
        for (int s = 1; s < kSlices; ++s) a[q] += part[((s * 2 + q) * u32 + j) * P + ks];
      }
      dhc = k > 0 ? a[0] : 0.0f;
      if (y > 0) col[x * u + j] = a[1];
    }
    h_cur = h_nxt;
    p_cur = p_nxt;
    s_cur = s_nxt;
  }
}

template <int KQ>
cudaError_t launch_msweep_kq(const void* samples, const void* g, const void* wh, const void* wv,
                             const void* hw, const void* hist, const void* p1, void* cot,
                             int b_total, int nx, int ny, int u, cudaStream_t st) {
  const size_t smem = sizeof(float) * msweep_floats(nx, u);
  cudaError_t err = cudaFuncSetAttribute(mdrnn_bwd_sweep_kernel<KQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (b_total + kMBwdP - 1) / kMBwdP;
  mdrnn_bwd_sweep_kernel<KQ><<<blocks, kSlices * warp_round(u), smem, st>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(g),
      static_cast<const float*>(wh), static_cast<const float*>(wv),
      static_cast<const float*>(hw), static_cast<const float*>(hist),
      static_cast<const float*>(p1), static_cast<float*>(cot), b_total, nx, ny, u);
  return cudaGetLastError();
}

// Stage 2: the reverse sweep writing C.
cudaError_t launch_msweep(const void* samples, const void* g, const void* wh, const void* wv,
                          const void* hw, const void* hist, const void* p1, void* cot,
                          int b_total, int nx, int ny, int u, cudaStream_t st) {
  const int quarter = (u + kSlices - 1) / kSlices;
  if (quarter > kMMaxQuarter) return cudaErrorInvalidValue;
  return quarter <= 8    ? launch_msweep_kq<8>(samples, g, wh, wv, hw, hist, p1, cot, b_total,
                                               nx, ny, u, st)
         : quarter <= 16 ? launch_msweep_kq<16>(samples, g, wh, wv, hw, hist, p1, cot, b_total,
                                                nx, ny, u, st)
         : quarter <= 24 ? launch_msweep_kq<24>(samples, g, wh, wv, hw, hist, p1, cot, b_total,
                                                nx, ny, u, st)
                         : launch_msweep_kq<32>(samples, g, wh, wv, hw, hist, p1, cot, b_total,
                                                nx, ny, u, st);
}

// Writes G's entry (row ma of A's columns, column q of C's) to the flat
// gradient [uh (2, U) | uv (2, U) | wh (U, U) | wv (U, U) | b | hw (U, 2) |
// hb (2)]; the head weight comes from the head blocks.  Each written entry
// is written by exactly one (ma, q).
__device__ __forceinline__ void put_mgrad(float* out, int u, int ma, int q, float v) {
  const int o_wh = 4 * u, o_wv = o_wh + u * u, o_b = o_wv + u * u, o_hb = o_b + 3 * u;
  if (ma >= 2 * u + 5) return;  // padding rows of the last tile
  if (q < u) {
    if (ma < u) out[o_wh + ma * u + q] = v;
    else if (ma < 2 * u) out[o_wv + (ma - u) * u + q] = v;
    else if (ma < 2 * u + 4) out[(ma - 2 * u) * u + q] = v;  // uh rows 0, 1, then uv's
    else out[o_b + q] = v;
  } else if (q == u && ma == 2 * u + 4) {
    // dlogit_0 = -dl1: the head bias's two entries
    out[o_hb] = -v;
    out[o_hb + 1] = v;
  }
}

// Row v's neighbours (sample v / NS, visit position m = v % NS): the rows
// of h_h = h_{m-1} and h_v = h_{m-2k-1} in the history, -1 where that
// neighbour lies outside the lattice (k = 0, y = 0), and their spins.
__device__ __forceinline__ int4 row_neighbours(const int32_t* __restrict__ samples, int v,
                                               int nx, int ny) {
  const int ns = nx * ny;
  const int bsm = v / ns, m = v - bsm * ns;
  const int y = m / nx, k = m - y * nx;
  const int x = (y & 1) ? nx - 1 - k : k;
  const int32_t* s_lat = samples + static_cast<int64_t>(bsm) * ns;
  int4 r = make_int4(-1, -1, 0, 0);
  if (k > 0) {
    r.x = v - 1;
    r.z = s_lat[((y & 1) ? x + 1 : x - 1) * ny + y];
  }
  if (y > 0) {
    r.y = v - 2 * k - 1;
    r.w = s_lat[x * ny + y - 1];
  }
  return r;
}

// Column c of A at a row whose neighbours are nb, gathered from the history.
__device__ __forceinline__ float a_entry(const float* __restrict__ hist, int4 nb, int c,
                                         int u) {
  if (c < u) return nb.x >= 0 ? hist[static_cast<int64_t>(nb.x) * u + c] : 0.0f;
  if (c < 2 * u) return nb.y >= 0 ? hist[static_cast<int64_t>(nb.y) * u + c - u] : 0.0f;
  if (c < 2 * u + 2) return nb.x < 0 ? 0.0f : (c == 2 * u) == (nb.z == 0) ? 1.0f : 0.0f;
  if (c < 2 * u + 4) return nb.y < 0 ? 0.0f : (c == 2 * u + 2) == (nb.w == 0) ? 1.0f : 0.0f;
  return c == 2 * u + 4 ? 1.0f : 0.0f;
}

// The values thread column sc stages for rows v = rt + sr + 4 i of a tile:
// column ma of A and column q of C (rc columns), zero past the chunk's end
// r1 or the matrix's last column; nbr holds the chunk's row neighbours.
__device__ __forceinline__ void fetch_mrows(const float* __restrict__ hist,
                                            const float* __restrict__ c_rows, const int4* nbr,
                                            int r0, int rt, int r1, int sr, int ma, int q,
                                            int rc, int u, float (&av)[kMStage],
                                            float (&cv)[kMStage]) {
#pragma unroll
  for (int i = 0; i < kMStage; ++i) {
    const int v = rt + sr + (kMThreads / kMTile) * i;
    const bool in = v < r1;
    av[i] = in && ma < 2 * u + 5 ? a_entry(hist, nbr[v - r0], ma, u) : 0.0f;
    cv[i] = in && q < rc ? c_rows[static_cast<int64_t>(v) * rc + q] : 0.0f;
  }
}

// blockIdx.x: the chunk of rows; blockIdx.y: the tile of G (row tiles of
// the 2U + 5 A columns, then column tiles of the U + 1 C columns), and last
// the head block.
__global__ void __launch_bounds__(kMThreads)
mdrnn_bwd_weights_kernel(const int32_t* __restrict__ samples, const float* __restrict__ hist,
                         const float* __restrict__ c_rows, float* __restrict__ partial,
                         int n_rows, int nx, int ny, int u) {
  __shared__ __align__(16) float as[kMRowTile][kMTile];
  __shared__ __align__(16) float cs[kMRowTile][kMTile];
  __shared__ int4 nbr[kMChunkRows];
  const int rc = u + 1;
  const int tiles_c = (rc + kMTile - 1) / kMTile;
  const int r0 = blockIdx.x * kMChunkRows, r1 = min(n_rows, r0 + kMChunkRows);
  float* out = partial + static_cast<int64_t>(blockIdx.x) * mdrnn_weight_floats_exact(u);
  if (blockIdx.y == gridDim.y - 1) {
    // the head weight: sum over the chunk's rows of h_m[j] dl1_m, in row order
    const int o_hw = 5 * u + 2 * u * u;
    for (int jj = threadIdx.x; jj < u; jj += blockDim.x) {
      float acc = 0.0f;
#pragma unroll 8
      for (int v = r0; v < r1; ++v) {
        const int64_t row = v;
        acc = fmaf(hist[row * u + jj], c_rows[row * rc + u], acc);
      }
      out[o_hw + 2 * jj] = -acc;  // dlogit_0 = -dl1
      out[o_hw + 2 * jj + 1] = acc;
    }
    return;
  }
  // the chunk's row neighbours, once per row (not once per staged value)
  for (int i = threadIdx.x; i < r1 - r0; i += blockDim.x)
    nbr[i] = row_neighbours(samples, r0 + i, nx, ny);
  __syncthreads();
  const int m0 = (blockIdx.y / tiles_c) * kMTile, c0 = (blockIdx.y % tiles_c) * kMTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the thread's staging column and its first row in a tile
  const int sc = threadIdx.x % kMTile, sr = threadIdx.x / kMTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;

  float av[kMStage], cv[kMStage];
  fetch_mrows(hist, c_rows, nbr, r0, r0, r1, sr, m0 + sc, c0 + sc, rc, u, av, cv);
  for (int rt = r0; rt < r1; rt += kMRowTile) {
#pragma unroll
    for (int i = 0; i < kMStage; ++i) {
      as[sr + (kMThreads / kMTile) * i][sc] = av[i];
      cs[sr + (kMThreads / kMTile) * i][sc] = cv[i];
    }
    __syncthreads();
    if (rt + kMRowTile < r1)
      fetch_mrows(hist, c_rows, nbr, r0, rt + kMRowTile, r1, sr, m0 + sc, c0 + sc, rc, u, av,
                  cv);
#pragma unroll 8
    for (int rr = 0; rr < kMRowTile; ++rr) {
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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) put_mgrad(out, u, m0 + 4 * ty + i, c0 + 4 * tx + k, acc[i][k]);
}

__host__ __device__ inline int mg_chunks(int64_t n_rows) {
  return static_cast<int>((n_rows + kMChunkRows - 1) / kMChunkRows);
}

}  // namespace rnnwf

// The floats of the per-chunk partial gradients rnnwf_mdrnn_log_prob_bwd needs.
extern "C" long long rnnwf_mdrnn_bwd_partial_floats(int b_total, int n_sites, int u) {
  using namespace rnnwf;
  return static_cast<long long>(mg_chunks(static_cast<int64_t>(b_total) * n_sites)) *
         mdrnn_weight_floats_exact(u);
}

// Stages 2 and 3 after the replay.  Scratch: cot B*NS*(U+1) (C) and partial
// rnnwf_mdrnn_bwd_partial_floats(B, NS, U) floats; out:
// mdrnn_weight_floats_exact(U) floats in the layout [uh | uv | wh | wv | b |
// head w | head b].
extern "C" int rnnwf_mdrnn_log_prob_bwd(const void* samples, const void* g, const void* wh,
                                        const void* wv, const void* hw, const void* hist,
                                        const void* p1, void* cot, void* partial, void* out,
                                        int b_total, int nx, int ny, int u, void* stream) {
  using namespace rnnwf;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the weight cotangent counts its rows in int
  const int64_t n_rows = static_cast<int64_t>(b_total) * nx * ny;
  if (n_rows > INT32_MAX - kMChunkRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_msweep(samples, g, wh, wv, hw, hist, p1, cot, b_total, nx, ny, u, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = mg_chunks(n_rows);
  const int tiles = ((2 * u + 5 + kMTile - 1) / kMTile) * ((u + 1 + kMTile - 1) / kMTile);
  mdrnn_bwd_weights_kernel<<<dim3(chunks, tiles + 1), kMThreads, 0, st>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(hist),
      static_cast<const float*>(cot), static_cast<float*>(partial), static_cast<int>(n_rows), nx,
      ny, u);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_partials(static_cast<const float*>(partial),
                                              static_cast<float*>(out), chunks,
                                              mdrnn_weight_floats_exact(u), st));
}
