// B21: the minSR sample-space solve (T + lam I) x = c by a fixed number of
// conjugate-gradient steps in one launch (T symmetric positive definite,
// (S, S) for a real ansatz, (2S, 2S) for a complex one).
//
// Replaces: rnnwavefunctions_tpu/ops/sr_cg.py::sr_cg_solve (_padded_call,
// _cg_kernel).  The TPU kernel's 128-lane padding has no counterpart here.
//
// Bound on the H100: latency.  Each step is one (S, S) matrix-vector
// product, two dot products and three vector updates, and every step waits
// for the one before; the work (64 steps of 2 S^2 operations, 32 MFLOP at
// S=500) and the bytes (T once, 1 MB) would take about a microsecond.
//
// Design: a cooperative launch (cudaLaunchCooperativeKernel), one block per
// SM.  Each block owns a slice of T's rows, copies it into shared memory
// once before the first step (rows_per_block x S floats: 8 KB at S=500 and
// 32 KB at 2S=1000 on 132 SMs) and keeps it there for the whole solve; where
// the slice does not fit, the block reads its rows from L2 on every step
// instead.  Each step the block computes its slice of T p (one warp per
// row), writes it to a global buffer, and meets the others at one grid-wide
// barrier.  Then every block reads the whole of T p and updates its own full
// copies of r and p: the vector work is repeated in every block, which costs
// microseconds at these sizes and saves the two more barriers a split update
// would need.  The dot products p.Tp and r.r are summed in a fixed order
// (per thread in index order, then a fixed shuffle tree, then the warps in
// order), so every block computes the same bits, and one input always gives
// the same x.  T p alternates between two buffers, so a block that runs
// ahead never overwrites the product another block is still reading.  The
// guards max(., 1e-30) of the TPU kernel stay: at exact convergence p.Tp =
// r.r = 0 and the iterate freezes.
#include <cooperative_groups.h>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace rnnwf {

constexpr int kCgThreads = 256;
constexpr int kCgWarps = kCgThreads / kWarp;

// Floats of shared memory: the block's rows of T (when they are held there),
// full p, r and T p, the block's rows of x, and the reduction slots.
size_t cg_smem_bytes(int s, int rows_per_block, bool t_shared) {
  const size_t t_rows = t_shared ? static_cast<size_t>(rows_per_block) * s : 0;
  return sizeof(float) * (t_rows + 3 * static_cast<size_t>(s) + rows_per_block + kCgWarps);
}

// sum_i a[i] b[i] over the block, the same bits in every block.
__device__ float block_dot(const float* a, const float* b, int n, float* red) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += kCgThreads) v = fmaf(a[i], b[i], v);
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int q = 0; q < kCgWarps; ++q) total += red[q];
  __syncthreads();  // red is free again
  return total;
}

template <bool kTShared>
__global__ void cg_kernel(const float* __restrict__ t, const float* __restrict__ c,
                          float* __restrict__ x_out, float* tp_buf, int s, int iters,
                          int rows_per_block) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  float* t_rows = smem;  // rows_per_block x s when kTShared, else empty
  float* p = t_rows + (kTShared ? static_cast<size_t>(rows_per_block) * s : 0);
  float* r = p + s;
  float* tp = r + s;
  float* x = tp + s;
  float* red = x + rows_per_block;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, s - row0);

  for (int i = threadIdx.x; i < s; i += kCgThreads) {
    const float ci = c[i];
    p[i] = ci;
    r[i] = ci;
  }
  for (int i = threadIdx.x; i < rows_per_block; i += kCgThreads) x[i] = 0.0f;
  if (kTShared) {
    const float* t_block = t + static_cast<size_t>(row0) * s;
    for (size_t i = threadIdx.x; i < static_cast<size_t>(rows) * s; i += kCgThreads)
      t_rows[i] = __ldg(t_block + i);
  }
  __syncthreads();
  float rs = block_dot(r, r, s, red);

  for (int it = 0; it < iters; ++it) {
    float* tpg = tp_buf + static_cast<size_t>(it & 1) * s;
    for (int i = warp; i < rows; i += kCgWarps) {
      float acc = 0.0f;
      if (kTShared) {
        const float* t_row = t_rows + static_cast<size_t>(i) * s;
        for (int k = lane; k < s; k += kWarp) acc = fmaf(t_row[k], p[k], acc);
      } else {
        const float* t_row = t + static_cast<size_t>(row0 + i) * s;
        for (int k = lane; k < s; k += kWarp) acc = fmaf(__ldg(t_row + k), p[k], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) tpg[row0 + i] = acc;
    }
    grid.sync();
    for (int i = threadIdx.x; i < s; i += kCgThreads) tp[i] = __ldcg(tpg + i);
    __syncthreads();
    const float alpha = rs / fmaxf(block_dot(p, tp, s, red), 1e-30f);
    for (int i = threadIdx.x; i < rows; i += kCgThreads) x[i] += alpha * p[row0 + i];
    for (int i = threadIdx.x; i < s; i += kCgThreads) r[i] -= alpha * tp[i];
    __syncthreads();
    const float rs_new = block_dot(r, r, s, red);
    const float beta = rs_new / fmaxf(rs, 1e-30f);
    for (int i = threadIdx.x; i < s; i += kCgThreads) p[i] = r[i] + beta * p[i];
    rs = rs_new;
    __syncthreads();
  }
  for (int i = threadIdx.x; i < rows; i += kCgThreads) x_out[row0 + i] = x[i];
}

}  // namespace rnnwf

// t: S*S floats, c: S floats (inputs); x: S floats (output); tp_buf: 2*S
// floats of scratch.  Returns a CUDA error code.
extern "C" int rnnwf_sr_cg_solve(const void* t, const void* c, void* x, void* tp_buf, int s,
                                 int iters, void* stream) {
  using namespace rnnwf;
  int device = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per SM at most, and at least one row per block
  int rows_per_block = (s + sms - 1) / sms;
  const int blocks = (s + rows_per_block - 1) / rows_per_block;
  const bool t_shared = cg_smem_bytes(s, rows_per_block, true) <= static_cast<size_t>(optin);
  const size_t smem = cg_smem_bytes(s, rows_per_block, t_shared);
  const void* kernel = t_shared ? reinterpret_cast<const void*>(cg_kernel<true>)
                                : reinterpret_cast<const void*>(cg_kernel<false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCgThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const float* t_ptr = static_cast<const float*>(t);
  const float* c_ptr = static_cast<const float*>(c);
  float* x_ptr = static_cast<float*>(x);
  float* tp_ptr = static_cast<float*>(tp_buf);
  void* args[] = {&t_ptr, &c_ptr, &x_ptr, &tp_ptr, &s, &iters, &rows_per_block};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kCgThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
