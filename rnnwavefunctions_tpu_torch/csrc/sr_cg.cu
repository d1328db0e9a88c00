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
// S=500) and the bytes (T once, 1 MB) would take about a microsecond.  What
// a step costs is its barriers and its round trips.
//
// Design: three paths, chosen by S at launch (cg_plan); each keeps the
// recurrences of the plain CG, with the guards max(., 1e-30) of the TPU
// kernel (at exact convergence p.Tp = r.r = 0 and the iterate freezes).
//   block    S <= 64 (the N=1000 chain's system): one block of kClThreads
//            threads holds T in registers.
//   cluster  S <= 512: a thread-block cluster of 4 blocks (S <= 256) or 8
//            (the TFIM system S=500), each holding its rows of T (at most
//            64) in registers.  Read once per step from shared memory at
//            128 bytes a cycle, a block's 128 KB of rows would take ~1000
//            cycles of every step: one block holding T in shared memory
//            took 0.31 ms at S=230 against the grid's 0.17 (PERF.md), and
//            was dropped.
//   grid     the rest (the J1-J2 system 2S=1000): a cooperative launch, one
//            block per SM, each owning a slice of rows (in shared memory
//            where it fits, else read from L2 every step), one grid-wide
//            barrier a step, T p through global memory.  At 2S=1000 a
//            cluster of 16 blocks holding what fits of their rows in shared
//            memory and reading the rest from L2 took 0.33 ms against the
//            grid's 0.24 (PERF.md), and was dropped.
// The block and cluster paths are one kernel (cg_cluster_kernel).  Every
// warp keeps the whole of p and r in registers (lane l holds entries
// l + 32 i) and does the vector work itself: p.Tp, the update of r, r.r and
// the update of p, each dot product summed in a fixed order (per lane in
// index order, then a butterfly), so every warp of every block holds the
// same bits and needs no barrier for them.  Each step a warp forms T p for
// its rows (a row's terms per lane in index order, then a butterfly).  One
// block writes them into its T p and meets its warps at __syncthreads.  In
// a cluster a block stages its entries, then copies them into every block's
// T p with one bulk copy each (cp.async.bulk over DSMEM), counted on the
// receiver's transaction barrier (mbarrier) of that step, and every block
// waits on its own barrier: no cluster-wide barrier in the loop (a first
// version that stored T p over DSMEM and met at cluster.sync() each step
// was slower than the grid at S=500).  T p, the staged entries and the
// barriers alternate by step parity, so a block that runs ahead never
// overwrites what another block still reads: to get a step ahead it needs
// that block's entries of the step before.  Entry i of x is kept in shared
// memory by the one thread whose registers hold p_i in the warp
// (i / 32) mod kClWarps, in the block that owns row i.
// The grid path keeps the design of the first port: every block reads the
// whole of T p after the grid barrier and updates its own full copies of r
// and p, the dot products summed per thread in index order, then a fixed
// shuffle tree, then the warps in order.
#include <cstdint>

#include <cooperative_groups.h>

#include "gru_common.cuh"

namespace cg = cooperative_groups;

namespace rnnwf {

constexpr int kCgThreads = 256;  // the grid path
constexpr int kCgWarps = kCgThreads / kWarp;
constexpr int kClThreads = 512;  // the block and cluster paths
constexpr int kClWarps = kClThreads / kWarp;
constexpr int kRegRows = 64;  // a block's rows of T in registers
constexpr int kRegMaxS = 8 * kRegRows;

// The paths, as rnnwf_sr_cg_solve reports them.
enum CgPath { kPathBlock = 0, kPathCluster = 1, kPathGrid = 2 };

struct CgPlan {
  int path;
  int ctas;          // blocks (the cluster's size, or the grid's)
  int rows_per_cta;  // the rows a block owns (the last may own fewer)
  bool t_shared;     // the grid path: a block's rows of T in shared memory, else read from L2
  size_t smem;
};

// Bytes of dynamic shared memory of the block (n = 1) and cluster paths,
// as cg_cluster_kernel lays it out.
size_t cl_smem_bytes(int n, int rows_per_cta) {
  return sizeof(float) * (2 * static_cast<size_t>(n) * rows_per_cta +
                          (n > 1 ? 2 * rows_per_cta : 0) + rows_per_cta);
}

// Floats of shared memory of the grid path: the block's rows of T (when
// they are held there), full p, r and T p, the block's rows of x, and the
// reduction slots.
size_t cg_smem_bytes(int s, int rows_per_block, bool t_shared) {
  const size_t t_rows = t_shared ? static_cast<size_t>(rows_per_block) * s : 0;
  return sizeof(float) * (t_rows + 3 * static_cast<size_t>(s) + rows_per_block + kCgWarps);
}

// ---- the block and cluster paths

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// The address of the same shared-memory location in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Arms the barrier's current phase: one arrival, completed when `bytes`
// have landed.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity has completed; traps (a
// launch error the wrapper raises) rather than hang if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int64_t polls = 0; !done; ++polls) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls > (int64_t{1} << 26)) __trap();
  }
}

// Copies `bytes` (a multiple of 16) of this block's shared memory into a
// block of the cluster, counted on that block's barrier.
__device__ __forceinline__ void bulk_push(uint32_t dst, uint32_t src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// The rows block `rank` owns of S, rows_per_cta a block.
__host__ __device__ inline int cta_rows(int s, int rows_per_cta, int rank) {
  const int left = s - rank * rows_per_cta;
  return left < 0 ? 0 : left < rows_per_cta ? left : rows_per_cta;
}

// sum_i a[i] b[i] over the warp's register copies (entry lane + 32 i), the
// same bits on every lane of every warp.
template <int KMAX>
__device__ __forceinline__ float warp_dot(const float (&a)[KMAX], const float (&b)[KMAX]) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) v = fmaf(a[i], b[i], v);
  return warp_sum(v);
}

// KMAX: at least S / 32 (entries past S are zero).  The block's rows of T
// (at most kRegRows) are held in registers, lane l of warp w holding
// entries l + 32 q of rows w + 16 j.  Shared memory, in this order: T p
// twice (nrank x rows_per_cta each), in a cluster the block's entries of
// T p twice (rows_per_cta each, the source of its copies), and its entries
// of x.  In a cluster rows_per_cta is a multiple of 4, so that each
// block's entries start on 16 bytes.
template <int KMAX, bool kCluster>
__global__ void __launch_bounds__(kClThreads, 1)
cg_cluster_kernel(const float* __restrict__ t, const float* __restrict__ c,
                  float* __restrict__ x_out, int s, int iters, int rows_per_cta) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar[2];  // a cluster's arrivals of T p, by step parity
  const int rank = kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int nrank = kCluster ? static_cast<int>(cg::this_cluster().num_blocks()) : 1;
  const int row0 = rank * rows_per_cta;
  const int rows = cta_rows(s, rows_per_cta, rank);
  const int tp_len = nrank * rows_per_cta;
  float* tp = smem;                                       // [2][tp_len]
  float* stage = tp + 2 * tp_len;                         // [2][rows_per_cta]
  float* xs = stage + (kCluster ? 2 * rows_per_cta : 0);  // the block's rows of x
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  const float* t_block = t + static_cast<size_t>(row0) * s;
  constexpr int kRowRegs = kRegRows / kClWarps;
  float t_reg[kRowRegs][KMAX];
#pragma unroll
  for (int j = 0; j < kRowRegs; ++j) {
    const int i = warp + j * kClWarps;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int k = lane + kWarp * q;
      t_reg[j][q] = i < rows && k < s ? __ldg(t_block + static_cast<size_t>(i) * s + k) : 0.0f;
    }
  }
  for (int i = threadIdx.x; i < rows; i += kClThreads) xs[i] = 0.0f;
  float p[KMAX], r[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    const int k = lane + kWarp * i;
    r[i] = k < s ? __ldg(c + k) : 0.0f;
    p[i] = r[i];
  }
  float rs = warp_dot(r, r);
  // the bytes of T p every block receives in a step: each block's entries,
  // padded to 16 bytes
  uint32_t tx_bytes = 0;
  if constexpr (kCluster) {
    for (int q = 0; q < nrank; ++q) tx_bytes += 4 * pad4(cta_rows(s, rows_per_cta, q));
    if (threadIdx.x == 0) {
      mbar_init(smem_addr(&bar[0]), 1);
      mbar_init(smem_addr(&bar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect(smem_addr(&bar[0]), tx_bytes);  // steps 0 and 1
      mbar_expect(smem_addr(&bar[1]), tx_bytes);
    }
    // every block has started, holds its rows and has armed its barriers
    // before any copy into it
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  for (int it = 0; it < iters; ++it) {
    const int b = it & 1;
    float* tpb = tp + b * tp_len;
    float* out = kCluster ? stage + b * rows_per_cta : tpb + row0;
    float acc[kRowRegs];
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) {
      acc[j] = 0.0f;
#pragma unroll
      for (int q = 0; q < KMAX; ++q) acc[j] = fmaf(t_reg[j][q], p[q], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < kRowRegs; ++j) acc[j] = warp_sum(acc[j]);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kRowRegs; ++j)
        if (warp + j * kClWarps < rows) out[warp + j * kClWarps] = acc[j];
    }
    if constexpr (kCluster) {
      // the block's entries to every block of the cluster, one bulk copy
      // each, counted on the receiver's barrier of this step's parity
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x < nrank && rows > 0)
        bulk_push(cluster_addr(smem_addr(tpb + row0), threadIdx.x),
                  smem_addr(stage + b * rows_per_cta), 4 * pad4(rows),
                  cluster_addr(smem_addr(&bar[b]), threadIdx.x));
      mbar_wait(smem_addr(&bar[b]), (it >> 1) & 1);
      if (threadIdx.x == 0) mbar_expect(smem_addr(&bar[b]), tx_bytes);  // step it + 2
    } else {
      __syncthreads();
    }
    float ptp = 0.0f;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int k = lane + kWarp * q;
      ptp = fmaf(p[q], k < s ? tpb[k] : 0.0f, ptp);
    }
    const float alpha = rs / fmaxf(warp_sum(ptp), 1e-30f);
    float rr = 0.0f;
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      const int k = lane + kWarp * q;
      if (q % kClWarps == warp && k >= row0 && k < row0 + rows)
        xs[k - row0] = fmaf(alpha, p[q], xs[k - row0]);
      r[q] = fmaf(-alpha, k < s ? tpb[k] : 0.0f, r[q]);
      rr = fmaf(r[q], r[q], rr);
    }
    const float rs_new = warp_sum(rr);
    const float beta = rs_new / fmaxf(rs, 1e-30f);
#pragma unroll
    for (int q = 0; q < KMAX; ++q) p[q] = fmaf(beta, p[q], r[q]);
    rs = rs_new;
  }
  // no block leaves while a copy still reads its shared memory
  if constexpr (kCluster) cg::this_cluster().sync(); else __syncthreads();
  for (int i = threadIdx.x; i < rows; i += kClThreads) x_out[row0 + i] = xs[i];
}

// ---- the grid path

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

// ---- planning and launch

// The path for S on `device`, chosen by S.
cudaError_t cg_plan(int s, int device, CgPlan& plan) {
  if (s <= kRegRows) {  // one block
    plan = CgPlan{kPathBlock, 1, s, false, cl_smem_bytes(1, s)};
    return cudaSuccess;
  }
  if (s <= kRegMaxS) {  // a cluster of 4 up to 4 x 64 rows, else of 8
    const int n = s <= 4 * kRegRows ? 4 : 8;
    const int rows = pad4((s + n - 1) / n);
    plan = CgPlan{kPathCluster, n, rows, false, cl_smem_bytes(n, rows)};
    return cudaSuccess;
  }
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                           device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one block per SM at most, and at least one row per block
  const int rows_per_block = (s + sms - 1) / sms;
  const bool t_shared = cg_smem_bytes(s, rows_per_block, true) <= static_cast<size_t>(optin);
  plan = CgPlan{kPathGrid, (s + rows_per_block - 1) / rows_per_block, rows_per_block, t_shared,
                cg_smem_bytes(s, rows_per_block, t_shared)};
  return cudaSuccess;
}

template <int KMAX, bool kCluster>
cudaError_t launch_cluster_kmax(const CgPlan& plan, const float* t, const float* c, float* x,
                                int s, int iters, cudaStream_t st) {
  const void* kernel = reinterpret_cast<const void*>(cg_cluster_kernel<KMAX, kCluster>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(plan.ctas);
  config.blockDim = dim3(kClThreads);
  config.dynamicSmemBytes = plan.smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  if (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  err = cudaLaunchKernelEx(&config, cg_cluster_kernel<KMAX, kCluster>, t, c, x, s, iters,
                           plan.rows_per_cta);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The block and cluster paths: KMAX by S (2 for one block, S <= 64; 8 for
// a cluster of 4, S <= 256; 16 for a cluster of 8).
cudaError_t launch_block_or_cluster(const CgPlan& plan, const float* t, const float* c,
                                    float* x, int s, int iters, cudaStream_t st) {
  if (plan.path == kPathBlock) return launch_cluster_kmax<2, false>(plan, t, c, x, s, iters, st);
  return s <= 8 * kWarp ? launch_cluster_kmax<8, true>(plan, t, c, x, s, iters, st)
                        : launch_cluster_kmax<16, true>(plan, t, c, x, s, iters, st);
}

cudaError_t launch_grid(const CgPlan& plan, const float* t, const float* c, float* x,
                        float* tp_buf, int s, int iters, cudaStream_t st) {
  const bool t_shared = plan.t_shared;
  const void* kernel = t_shared ? reinterpret_cast<const void*>(cg_kernel<true>)
                                : reinterpret_cast<const void*>(cg_kernel<false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCgThreads, plan.smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int rows_per_block = plan.rows_per_cta;
  void* args[] = {&t, &c, &x, &tp_buf, &s, &iters, &rows_per_block};
  return cudaLaunchCooperativeKernel(kernel, dim3(plan.ctas), dim3(kCgThreads), args, plan.smem,
                                     st);
}

}  // namespace rnnwf

// t: S*S floats, c: S floats (inputs); x: S floats (output); tp_buf: 2*S
// floats of scratch (the grid path's).  Writes the path taken to *path (0
// block, 1 cluster, 2 grid).  Returns a CUDA error code.
extern "C" int rnnwf_sr_cg_solve(const void* t, const void* c, void* x, void* tp_buf, int s,
                                 int iters, int* path, void* stream) {
  using namespace rnnwf;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CgPlan plan;
  err = cg_plan(s, device, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* t_ptr = static_cast<const float*>(t);
  const float* c_ptr = static_cast<const float*>(c);
  float* x_ptr = static_cast<float*>(x);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *path = plan.path;
  err = plan.path == kPathGrid
            ? launch_grid(plan, t_ptr, c_ptr, x_ptr, static_cast<float*>(tp_buf), s, iters, st)
            : launch_block_or_cluster(plan, t_ptr, c_ptr, x_ptr, s, iters, st);
  return static_cast<int>(err);
}
