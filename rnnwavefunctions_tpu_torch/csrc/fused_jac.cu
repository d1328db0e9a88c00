// B19 and B20: the per-sample jacobian sweeps of minSR for the cRNN's
// single GRU layer (the rows O of d log psi / d theta, one per sample, never
// reduced over the batch).  B17 (the pRNN's sweep) runs K2's stages a and
// b (csrc/tfim_flip.cu, csrc/fused_gru_bwd.cu; ops/fused_jac.py).
//
// Replaces: rnnwavefunctions_tpu/ops/fused_jac.py::rollout_hist (B19) and
// ::sweep_dgates (B20).
//
// What they compute, per sample s and site n, in sample-major layouts:
//   B19  hist[s, n, :], the post-step hidden state h_n (S, N, U);
//   B20  for each part p, from the cotangent dout[p, s, n, :] on h_n, the
//        reverse sweep's gate cotangents dg[p, s, n, :] = [da_r | da_z | da_c |
//        dgh_c] (S, N, 4U): da are the cotangents of the three input
//        pre-activations, and the recurrent ones are [da_r | da_z | dgh_c]
//        (the two share their first 2U entries, so 4U are stored, not 6U).
// ops/fused_jac.py contracts them into the per-sample weight rows.
//
// Bound on the H100: latency of the sequential site sweeps per sample, each
// site a few dependent 3U x U products; then the stores: hist and dg are
// 5U floats per (sample, site) and part, 50 MB at the flagship shape (S=500,
// N=100, U=50), 0.015 ms at the memory rate.
//
// B19's forward replay alone is bound by the latency of N dependent sites
// per sample.  It is built as K3's base pass (csrc/tfim_flip.cu): a block
// per kRollP samples whose kSlices x U32 threads split each site's 3U x U
// product by unit and by quarter of k (slice_product, gru_common.cuh), the
// first kRollP slices update one sample each, two barriers per site, and
// h_n stored coalesced along the sample's row.
//
// Design of B20: K2's reverse sweep without its batch reduction, one warp
// per trajectory, four warps per block, the weights in shared memory.  It
// reads h_{n-1} back from B19's history (from L2), recomputes the gates and
// stores each site's cotangents instead of accumulating weight cotangents,
// so no block waits on another and nothing is summed across samples.  It
// runs one trajectory per (part, sample) and reads the one history of its
// sample, where the TPU kernel copied it once per part.
#include "gru_common.cuh"

namespace rnnwf {

constexpr int kJacWarps = 4;
constexpr int kRollP = 2;  // samples per B19 block
static_assert(kRollP <= kSlices, "a B19 block's first slices update one sample each");

// Per-warp floats of B20: hp, dh, zb (U each) and dgh (3U).
__host__ __device__ inline int jac_warp_floats(int u) { return 6 * u; }

size_t jac_smem_bytes(int u) {
  return sizeof(float) * (weight_floats(u) + kJacWarps * jac_warp_floats(u));
}
// B19: the weights, h and hn (kRollP*U floats each), the slices' sums.
size_t rollout_smem_bytes(int u) {
  return sizeof(float) * (weight_floats(u) + 2 * kRollP * u + slice_part_floats(u, kRollP));
}

// Copies the trunk (wx, wh, bx, bh) into shared memory in the layout of
// weights_at (whole block); the head's slots stay unused.
__device__ __forceinline__ Weights load_trunk(float* smem, const float* wx, const float* wh,
                                              const float* bx, const float* bh, int u) {
  const int g = 3 * u;
  const int sizes[4] = {2 * g, u * g, g, g};
  const float* srcs[4] = {wx, wh, bx, bh};
  float* dst = smem;
  for (int a = 0; a < 4; ++a) {
    for (int i = threadIdx.x; i < sizes[a]; i += blockDim.x) dst[i] = srcs[a][i];
    dst += sizes[a];
  }
  __syncthreads();
  return weights_at(smem, u);
}

// Input pre-activation of gate column col for the previous spin xr (0/1);
// xs is 0 at site 0 (the zero input vector) and 1 after.
__device__ __forceinline__ float input_gate(const Weights& w, int g, int col, float xr,
                                            float xs) {
  return xs * ((1.0f - xr) * w.wx[col] + xr * w.wx[g + col]) + w.bx[col];
}

// One reverse site of one trajectory.  On entry dh holds the whole cotangent
// on h_n and hp holds h_{n-1} (both U floats, shared memory).  Recomputes the
// gates from h_{n-1}, stores [da_r | da_z | da_c | dgh_c] to out (4U floats
// of device memory) and leaves the cotangent on h_{n-1}, dh z + wh dgh, in
// dh (the math of ops/fused_jac.py::sweep_dgates_plain).
__device__ void reverse_site(const Weights& w, int u, const float* hp, float xr, float xs,
                             float* dh, float* zb, float* dgh, float* out, int lane) {
  const int g = 3 * u;
  for (int j = lane; j < u; j += kWarp) {
    float ar = 0.0f, az = 0.0f, ac = 0.0f;
    for (int k = 0; k < u; ++k) {
      const float* wk = w.wh + k * g;
      const float hk = hp[k];
      ar = fmaf(hk, wk[j], ar);
      az = fmaf(hk, wk[u + j], az);
      ac = fmaf(hk, wk[2 * u + j], ac);
    }
    const float ghc = ac + w.bh[2 * u + j];
    const float r = sigmoidf_(input_gate(w, g, j, xr, xs) + (ar + w.bh[j]));
    const float z = sigmoidf_(input_gate(w, g, u + j, xr, xs) + (az + w.bh[u + j]));
    const float c = tanhf(input_gate(w, g, 2 * u + j, xr, xs) + r * ghc);
    const float dht = dh[j];
    const float dz = dht * (hp[j] - c);
    const float dc = dht * (1.0f - z);
    const float dac = dc * (1.0f - c * c);
    const float dar = dac * ghc * r * (1.0f - r);
    const float daz = dz * z * (1.0f - z);
    const float dghc = dac * r;
    out[j] = dar;
    out[u + j] = daz;
    out[2 * u + j] = dac;
    out[3 * u + j] = dghc;
    dgh[j] = dar;
    dgh[u + j] = daz;
    dgh[2 * u + j] = dghc;
    zb[j] = z;
  }
  __syncwarp();
  for (int k = lane; k < u; k += kWarp) {
    const float* wk = w.wh + k * g;
    float d = 0.0f;
    for (int q = 0; q < g; ++q) d = fmaf(wk[q], dgh[q], d);
    dh[k] = dh[k] * zb[k] + d;
  }
  __syncwarp();
}

// Loads h_{n-1} (zeros at site 0) of a trajectory's history into hp.
__device__ __forceinline__ void load_prev(const float* h_row, float* hp, int n, int u,
                                          int lane) {
  for (int j = lane; j < u; j += kWarp) hp[j] = n > 0 ? h_row[(n - 1) * u + j] : 0.0f;
}

__global__ void rollout_hist_kernel(const int32_t* __restrict__ samples, const float* wx,
                                    const float* wh, const float* bx, const float* bh,
                                    float* __restrict__ hist, int b_total, int n_sites, int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_trunk(smem, wx, wh, bx, bh, u);
  const int u32 = warp_round(u), ks = threadIdx.x / u32, j = threadIdx.x - ks * u32;
  float* h = smem + weight_floats(u);
  float* hn = h + kRollP * u;
  float* part = hn + kRollP * u;
  for (int i = threadIdx.x; i < kRollP * u; i += blockDim.x) h[i] = 0.0f;
  // thread (p, j) of the first kRollP slices updates unit j of sample p; a
  // padding slot past the batch repeats the last sample and stores nothing
  const int b = blockIdx.x * kRollP + min(ks, kRollP - 1);
  const int64_t my_row = static_cast<int64_t>(min(b, b_total - 1)) * n_sites;
  const bool mine = ks < kRollP && j < u && b < b_total;
  __syncthreads();
  float x = 0.0f;
  for (int n = 0; n < n_sites; ++n) {
    if (j < u) slice_product<kRollP>(w, u, ks, j, h, part);
    __syncthreads();
    if (ks < kRollP && j < u) {
      const float hv = slice_update<kRollP>(w, u, j, ks, h, part, x, n > 0 ? 1.0f : 0.0f).h;
      hn[j * kRollP + ks] = hv;
      if (mine) hist[(my_row + n) * u + j] = hv;
      x = static_cast<float>(samples[my_row + n]);
    }
    __syncthreads();
    float* tmp = h; h = hn; hn = tmp;
  }
}

__global__ void sweep_dgates_kernel(const int32_t* __restrict__ samples, const float* wx,
                                    const float* wh, const float* bx, const float* bh,
                                    const float* __restrict__ hist,
                                    const float* __restrict__ dout, float* __restrict__ dg,
                                    int b_total, int parts, int n_sites, int u) {
  extern __shared__ __align__(16) float smem[];
  const Weights w = load_trunk(smem, wx, wh, bx, bh, u);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int t = blockIdx.x * kJacWarps + warp;  // trajectory = part * B + sample
  if (t >= parts * b_total) return;
  const int b = t % b_total;
  float* hp = smem + weight_floats(u) + warp * jac_warp_floats(u);
  float* dh = hp + u;
  float* zb = dh + u;
  float* dgh = zb + u;
  const int32_t* s_row = samples + static_cast<int64_t>(b) * n_sites;
  const float* h_row = hist + static_cast<int64_t>(b) * n_sites * u;
  const float* d_row = dout + static_cast<int64_t>(t) * n_sites * u;
  float* g_row = dg + static_cast<int64_t>(t) * n_sites * 4 * u;

  for (int j = lane; j < u; j += kWarp) dh[j] = 0.0f;
  for (int n = n_sites - 1; n >= 0; --n) {
    load_prev(h_row, hp, n, u, lane);
    for (int j = lane; j < u; j += kWarp) dh[j] += d_row[n * u + j];
    __syncwarp();
    const float xr = n > 0 ? static_cast<float>(s_row[n - 1]) : 0.0f;
    reverse_site(w, u, hp, xr, n > 0 ? 1.0f : 0.0f, dh, zb, dgh,
                 g_row + static_cast<int64_t>(n) * 4 * u, lane);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace rnnwf

// hist: B*N*U floats (output).
extern "C" int rnnwf_rollout_hist(const void* samples, const void* wx, const void* wh,
                                  const void* bx, const void* bh, void* hist, int b_total,
                                  int n_sites, int u, void* stream) {
  using namespace rnnwf;
  const size_t smem = rollout_smem_bytes(u);
  cudaError_t err = set_smem(rollout_hist_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (b_total + kRollP - 1) / kRollP;
  rollout_hist_kernel<<<blocks, kSlices * warp_round(u), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(bx),
      static_cast<const float*>(bh), static_cast<float*>(hist), b_total, n_sites, u);
  return static_cast<int>(cudaGetLastError());
}

// hist: B*N*U floats, dout: P*B*N*U (inputs); dg: P*B*N*4U (output).
extern "C" int rnnwf_sweep_dgates(const void* samples, const void* wx, const void* wh,
                                  const void* bx, const void* bh, const void* hist,
                                  const void* dout, void* dg, int b_total, int parts,
                                  int n_sites, int u, void* stream) {
  using namespace rnnwf;
  const size_t smem = jac_smem_bytes(u);
  cudaError_t err = set_smem(sweep_dgates_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (parts * b_total + kJacWarps - 1) / kJacWarps;
  sweep_dgates_kernel<<<blocks, kJacWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(samples), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(bx),
      static_cast<const float*>(bh), static_cast<const float*>(hist),
      static_cast<const float*>(dout), static_cast<float*>(dg), b_total, parts, n_sites, u);
  return static_cast<int>(cudaGetLastError());
}
