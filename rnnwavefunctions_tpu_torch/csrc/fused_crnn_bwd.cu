// B9: the VJP of sum_b (g_re[b] Re log psi_b + g_im[b] Im log psi_b) with
// respect to every weight of the single-layer U(1) cRNN and its two heads.
//
// Replaces: rnnwavefunctions_tpu/ops/fused_crnn_bwd.py::crnn_log_amp_bwd
// (_make_bwd_kernel over fused_gru_bwd.run_history_bptt), the backward half
// of the J1-J2 loss gradient.
//
// Bound on the H100: as K2's (csrc/fused_gru_bwd.cu), latency.  A sample's
// sites form two dependent chains of N steps, the forward replay and the
// reverse sweep; the TPU kernel's body recomputes the gates from h_{n-1},
// carries dh_{n-1} and adds the 3U x U weight cotangent at every site, three
// products on the reverse chain.
//
// Design: K2's three stages, with the cRNN's two heads and U(1) mask.
//   a. The replay is B10's teacher-forced base pass storing (csrc/
//      j1j2_exchange.cu, ExStore::kReplay; rnnwf_crnn_replay): K2's A rows
//      [h_{n-1} | 1 | 1 - s_{n-1} | s_{n-1}], the gates [r | z | c | ghc],
//      (Re, Im) log psi, and per site two seeds formed on its books warp,
//      off the site chain: a_n, the cotangent of d = l0 - l1 of the
//      amplitude term 0.5 lp_{s_n} through the U(1) renormalisation (math in
//      ops/fused_crnn_bwd.py:11-25 of the JAX package), and q_n = pi / (1 +
//      |q_{s_n}|)^2 on the target's phase logit.  Both are linear in the
//      cotangents, so they are stored at g = 1.  CRNNLogAmpParts runs it as
//      its forward when a gradient follows; the backward starts at stage b.
//   b. K2's reverse sweep (Sweep::kCrnn), a block per 2 samples: thread
//      (p, j) forms dtop_j = (aw[j, 0] - aw[j, 1]) g_re a_n + pw[j, s_n]
//      g_im q_n from the stored values (site n-1's loaded while site n
//      computes), then K2's gate cotangents; W_h dgh over 4 k-slices with W_h
//      in registers, one product per site.  It writes C = [da_r | da_z |
//      dac r | dac | dd | dq0 | dq1] (4U + 3 columns), the head columns in
//      row (b, n+1) against A's h_n: dd = g_re a_n, and g_im q_n in the
//      target's phase column.
//   c. K2's weight cotangent G = A^T C on C's 4U + 3 columns, 512-row chunks
//      summed in chunk order (the same bits every run): the amplitude head
//      takes (dd, -dd), the phase head (dq0, dq1).
// No stage keeps a weight-sized buffer in shared memory, so B9 does not
// bound the cRNN family's width (rnnwf_fits_shared_memory).
#include "crnn_common.cuh"

// The floats of the per-chunk partial gradients rnnwf_crnn_log_amp_bwd needs.
extern "C" long long rnnwf_crnn_bwd_partial_floats(int b_total, int n_sites, int u) {
  return rnnwf::weight_cotangent_partial_floats(b_total, n_sites, u, 2);
}

// Stages b and c after the replay (rnnwf_crnn_replay, which filled rows
// B*(N+1)*(U+3), gates B*N*4U and seeds B*N*2).  Scratch: cot
// B*(N+1)*(4U+3) (C) and partial rnnwf_crnn_bwd_partial_floats(B, N, U)
// floats; out: crnn_weight_floats_exact(U) floats in the layout [wx | wh |
// bx | bh | ampl w | ampl b | phase w | phase b].
extern "C" int rnnwf_crnn_log_amp_bwd(const void* samples, const void* g_re, const void* g_im,
                                      const void* wh, const void* aw, const void* pw,
                                      const void* rows, const void* gates, const void* seeds,
                                      void* cot, void* partial, void* out, int b_total,
                                      int n_sites, int u, void* stream) {
  using namespace rnnwf;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SweepArgs a{};
  a.samples = static_cast<const int32_t*>(samples);
  a.wh = static_cast<const float*>(wh);
  a.hw = static_cast<const float*>(aw);
  a.pw = static_cast<const float*>(pw);
  a.g = static_cast<const float*>(g_re);
  a.g_im = static_cast<const float*>(g_im);
  a.rows = static_cast<const float*>(rows);
  a.gates = static_cast<const float*>(gates);
  a.seeds = static_cast<const float*>(seeds);
  a.out = static_cast<float*>(cot);
  a.b_total = b_total;
  a.parts = 1;
  a.n_sites = n_sites;
  a.u = u;
  cudaError_t err = launch_reverse_sweep(Sweep::kCrnn, a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_weight_cotangent(
      static_cast<const float*>(rows), static_cast<const float*>(cot),
      static_cast<float*>(partial), static_cast<float*>(out), b_total, n_sites, u, 2, st));
}
