"""PyTorch port: the CUDA kernels K1-K4, B5-B11, B12-B16 and B17-B21 against
their plain versions on the card, at small shapes with ragged batches (B9,
B10, B11, B8, B14, B19 and B20 also over their kernels' edges, B9 and B14
stage by stage against their staged plain versions), and the training steps
that launch them.  They
skip without a CUDA device (a CUDA kernel has no CPU mode).  This file
imports no JAX, so on a machine with a card and without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu_torch import (
    CRNNU1, J1J2, MDRNN2D, PRNN1D, PRNNSnake2D, TFIM1D, TFIM2D, TrainConfig, VMCTrainer, interop,
)
from rnnwavefunctions_tpu_torch.ops import fused_crnn, fused_crnn_bwd, fused_gru, fused_gru_bwd
from rnnwavefunctions_tpu_torch.ops import fused_jac, sr_cg
from rnnwavefunctions_tpu_torch.ops import fused_mdrnn, fused_mdrnn_bwd
from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk
from rnnwavefunctions_tpu_torch.ops import mdrnn_flip_kernel as mk
from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk
from rnnwavefunctions_tpu_torch.vmc import minsr

pytestmark = pytest.mark.cuda

N, B = 12, 37  # B is not a multiple of the samples a block or tile takes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _weights(u, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = PRNN1D(N, (u,), device="cpu").init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return tuple(w.detach().to(device) for w in model.weights())


def _samples(device, seed=1, n=N):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(B, n, generator=gen) < 0.5).to(torch.int32).to(device)


# the tile edges of the GRU kernels: one sample, a ragged 17 (a base or
# reverse-sweep block takes 2 samples, a suffix tile 16 trajectories, a
# suffix block 64), the flagship 500; one site (an empty suffix), two, a
# hundred; widths below, at and past one 8-unit group, the flagship's, and
# the widest the GRU family admits
FLIP_EDGES = [(b, n, u) for b in (1, 17, 500) for n in (1, 2, 100)
              for u in (7, 16, 50, "widest")]


def _flip_case(cuda, b, n, u):
    """Weights of width u ("widest": the largest U the K1-K4 family takes at
    N=n on this card) and (b, n) random chains."""
    if u == "widest":
        u = max(v for v in range(1, 257) if fused_gru.supports(n, (v,), cuda))
    gen = torch.Generator().manual_seed(b * 1000 + n)
    s = (torch.rand(b, n, generator=gen) < 0.5).to(torch.int32).to(cuda)
    return _weights(u, cuda), s


def _cotangent(b, device):
    return torch.randn(b, generator=torch.Generator().manual_seed(2)).to(device)


def _close_to_max(got, want, rel=1e-4):
    """Within ``rel`` of the largest |want| entry (f32 recurrences and sums
    taken in another order)."""
    torch.testing.assert_close(got, want, atol=rel * max(1.0, float(want.abs().max())), rtol=0)


@pytest.mark.parametrize("b,n,u", FLIP_EDGES)
def test_k1_matches_plain(cuda, b, n, u):
    w, s = _flip_case(cuda, b, n, u)
    before = fused_gru.gru_log_prob.launches
    got = fused_gru.gru_log_prob(w, s)
    torch.testing.assert_close(got, fused_gru.log_prob_plain(w, s), atol=1e-5 * n, rtol=0)
    assert fused_gru.gru_log_prob.launches == before + 1
    stored = fused_gru.gru_log_prob(w, s, store=True)
    assert torch.equal(stored.lp, got)  # the same pass, storing K2's replay


# K2 adds bench.py's 1dtfim_n1000_s64 shape
@pytest.mark.parametrize("b,n,u", FLIP_EDGES + [(64, 1000, 50)])
def test_k2_matches_plain(cuda, b, n, u):
    w, s = _flip_case(cuda, b, n, u)
    g = _cotangent(b, cuda)
    before = fused_gru_bwd.gru_log_prob_bwd.launches
    got = fused_gru_bwd.gru_log_prob_bwd(w, s, g)
    assert fused_gru_bwd.gru_log_prob_bwd.launches == before + 1
    for a, want in zip(got, fused_gru.log_prob_bwd_plain(w, s, g)):
        _close_to_max(a, want)
    again = fused_gru_bwd.gru_log_prob_bwd(w, s, g)
    assert all(torch.equal(x, y) for x, y in zip(again, got))
    # from K1's stored replay (GRULogProb's forward): the same bits
    replay = fused_gru.gru_log_prob(w, s, store=True)
    fused = fused_gru_bwd.gru_log_prob_bwd(w, s, g, replay=replay)
    assert all(torch.equal(x, y) for x, y in zip(fused, got))
    with pytest.raises(ValueError, match="replay"):
        fused_gru_bwd.gru_log_prob_bwd(w, s, g, replay=replay._replace(p1=replay.p1[:, :-1]))


@pytest.mark.parametrize("b,n,u", [(1, 1, 7), (17, 2, 16), (17, 100, 50), (500, 100, 50),
                                   (17, 100, "widest"), (64, 1000, 50)])
def test_k2_stages_match_staged_plain(cuda, b, n, u):
    """Each stage against the staged plain version on the kernel's own
    inputs: the replay (a), the reverse sweep (b) from the kernel's replay,
    the weight cotangent (c) from the kernel's replay and reverse sweep."""
    w, s = _flip_case(cuda, b, n, u)
    g = _cotangent(b, cuda)
    grads, replay, rev = fused_gru_bwd.gru_log_prob_bwd_stages(w, s, g)
    want = fused_gru.replay_plain(w, s)
    torch.testing.assert_close(replay.lp, want.lp, atol=1e-5 * n, rtol=0)
    for name in ("rows", "gates", "p1"):
        _close_to_max(getattr(replay, name), getattr(want, name), rel=1e-5)
    _close_to_max(rev.cot, fused_gru_bwd.reverse_plain(w, s, g, replay).cot, rel=1e-5)
    for a, ref in zip(grads, fused_gru_bwd.weight_cotangent_plain(replay, rev)):
        _close_to_max(a, ref, rel=1e-5)


@pytest.mark.parametrize("b,n,u", FLIP_EDGES)
def test_k4_and_k3_match_plain(cuda, b, n, u):
    w, s = _flip_case(cuda, b, n, u)
    ratio, lp = tk.tfim_flip_ratio_sum(w, s)
    ratio_p, lp_p = tk.flip_ratio_sum_plain(w, s)
    torch.testing.assert_close(ratio, ratio_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(lp, lp_p, atol=1e-5 * n, rtol=0)
    again = tk.tfim_flip_ratio_sum(w, s)
    assert torch.equal(again[0], ratio) and torch.equal(again[1], lp)
    s3, lp3, ratio3 = tk.tfim_sample_and_flip_sum(w, b, n, 3, 5)
    assert s3.shape == (b, n) and bool(((s3 == 0) | (s3 == 1)).all())
    torch.testing.assert_close(lp3, fused_gru.log_prob_plain(w, s3), atol=1e-5 * n, rtol=0)
    torch.testing.assert_close(ratio3, tk.flip_ratio_sum_plain(w, s3)[0], rtol=1e-4, atol=0)
    assert all(torch.equal(x, y) for x, y in
               zip(tk.tfim_sample_and_flip_sum(w, b, n, 3, 5), (s3, lp3, ratio3)))


# the suffix pass's groups of 64 trajectories (one full, one and one more,
# the N=1000 chain's S=64) and its two paths: the turned-around one to U=56,
# the first one past it
SUFFIX_EDGES = [(64, 100, 50), (65, 100, 50), (64, 1000, 50), (65, 100, 56), (65, 100, 57)]


@pytest.mark.parametrize("b,n,u", SUFFIX_EDGES)
def test_flip_suffix_edges_match_plain_wherever_a_sample_lands(cuda, b, n, u):
    """K4 and B6a against the plain path at the suffix pass's edges, and a
    batch with its rows permuted: each sample's ratio sum and per-flip log
    p are the same bits wherever its trajectories land."""
    w, s = _flip_case(cuda, b, n, u)
    ratio, lp = tk.tfim_flip_ratio_sum(w, s)
    lpf, lp6 = tk.tfim_flip_log_probs(w, s)
    ratio_p, lp_p = tk.flip_ratio_sum_plain(w, s)
    torch.testing.assert_close(ratio, ratio_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(lp, lp_p, atol=1e-5 * n, rtol=0)
    torch.testing.assert_close(lpf, tk.per_flip_log_probs_plain(w, s)[0], atol=1e-5 * n, rtol=0)
    assert torch.equal(lp6, lp)
    perm = torch.randperm(b, generator=torch.Generator().manual_seed(b + u)).to(cuda)
    assert torch.equal(tk.tfim_flip_ratio_sum(w, s[perm].contiguous())[0], ratio[perm])
    assert torch.equal(tk.tfim_flip_log_probs(w, s[perm].contiguous())[0], lpf[perm])


def test_gru_family_covers_every_width_to_120(cuda):
    """Every U to 120 runs K1-K4 at N=100 and N=1000: the turned-around
    suffix pass to U=56 and the first suffix pass past it, whose shared
    memory sets the family's widest, as before the turned-around pass."""
    for n in (100, 1000):
        assert all(fused_gru.supports(n, (u,), cuda) for u in range(1, 121))


def test_wrappers_reject_cpu_cuda_mix(cuda):
    w = _weights(16, cuda)
    with pytest.raises(ValueError, match="devices"):
        fused_gru.gru_log_prob(w, _samples("cpu"))


def test_training_step_runs_every_kernel(cuda):
    trainer = VMCTrainer(PRNN1D(N, (16,), device=cuda), TFIM1D(N, 1.0),
                         TrainConfig(num_samples=B))
    state = trainer.init()
    counts = [fn.launches for fn in (fused_gru.gru_log_prob, fused_gru_bwd.gru_log_prob_bwd,
                                     tk.tfim_sample_and_flip_sum)]
    state, ms = trainer.run_steps(state, 2)
    after = [fn.launches for fn in (fused_gru.gru_log_prob, fused_gru_bwd.gru_log_prob_bwd,
                                    tk.tfim_sample_and_flip_sum)]
    assert [a - c for a, c in zip(after, counts)] == [2, 2, 2]
    assert bool(torch.isfinite(ms["mean_energy"]).all())


def test_shared_memory_bounds_coverage(cuda):
    assert fused_gru.supports(100, (50,), cuda)
    assert not fused_gru.supports(100, (256,), cuda)
    # the MDRNN family: bench.py's 16x16 and 32x32 rows at U=50, 1-wide
    # lattices; no width whose two U x U matrices leave no room
    for nx, ny in ((16, 16), (32, 32), (1, 64), (64, 1)):
        assert fused_mdrnn.supports(nx, ny, 50, cuda)
    assert not fused_mdrnn.supports(16, 16, 256, cuda)
    with pytest.raises(ValueError, match="do not take"):
        fused_gru.gru_log_prob(_weights(256, cuda), _samples(cuda))


def test_auto_raises_outside_coverage_on_the_card(cuda):
    wide = PRNN1D(N, (256,), device=cuda)
    with pytest.raises(ValueError, match="impl='plain'"):
        wide.log_prob(_samples(cuda))
    with pytest.raises(ValueError, match="impl='plain'"):
        VMCTrainer(PRNN1D(N, (16, 16), device=cuda), TFIM1D(N, 1.0))
    plain = PRNN1D(N, (16, 16), impl="plain", device=cuda)
    assert plain.log_prob(_samples(cuda)).shape == (B,)


def test_sampler_runs_k3_on_the_card(cuda):
    """The sampler runs B5 (the stand-alone sampler), no longer K3."""
    model = PRNN1D(N, (16,), device=cuda)
    model.init(torch.Generator().manual_seed(0))
    before = (fused_gru.gru_sample.launches, tk.tfim_sample_and_flip_sum.launches)
    s, lp = model.sample_with_log_prob(B, torch.Generator().manual_seed(4))
    assert (fused_gru.gru_sample.launches, tk.tfim_sample_and_flip_sum.launches) == (
        before[0] + 1, before[1])
    with torch.no_grad():
        want = fused_gru.log_prob_plain(model.weights(), s)
    torch.testing.assert_close(lp, want, atol=1e-5 * N, rtol=0)


@pytest.mark.parametrize("u", [16, 50])
def test_b5_matches_plain_and_k3(cuda, u):
    """B5 draws K3's spins and log p bit for bit for one key; its log p is
    the teacher-forced one; at N=3 its frequencies follow the density."""
    w = _weights(u, cuda)
    before = fused_gru.gru_sample.launches
    s5, lp5 = fused_gru.gru_sample(w, B, N, 3, 5)
    assert fused_gru.gru_sample.launches == before + 1
    s3, lp3, _ = tk.tfim_sample_and_flip_sum(w, B, N, 3, 5)
    assert torch.equal(s5, s3)
    torch.testing.assert_close(lp5, lp3, atol=0, rtol=0)
    torch.testing.assert_close(lp5, fused_gru.log_prob_plain(w, s5), atol=1e-5 * N, rtol=0)
    assert not torch.equal(fused_gru.gru_sample(w, B, N, 3, 6)[0], s5)
    draws = 20000
    s, _ = fused_gru.gru_sample(w, draws, 3, 11, 0)
    codes = s.cpu().numpy() @ (2 ** np.arange(3))
    freq = np.bincount(codes, minlength=8) / draws
    basis = torch.tensor([[(c >> i) & 1 for i in range(3)] for c in range(8)],
                         dtype=torch.int32, device=cuda)
    probs = torch.exp(fused_gru.log_prob_plain(w, basis)).cpu().numpy()
    assert float(np.abs(freq - probs).max()) <= 0.01


@pytest.mark.parametrize("b,n,u", FLIP_EDGES)
def test_b6_matches_plain_in_both_modes(cuda, b, n, u):
    """B6 teacher-forced against its plain version; in sample mode K3's
    draws, with the teacher-forced lpf bit for bit on them; the flip-order
    sum of its terms is K4's ratio; each the same bits twice."""
    w, s = _flip_case(cuda, b, n, u)
    counts = (tk.tfim_flip_log_probs.launches, tk.tfim_sample_and_flip_log_probs.launches)
    lpf, lp = tk.tfim_flip_log_probs(w, s)
    lpf_p, lp_p = tk.per_flip_log_probs_plain(w, s)
    torch.testing.assert_close(lpf, lpf_p, atol=1e-5 * n, rtol=0)
    torch.testing.assert_close(lp, lp_p, atol=1e-5 * n, rtol=0)
    ratio, lp4 = tk.tfim_flip_ratio_sum(w, s)
    torch.testing.assert_close(tk.ratio_sum(lpf, lp), ratio, rtol=1e-5, atol=0)
    torch.testing.assert_close(lp, lp4, atol=0, rtol=0)
    s6, lp6, lpf6 = tk.tfim_sample_and_flip_sum(w, b, n, 3, 5, per_flip=True)
    assert torch.equal(s6, tk.tfim_sample_and_flip_sum(w, b, n, 3, 5)[0])
    lpf_t, lp_t = tk.tfim_flip_log_probs(w, s6)
    torch.testing.assert_close(lpf6, lpf_t, atol=0, rtol=0)
    torch.testing.assert_close(lp6, lp_t, atol=0, rtol=0)
    again = tk.tfim_sample_and_flip_sum(w, b, n, 3, 5, per_flip=True)
    assert all(torch.equal(x, y) for x, y in zip(again, (s6, lp6, lpf6)))
    assert (tk.tfim_flip_log_probs.launches, tk.tfim_sample_and_flip_log_probs.launches) == (
        counts[0] + 2, counts[1] + 2)


def test_parity_training_step_launches_its_kernels(cuda):
    trainer = VMCTrainer(PRNN1D(N, (16,), parity=True, device=cuda), TFIM1D(N, 1.0),
                         TrainConfig(num_samples=B))
    state = trainer.init()
    fns = (tk.tfim_sample_and_flip_log_probs, tk.tfim_flip_log_probs, fused_gru.gru_log_prob,
           fused_gru_bwd.gru_log_prob_bwd, tk.tfim_sample_and_flip_sum, fused_gru.gru_sample)
    counts = [fn.launches for fn in fns]
    state, ms = trainer.run_steps(state, 2)
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 2, 4, 4, 0, 0]
    assert bool(torch.isfinite(ms["mean_energy"]).all())
    trainer.local_energy(trainer.ansatz.sample(B, torch.Generator().manual_seed(0)))
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 4, 4, 4, 0, 1]


def test_snake_training_step_runs_k1_to_k4(cuda):
    trainer = VMCTrainer(PRNNSnake2D(3, 4, (16,), device=cuda), TFIM2D(3, 4, 3.0),
                         TrainConfig(num_samples=B))
    state = trainer.init()
    fns = (tk.tfim_sample_and_flip_sum, fused_gru.gru_log_prob, fused_gru_bwd.gru_log_prob_bwd,
           tk.tfim_flip_ratio_sum, fused_gru.gru_sample)
    counts = [fn.launches for fn in fns]
    state, ms = trainer.run_steps(state, 2)
    trainer.local_energy(trainer.ansatz.sample(B, torch.Generator().manual_seed(0)))
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 2, 2, 1, 1]
    assert bool(torch.isfinite(ms["mean_energy"]).all())
    with pytest.raises(ValueError, match="impl='plain'"):
        VMCTrainer(PRNNSnake2D(3, 4, (16, 16), device=cuda), TFIM2D(3, 4, 3.0))


# ---- the complex U(1) cRNN kernels (B7, B9, B10, B11)


def _crnn_weights(u, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = CRNNU1(N, (u,), device="cpu").init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return tuple(w.detach().to(device) for w in model.weights())


def _sector(device, seed=1, n=N):
    """Zero-magnetisation samples: random permutations of n//2 ones."""
    gen = torch.Generator().manual_seed(seed)
    keys = torch.rand(B, n, generator=gen)
    return (keys.argsort(dim=1) < n // 2).to(torch.int32).to(device)


def _crnn_widest(device):
    return max(v for v in range(1, 257) if fused_crnn.supports(N, (v,), device))


@pytest.mark.parametrize("u", [50, "widest"])
@pytest.mark.parametrize("u1", [True, False])
@pytest.mark.parametrize("n", [N, N - 1], ids=["even", "odd"])
def test_b7_matches_plain(cuda, u1, n, u):
    w = _crnn_weights(_crnn_widest(cuda) if u == "widest" else u, cuda)
    # in and out of the sector; at odd n the mask forbids every class of a
    # late site, whose targets take the finite LOG_ZERO - log norm2
    for s in (_sector(cuda, n=n), _samples(cuda, n=n)):
        before = fused_crnn.crnn_log_amp_parts.launches
        re, im = fused_crnn.crnn_log_amp_parts(w, s, u1)
        want_re, want_im = fused_crnn.log_amp_parts_plain(w, s, u1)
        torch.testing.assert_close(re, want_re, atol=1e-5 * n, rtol=1e-6)
        torch.testing.assert_close(im, want_im, atol=1e-5 * n, rtol=0)
        assert fused_crnn.crnn_log_amp_parts.launches == before + 1


@pytest.mark.parametrize("u", [50, "widest"])
@pytest.mark.parametrize("u1", [True, False])
def test_b7_equals_b11_log_psi_bit_for_bit(cuda, u1, u):
    """B7 and B11 run one base pass, teacher-forced or drawing: B7's (Re, Im)
    on B11's samples are B11's log psi bit for bit."""
    w = _crnn_weights(_crnn_widest(cuda) if u == "widest" else u, cuda)
    info = J1J2(N, j2=0.2).exchange_kernel_info
    s11, _, _, re11, im11 = jk.j1j2_sample_and_exchange(w, B, N, 3, 5, u1=u1, **info)
    re, im = fused_crnn.crnn_log_amp_parts(w, s11, u1)
    assert torch.equal(re, re11) and torch.equal(im, im11)


# B9 over its kernels' edges: (u1, N, U, B) with the mask on and off, N even
# and odd (where the sector holds a forbidden class, so the mask is off),
# U below, at and past one warp and the width that bounded the cRNN family
# before B9's three stages, B odd (a reverse-sweep block takes 2 samples) and
# the flagship's 500
B9_EDGES = [(True, N, 16, B), (False, N, 16, B), (True, N, 50, B), (False, N - 1, 50, B),
            (True, N, 91, B), (False, N - 1, 91, 1), (True, N, 50, 500), (True, 2, 7, 3)]


def _b9_case(cuda, u1, n, u, b):
    w = _crnn_weights(u, cuda)
    gen = torch.Generator().manual_seed(b * 100 + n)
    if u1:
        s = (torch.rand(b, n, generator=gen).argsort(dim=1) < n // 2).to(torch.int32).to(cuda)
    else:
        s = (torch.rand(b, n, generator=gen) < 0.5).to(torch.int32).to(cuda)
    g_re, g_im = torch.randn(2, b, generator=gen).to(cuda)
    return w, s, g_re, g_im


@pytest.mark.parametrize("u1,n,u,b", B9_EDGES)
def test_b9_matches_plain(cuda, u1, n, u, b):
    """B9 alone and from the replay (CRNNLogAmpParts' forward) against the
    autograd plain version; the same bits twice and from the replay."""
    w, s, g_re, g_im = _b9_case(cuda, u1, n, u, b)
    before = (fused_crnn_bwd.crnn_log_amp_bwd.launches, fused_crnn.crnn_replay.launches)
    got = fused_crnn_bwd.crnn_log_amp_bwd(w, s, g_re, g_im, u1)
    for a, ref in zip(got, fused_crnn_bwd.log_amp_bwd_plain(w, s, g_re, g_im, u1)):
        _close_to_max(a, ref)
    again = fused_crnn_bwd.crnn_log_amp_bwd(w, s, g_re, g_im, u1)
    assert all(torch.equal(x, y) for x, y in zip(again, got))
    replay = fused_crnn.crnn_replay(w, s, u1)
    fused = fused_crnn_bwd.crnn_log_amp_bwd(w, s, g_re, g_im, u1, replay=replay)
    assert all(torch.equal(x, y) for x, y in zip(fused, got))
    assert (fused_crnn_bwd.crnn_log_amp_bwd.launches, fused_crnn.crnn_replay.launches) == (
        before[0] + 3, before[1] + 1)
    # the replay's (Re, Im) are B7's function
    want_re, want_im = fused_crnn.log_amp_parts_plain(w, s, u1)
    torch.testing.assert_close(replay.re, want_re, atol=1e-5 * n, rtol=1e-6)
    torch.testing.assert_close(replay.im, want_im, atol=1e-5 * n, rtol=0)
    with pytest.raises(ValueError, match="replay"):
        fused_crnn_bwd.crnn_log_amp_bwd(w, s, g_re, g_im, u1,
                                        replay=replay._replace(seeds=replay.seeds[:, :-1]))


@pytest.mark.parametrize("u1,n,u,b", [(True, N, 16, B), (False, N - 1, 50, B),
                                      (True, N, 91, B), (True, 100, 50, 500)])
def test_b9_stages_match_staged_plain(cuda, u1, n, u, b):
    """Each stage against the staged plain version on the kernel's own
    inputs: the replay (a), the reverse sweep (b) from the kernel's replay,
    the weight cotangent (c) from the kernel's replay and reverse sweep."""
    w, s, g_re, g_im = _b9_case(cuda, u1, n, u, b)
    grads, replay, rev = fused_crnn_bwd.crnn_log_amp_bwd_stages(w, s, g_re, g_im, u1)
    want = fused_crnn.replay_plain(w, s, u1)
    torch.testing.assert_close(replay.re, want.re, atol=1e-5 * n, rtol=1e-6)
    torch.testing.assert_close(replay.im, want.im, atol=1e-5 * n, rtol=0)
    for name in ("rows", "gates", "seeds"):
        _close_to_max(getattr(replay, name), getattr(want, name), rel=1e-5)
    _close_to_max(rev.cot, fused_crnn_bwd.reverse_plain(w, s, g_re, g_im, replay).cot, rel=1e-5)
    for a, ref in zip(grads, fused_crnn_bwd.weight_cotangent_plain(replay, rev)):
        _close_to_max(a, ref, rel=1e-5)


@pytest.mark.parametrize("periodic,j2", [(False, 0.2), (True, 0.2), (False, 0.0), (True, 0.0)])
def test_b10_and_b11_match_plain(cuda, periodic, j2):
    w, s = _crnn_weights(50, cuda), _sector(cuda)
    info = J1J2(N, j2=j2, periodic=periodic, marshall_sign=periodic).exchange_kernel_info
    got = jk.j1j2_exchange_offdiag(w, s, u1=True, **info)
    want = jk.exchange_offdiag_plain(w, s, u1=True, **info)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, float(b.abs().max())), rtol=0)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, atol=1e-5 * N, rtol=0)
    s11, *rest = jk.j1j2_sample_and_exchange(w, B, N, 3, 5, u1=True, **info)
    assert s11.shape == (B, N) and bool((s11.sum(dim=1) == N // 2).all())
    want = jk.j1j2_exchange_offdiag(w, s11, u1=True, **info)
    for a, b in zip(rest, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    again, *_ = jk.j1j2_sample_and_exchange(w, B, N, 3, 5, u1=True, **info)
    assert torch.equal(again, s11)


def test_j1j2_training_step_runs_every_kernel(cuda):
    """The step runs B11, B9's replay as the forward and B9 from it; B7 runs
    only where no gradient follows."""
    trainer = VMCTrainer(CRNNU1(N, (16,), device=cuda), J1J2(N, j2=0.2),
                         TrainConfig(num_samples=B))
    state = trainer.init()
    fns = (jk.j1j2_sample_and_exchange, fused_crnn.crnn_replay, fused_crnn_bwd.crnn_log_amp_bwd,
           fused_crnn.crnn_log_amp_parts, jk.j1j2_exchange_offdiag, fused_crnn.crnn_sample)
    counts = [fn.launches for fn in fns]
    state, ms = trainer.run_steps(state, 2)
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 2, 2, 0, 0, 0]
    # CRNNU1.sample runs B8, the stand-alone sampler, and no longer B11
    s = trainer.ansatz.sample(B, torch.Generator().manual_seed(0))
    trainer.local_energy(s)
    with torch.no_grad():
        trainer.ansatz.log_amp_parts(s)
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 2, 2, 1, 1, 1]
    assert bool(torch.isfinite(ms["mean_energy"]).all())
    assert ms["mean_energy_im"].shape == (2,)


@pytest.mark.parametrize("u1", [True, False])
def test_b8_matches_b11_and_plain(cuda, u1):
    """B8 draws B11's spins for one key (in the sector under u1) and returns
    2 Re log psi, B11's bit for bit and B7's to the tolerance; at N=4 with
    u1 its frequencies follow |psi|^2."""
    w = _crnn_weights(50, cuda)
    info = J1J2(N, j2=0.2).exchange_kernel_info
    before = fused_crnn.crnn_sample.launches
    s8, lp8 = fused_crnn.crnn_sample(w, B, N, 3, 5, u1)
    assert fused_crnn.crnn_sample.launches == before + 1
    s11, _, _, lp_re, _ = jk.j1j2_sample_and_exchange(w, B, N, 3, 5, u1=u1, **info)
    assert torch.equal(s8, s11)
    torch.testing.assert_close(lp8, 2.0 * lp_re, atol=0, rtol=0)
    re, _ = fused_crnn.log_amp_parts_plain(w, s8, u1)
    torch.testing.assert_close(lp8, 2.0 * re, atol=2e-5 * N, rtol=0)
    if u1:
        assert bool((s8.sum(dim=1) == N // 2).all())
        draws, n4 = 20000, 4
        s, _ = fused_crnn.crnn_sample(w, draws, n4, 11, 0, True)
        freq = np.bincount(s.cpu().numpy() @ (2 ** np.arange(n4)), minlength=16) / draws
        basis = torch.tensor([[(c >> i) & 1 for i in range(n4)] for c in range(16)],
                             dtype=torch.int32, device=cuda)
        probs = torch.exp(2.0 * fused_crnn.log_amp_parts_plain(w, basis, True)[0]).cpu().numpy()
        assert float(np.abs(freq - probs).max()) <= 0.01


# B10, B11 and B8 over their kernels' edges: (N, periodic, J2, u1, U) with N
# even and odd, with and without the wrap bonds (which start at sites 0 and
# 1, in those start sites' lists), J2 = 0 (NN lists alone) and J2 != 0 (NN
# and NNN trajectories in one tile), the mask on and off, U below, at and
# past one 64-row gate tile, and the cRNN family's widest, 91; a short
# chain whose wraps repeat its bonds.  Random samples where the mask is off;
# at odd N it is off (the sector there holds a forbidden class).
EXCHANGE_EDGES = [
    (N, False, 0.2, True, 50), (N, True, 0.2, True, 50), (N, False, 0.0, True, 50),
    (N, True, 0.0, True, 50), (N, False, 0.2, False, 50), (N - 1, True, 0.2, False, 50),
    (N - 1, False, 0.0, False, 16), (N, True, 0.2, True, 7), (N, True, 0.2, True, 64),
    (N, True, 0.2, True, 91), (N, False, 0.2, True, 91), (4, True, 0.2, True, 16),
    (N, True, 0.2, True, 56), (N, True, 0.2, True, 57),
]


@pytest.mark.parametrize("n,periodic,j2,u1,u", EXCHANGE_EDGES)
def test_exchange_kernels_over_edges(cuda, n, periodic, j2, u1, u):
    w = _crnn_weights(u, cuda)
    s = _sector(cuda, n=n) if u1 else _samples(cuda, n=n)
    info = J1J2(n, j2=j2, periodic=periodic, marshall_sign=periodic).exchange_kernel_info
    before = jk.j1j2_exchange_offdiag.launches
    got = jk.j1j2_exchange_offdiag(w, s, u1=u1, **info)
    assert jk.j1j2_exchange_offdiag.launches == before + 1
    want = jk.exchange_offdiag_plain(w, s, u1=u1, **info)
    for a, b in zip(got[:2], want[:2]):
        _close_to_max(a, b)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, atol=1e-5 * n, rtol=0)
    again = jk.j1j2_exchange_offdiag(w, s, u1=u1, **info)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    s11, *rest = jk.j1j2_sample_and_exchange(w, B, n, 3, 5, u1=u1, **info)
    if u1:
        assert bool((s11.sum(dim=1) == n // 2).all())
    for a, b in zip(rest, jk.j1j2_exchange_offdiag(w, s11, u1=u1, **info)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    for a, b in zip(rest[:2], jk.exchange_offdiag_plain(w, s11, u1=u1, **info)[:2]):
        _close_to_max(a, b)
    s8, lp8 = fused_crnn.crnn_sample(w, B, n, 3, 5, u1)
    assert torch.equal(s8, s11)
    torch.testing.assert_close(lp8, 2.0 * rest[2], atol=0, rtol=0)


@pytest.mark.parametrize("n,u", [(N, 50), (100, 50), (N, 64), (100, 64)])
def test_b10_on_b11_samples_gives_b11_numbers(cuda, n, u):
    """B10 and B11 run one suffix pass on the same lists: B10 on B11's
    samples gives B11's sums and log psi bit for bit, on either suffix
    pass (U = 50 the turned-around one, whose tiles span start sites, U =
    64 the first design)."""
    w = _crnn_weights(u, cuda)
    info = J1J2(n, j2=0.2, marshall_sign=True).exchange_kernel_info
    s11, *rest = jk.j1j2_sample_and_exchange(w, B, n, 3, 5, u1=True, **info)
    got = jk.j1j2_exchange_offdiag(w, s11, u1=True, **info)
    assert all(torch.equal(a, b) for a, b in zip(got, rest))


@pytest.mark.parametrize("u,kernel", [(50, "exchange_suffix_rs_kernel"),
                                      (56, "exchange_suffix_rs_kernel"),
                                      (57, "exchange_suffix_kernel")])
def test_exchange_suffix_pass_is_chosen_by_u(cuda, u, kernel):
    """Launch 3 of B10 runs the turned-around suffix pass to pad8(U) = 56
    and the first design past it (the profiler's kernel names)."""
    from torch.profiler import ProfilerActivity, profile

    w, s = _crnn_weights(u, cuda), _sector(cuda)
    info = J1J2(N, j2=0.2).exchange_kernel_info
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        jk.j1j2_exchange_offdiag(w, s, u1=True, **info)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "exchange_suffix" in e.key}
    assert len(names) == 1 and kernel + "<" in next(iter(names)), names


def test_turned_around_suffix_pass_takes_any_chain_length(cuda):
    """The turned-around suffix pass reads the lists' packed offsets from the
    list launch's scratch, so its shared memory does not grow with N: at
    N = 40,000, where N + 1 offsets beside U = 50's tables would pass the
    H100's 227 KiB a block, the family takes the shape, B11 runs, B10 on its
    samples gives its numbers bit for bit, and every sum is finite."""
    n, b = 40_000, 2
    assert fused_crnn.supports(n, (50,), cuda)
    w = _crnn_weights(50, cuda)
    info = J1J2(n, j2=0.2, marshall_sign=True).exchange_kernel_info
    s11, *rest = jk.j1j2_sample_and_exchange(w, b, n, 3, 5, u1=True, **info)
    got = jk.j1j2_exchange_offdiag(w, s11, u1=True, **info)
    assert bool((s11.sum(dim=1) == n // 2).all())
    assert all(torch.equal(a, c) for a, c in zip(got, rest))
    assert all(bool(torch.isfinite(a).all()) for a in rest)


def test_crnn_coverage_on_the_card(cuda):
    """The family covers the U <= 91 it took before B9's three stages; past
    its widest, the suffix pass of B10 and B11 is the kernel that does not
    fit (B9 keeps no weight in shared memory)."""
    assert fused_crnn.supports(100, (50,), cuda)
    assert not fused_crnn.supports(100, (256,), cuda)
    widest = max(v for v in range(1, 257) if fused_crnn.supports(100, (v,), cuda))
    assert widest >= 91
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    over = {k for k, v in fused_crnn.shared_memory_bytes(widest + 1).items() if v > limit}
    assert over == {"the suffix pass of B10 and B11"}
    with pytest.raises(ValueError, match="impl='plain'"):
        CRNNU1(N, (16, 16), device=cuda).log_amp_parts(_sector(cuda))
    assert CRNNU1(N, (16, 16), impl="plain", device=cuda).log_prob(_sector(cuda)).shape == (B,)


def test_crnn_kernels_at_the_widest(cuda):
    """Every cRNN kernel at the family's widest U on this card (its suffix
    pass takes two 64-row tiles per gate): B7, B9 alone and from its
    replay, B10, B11 and B8, B19 storing and B20 against their plain
    versions."""
    u = _crnn_widest(cuda)
    w, s = _crnn_weights(u, cuda), _sector(cuda)
    re, im = fused_crnn.crnn_log_amp_parts(w, s, True)
    want_re, want_im = fused_crnn.log_amp_parts_plain(w, s, True)
    torch.testing.assert_close(re, want_re, atol=1e-5 * N, rtol=1e-6)
    torch.testing.assert_close(im, want_im, atol=1e-5 * N, rtol=0)
    g_re, g_im = torch.randn(2, B, generator=torch.Generator().manual_seed(2)).to(cuda)
    got = fused_crnn_bwd.crnn_log_amp_bwd(w, s, g_re, g_im, True)
    fused = fused_crnn_bwd.crnn_log_amp_bwd(w, s, g_re, g_im, True,
                                            replay=fused_crnn.crnn_replay(w, s, True))
    for a, b, ref in zip(got, fused, fused_crnn_bwd.log_amp_bwd_plain(w, s, g_re, g_im, True)):
        _close_to_max(a, ref)
        assert torch.equal(a, b)
    info = J1J2(N, j2=0.2, periodic=True, marshall_sign=True).exchange_kernel_info
    k10 = jk.j1j2_exchange_offdiag(w, s, u1=True, **info)
    p10 = jk.exchange_offdiag_plain(w, s, u1=True, **info)
    for a, b in zip(k10[:2], p10[:2]):
        _close_to_max(a, b)
    s11, *rest = jk.j1j2_sample_and_exchange(w, B, N, 3, 5, u1=True, **info)
    assert bool((s11.sum(dim=1) == N // 2).all())
    for a, b in zip(rest[:2], jk.exchange_offdiag_plain(w, s11, u1=True, **info)[:2]):
        _close_to_max(a, b)
    assert torch.equal(fused_crnn.crnn_sample(w, B, N, 3, 5, True)[0], s11)
    trunk = w[:4]
    hist, gates = fused_jac.rollout_hist(trunk, s, store=True)
    want_hist, want_gates = fused_jac.rollout_hist_plain(trunk, s, store=True)
    _close_to_max(hist, want_hist)
    _close_to_max(gates, want_gates)
    douts = torch.randn(2, B, N, u, generator=torch.Generator().manual_seed(4)).to(cuda)
    _close_to_max(fused_jac.sweep_dgates(trunk, s, hist, douts, gates=gates),
                  fused_jac.sweep_dgates_plain(trunk, s, hist, douts))


def test_cli_run_resumes_on_the_card(cuda, tmp_path):
    """The 1D-TFIM CLI on the card: 30 steps, resumed to 60, give the series
    of one 60-step run, every update on K1, K2 and K3."""
    from rnnwavefunctions_tpu_torch.cli import run_1dtfim

    argv = ["--systemsize", str(N), "--num-units", "16", "--numsamples", str(B),
            "--device", str(cuda)]
    fns = (fused_gru.gru_log_prob, fused_gru_bwd.gru_log_prob_bwd, tk.tfim_sample_and_flip_sum)
    counts = [fn.launches for fn in fns]
    whole = run_1dtfim.main(argv + ["--numsteps", "60", "--workdir", str(tmp_path / "a")])
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [61, 61, 61]
    run_1dtfim.main(argv + ["--numsteps", "30", "--workdir", str(tmp_path / "b")])
    split = run_1dtfim.main(argv + ["--numsteps", "60", "--resume",
                                    "--workdir", str(tmp_path / "b")])
    assert len(whole[0]) == 61 and np.isfinite(whole[0]).all()
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- the 2D MDRNN kernels (B12-B16)


def _mdrnn_weights(nx, ny, u, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = MDRNN2D(nx, ny, u, device="cpu").init(gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return tuple(w.detach().to(device) for w in model.weights())


def _lattices(nx, ny, device, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(B, nx, ny, generator=gen) < 0.5).to(torch.int32).to(device)


MDRNN_SHAPES = [(5, 3), (3, 6), (4, 4), (1, 6), (6, 1)]


@pytest.mark.parametrize("nx,ny", MDRNN_SHAPES)
def test_b12_b14_match_plain(cuda, nx, ny):
    w, s = _mdrnn_weights(nx, ny, 50, cuda), _lattices(nx, ny, cuda)
    tol = 1e-5 * nx * ny
    before = fused_mdrnn.mdrnn_log_prob.launches
    lp = fused_mdrnn.mdrnn_log_prob(w, s)
    torch.testing.assert_close(lp, fused_mdrnn.log_prob_plain(w, s), atol=tol, rtol=0)
    assert fused_mdrnn.mdrnn_log_prob.launches == before + 1
    # B12 storing B14's replay against the plain replay; both the same bits twice
    replay, want = fused_mdrnn.mdrnn_log_prob(w, s, store=True), fused_mdrnn.replay_plain(w, s)
    torch.testing.assert_close(replay.lp, want.lp, atol=tol, rtol=0)
    _close_to_max(replay.hist, want.hist)
    torch.testing.assert_close(replay.p1, want.p1, atol=1e-5, rtol=0)
    again = fused_mdrnn.mdrnn_log_prob(w, s, store=True)
    assert torch.equal(fused_mdrnn.mdrnn_log_prob(w, s), lp) and torch.equal(replay.lp, lp)
    assert all(torch.equal(a, b) for a, b in zip(again, replay))
    g = torch.randn(B, generator=torch.Generator().manual_seed(2)).to(cuda)
    want_g = fused_mdrnn.log_prob_bwd_plain(w, s, g)
    for got in (fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, g),
                fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, g, replay=replay)):
        for a, b in zip(got, want_g):
            torch.testing.assert_close(a, b, atol=1e-4 * max(1.0, float(b.abs().max())), rtol=0)


# B14's edges: one site, one-wide lattices, both row parities' ends, a
# narrow U, the flagship's, and the widest U the MDRNN family takes at 4x4
MDRNN_BWD_EDGES = [(nx, ny, 50) for nx, ny in MDRNN_SHAPES + [(1, 1)]] + [
    (4, 4, 8), (4, 4, "widest")]


@pytest.mark.parametrize("nx,ny,u", MDRNN_BWD_EDGES)
def test_b14_stages_match_staged_plain(cuda, nx, ny, u):
    """B14's three stages against ``log_prob_bwd_staged_plain``'s: the
    replay (B12 storing), C's rows and the gradients; the same bits twice,
    and from a replay that B12 stored."""
    if u == "widest":
        u = max(v for v in range(1, 257) if fused_mdrnn.supports(nx, ny, v, cuda))
    w, s = _mdrnn_weights(nx, ny, u, cuda), _lattices(nx, ny, cuda)
    g = _cotangent(B, cuda)
    before = fused_mdrnn_bwd.mdrnn_log_prob_bwd.launches
    grads, replay, cot = fused_mdrnn_bwd.mdrnn_log_prob_bwd_stages(w, s, g)
    want, want_replay, want_cot = fused_mdrnn_bwd.log_prob_bwd_stages_plain(w, s, g)
    torch.testing.assert_close(replay.lp, want_replay.lp, atol=1e-5 * nx * ny, rtol=0)
    _close_to_max(replay.hist, want_replay.hist)
    torch.testing.assert_close(replay.p1, want_replay.p1, atol=1e-5, rtol=0)
    _close_to_max(cot, want_cot)
    for a, b in zip(grads, want):
        _close_to_max(a, b)
    for a, b in zip(grads, fused_mdrnn.log_prob_bwd_plain(w, s, g)):
        _close_to_max(a, b)
    again = fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, g)
    stored = fused_mdrnn.mdrnn_log_prob(w, s, store=True)
    from_replay = fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, g, replay=stored)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))
    assert all(torch.equal(a, b) for a, b in zip(from_replay, grads))
    assert torch.equal(stored.lp, fused_mdrnn.mdrnn_log_prob(w, s))
    assert fused_mdrnn_bwd.mdrnn_log_prob_bwd.launches == before + 3
    with pytest.raises(ValueError, match="replay tensor"):
        fused_mdrnn_bwd.mdrnn_log_prob_bwd(w, s, g, replay=stored._replace(p1=stored.p1[1:]))


# the suffix pass's tile edges: (nx, ny, U, B, scale of W_h and W_v): one
# site to the 16x16 flagship, non-square and one-wide lattices, B=37 (not a
# multiple of the 32 trajectories of a block), one sample and B=33, both
# row-tile counts (U <= 64 and past it), and the widest lattice the family
# covers.  On the two wide lattices the recurrent matrices are halved, as
# chip_smoke.py's: at their full size the states grow along the sweep until
# log p nears 1e12, where float32 keeps no digit of the absolute tolerance.
MDRNN_FLIP_EDGES = [(nx, ny, 50, B, 1.0) for nx, ny in MDRNN_SHAPES + [(1, 1)]] + [
    (4, 3, 50, 1, 1.0), (5, 4, 50, 1, 1.0), (3, 5, 50, 33, 1.0), (4, 4, 7, B, 1.0),
    (4, 4, 100, B, 1.0), (16, 16, 50, B, 0.5), ("widest", 2, 50, 3, 0.5),
]


@pytest.mark.parametrize("nx,ny,u,b,scale", MDRNN_FLIP_EDGES)
def test_b13_b15_b16_match_plain(cuda, nx, ny, u, b, scale):
    if nx == "widest":
        nx = max(v for v in range(1, 2049) if fused_mdrnn.supports(v, ny, u, cuda))
    w = tuple(scale * t if i in (2, 3) else t
              for i, t in enumerate(_mdrnn_weights(nx, ny, u, cuda)))
    s = (torch.rand(b, nx, ny, generator=torch.Generator().manual_seed(1)) < 0.5).to(
        torch.int32).to(cuda)
    tol = 1e-5 * nx * ny
    # the ratio sums against the plain version in float64 on the same float32
    # weights: their float32 rounding grows with the sites, and at the widest
    # lattice (564 x 2 at U=50 on an H100) the float32 plain version is itself
    # 1.1e-5 from the float64 one (the kernel 9.5e-5; PERF.md)
    w64 = tuple(t.double() for t in w)
    ratio, lp = mk.mdrnn_flip_ratio_sum(w, s)
    _, lp_p = mk.flip_ratio_sum_plain(w, s)
    torch.testing.assert_close(ratio.double(), mk.flip_ratio_sum_plain(w64, s)[0], rtol=1e-4,
                               atol=0)
    torch.testing.assert_close(lp, lp_p, atol=tol, rtol=0)
    assert torch.equal(mk.mdrnn_flip_ratio_sum(w, s)[0], ratio)
    s13, lp13 = fused_mdrnn.mdrnn_sample(w, b, nx, ny, 3, 5)
    s16, lp16, ratio16 = mk.mdrnn_sample_and_flip_sum(w, b, nx, ny, 3, 5)
    assert s16.shape == (b, nx, ny) and bool(((s16 == 0) | (s16 == 1)).all())
    assert torch.equal(s13, s16)
    torch.testing.assert_close(lp13, fused_mdrnn.log_prob_plain(w, s13), atol=tol, rtol=0)
    torch.testing.assert_close(lp16, lp13, atol=0, rtol=0)
    torch.testing.assert_close(ratio16.double(), mk.flip_ratio_sum_plain(w64, s16)[0], rtol=1e-4,
                               atol=0)
    again, _, ratio_again = mk.mdrnn_sample_and_flip_sum(w, b, nx, ny, 3, 5)
    assert torch.equal(again, s16) and torch.equal(ratio_again, ratio16)
    s13_again, lp13_again = fused_mdrnn.mdrnn_sample(w, b, nx, ny, 3, 5)
    assert torch.equal(s13_again, s13) and torch.equal(lp13_again, lp13)


def test_mdrnn_training_step_runs_b12_b14_b16(cuda):
    trainer = VMCTrainer(MDRNN2D(4, 3, 16, device=cuda), TFIM2D(4, 3, 3.0, encoding="grid"),
                         TrainConfig(num_samples=B))
    state = trainer.init()
    fns = (mk.mdrnn_sample_and_flip_sum, fused_mdrnn.mdrnn_log_prob,
           fused_mdrnn_bwd.mdrnn_log_prob_bwd, mk.mdrnn_flip_ratio_sum, fused_mdrnn.mdrnn_sample)
    counts = [fn.launches for fn in fns]
    state, ms = trainer.run_steps(state, 2)
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 2, 2, 0, 0]
    assert bool(torch.isfinite(ms["mean_energy"]).all())
    # trainer.local_energy runs B15 and MDRNN2D.sample runs B13
    trainer.local_energy(trainer.ansatz.sample(B, torch.Generator().manual_seed(0)))
    assert [fn.launches - c for fn, c in zip(fns, counts)] == [2, 2, 2, 1, 1]


def test_mdrnn_coverage_on_the_card(cuda):
    # the lattices and widths the one-warp sweep of earlier versions took
    assert fused_mdrnn.supports(257, 2, 50, cuda) and fused_mdrnn.supports(16, 16, 128, cuda)
    with pytest.raises(ValueError, match="do not take"):
        fused_mdrnn.mdrnn_log_prob(_mdrnn_weights(4, 4, 256, cuda), _lattices(4, 4, cuda))
    wide = MDRNN2D(4, 4, 256, device=cuda)
    with pytest.raises(ValueError, match="impl='plain'"):
        wide.log_prob(_lattices(4, 4, cuda))
    with pytest.raises(ValueError, match="impl='plain'"):
        VMCTrainer(wide, TFIM2D(4, 4, 3.0, encoding="grid"))
    plain = MDRNN2D(4, 4, 256, impl="plain", device=cuda)
    assert plain.log_prob(_lattices(4, 4, cuda)).shape == (B,)


# ---- minSR: the jacobian sweeps B17, B19, B20 and the CG solve B21


@pytest.mark.parametrize("b,n", [(b, n) for b in (1, 3, 64, 500) for n in (1, 2, 100, 1000)])
def test_b17_matches_plain(cuda, b, n):
    """B17 (K2's replay and reverse sweep with g = 1) at one sample, a
    ragged 3, the N=1000 chain's 64 and the flagship 500, over one site, two,
    the flagship chain and N=1000, where the TPU kernel takes its spill
    variant B18 (the sweep takes one sample per block below B=264 on an
    H100, two at B=500); then the rows and log p through it, the rows
    against the plain ones up to N=100."""
    w = _weights(50, cuda)
    s = (torch.rand(b, n, generator=torch.Generator().manual_seed(3)) < 0.5).to(
        torch.int32).to(cuda)
    before = fused_jac.jac_sweep.launches
    got = fused_jac.jac_sweep(w, s)
    assert fused_jac.jac_sweep.launches == before + 1
    want = fused_jac.jac_sweep_plain(w, s)
    for a, ref in zip((got.hist, got.dg, got.dl1), (want.hist, want.dg, want.dl1)):
        _close_to_max(a, ref)
    lp, rows = fused_jac.prnn1d_rows(w, s)
    torch.testing.assert_close(lp, fused_gru.log_prob_plain(w, s), atol=1e-5 * n, rtol=0)
    assert rows["rnn"][0]["wh"].shape == (b, 50, 150) and rows["head"]["w"].shape == (b, 50, 2)
    if n <= 100:  # the plain rows on the CPU
        _, rows_p = fused_jac.prnn1d_rows(tuple(t.cpu() for t in w), s.cpu())
        for a, ref in zip(interop.tree_leaves(rows), interop.tree_leaves(rows_p)):
            _close_to_max(a.cpu(), ref)


@pytest.mark.parametrize("b,u", [(b, u) for b in (1, 5, 500) for u in (12, 50, 91)])
def test_b19_b20_match_plain(cuda, b, u):
    """B19 at one sample, a ragged 5 (a block takes 2) and the flagship 500,
    storing and not, against its plain version; B20 from B19's stored
    gates (two parts, one sample a block) and alone (B19 storing first)
    against the plain sweep that recomputes the gates, and against its
    stored-gates plain twin; the same bits twice and by both routes."""
    w = _crnn_weights(u, cuda)
    keys = torch.rand(b, N, generator=torch.Generator().manual_seed(b))
    s = (keys.argsort(dim=1) < N // 2).to(torch.int32).to(cuda)
    trunk = w[:4]
    before = (fused_jac.rollout_hist.launches, fused_jac.sweep_dgates.launches)
    hist = fused_jac.rollout_hist(trunk, s)
    _close_to_max(hist, fused_jac.rollout_hist_plain(trunk, s))
    hist_s, gates = fused_jac.rollout_hist(trunk, s, store=True)
    assert torch.equal(hist_s, hist)
    want_hist, want_gates = fused_jac.rollout_hist_plain(trunk, s, store=True)
    _close_to_max(gates, want_gates, rel=1e-5)
    douts = torch.randn(2, b, N, u, generator=torch.Generator().manual_seed(4)).to(cuda)
    dg = fused_jac.sweep_dgates(trunk, s, hist, douts, gates=gates)
    assert dg.shape == (2, b, N, 4 * u)
    _close_to_max(dg, fused_jac.sweep_dgates_plain(trunk, s, hist, douts))
    _close_to_max(dg, fused_jac.sweep_stored_plain(trunk, hist, gates, douts), rel=1e-5)
    assert torch.equal(fused_jac.sweep_dgates(trunk, s, hist, douts), dg)
    assert torch.equal(fused_jac.sweep_dgates(trunk, s, hist, douts, gates=gates), dg)
    assert (fused_jac.rollout_hist.launches, fused_jac.sweep_dgates.launches) == (
        before[0] + 2, before[1] + 3)
    # one part and three: two (sample, part) trajectories a block, the last
    # block padded
    for parts in (1, 3):
        d = torch.randn(parts, b, N, u, generator=torch.Generator().manual_seed(parts)).to(cuda)
        _close_to_max(fused_jac.sweep_dgates(trunk, s, hist, d, gates=gates),
                      fused_jac.sweep_dgates_plain(trunk, s, hist, d))
    with pytest.raises(ValueError, match="replay"):
        fused_jac.sweep_dgates(trunk, s, hist, douts, gates=gates[:, :-1])


def _spd(s, device, seed=0):
    """A symmetric positive definite (S, S) system of an SR Gram's form,
    A A^T / (2S) + 1e-2 I with A (S, 2S), and a right-hand side."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(s, 2 * s, generator=gen, dtype=torch.float64)
    t = (a @ a.T / (2 * s) + 1e-2 * torch.eye(s, dtype=torch.float64)).float()
    return t.to(device), torch.randn(s, generator=gen).to(device)


# B21's path at each size: one block holds T in registers up to S=64, a
# cluster of 4 blocks up to 256, of 8 up to 512 (the TFIM system, S=500), the
# cooperative grid at the J1-J2 system (2S=1000) and past it
B21_PATHS = {8: "block", 64: "block", 100: "cluster", 230: "cluster", 250: "cluster",
             500: "cluster", 1000: "grid", 3000: "grid"}


@pytest.mark.parametrize("s", sorted(B21_PATHS))
def test_b21_matches_plain_and_is_deterministic(cuda, s):
    """B21 on one block (S=8 and the N=1000 chain's S=64), a cluster of 4
    (S=100, 230 and 250) and of 8 (the TFIM system, S=500), the J1-J2
    system (2S=1000) and S=3000 on the cooperative grid, whose blocks read
    their rows from L2 at S=3000: the path taken, against the plain CG and
    the Cholesky solve, and the same bits on a second run."""
    t, c = _spd(s, cuda)
    before = sr_cg.sr_cg_solve.launches
    x = sr_cg.sr_cg_solve(t, c, 64)
    assert sr_cg.sr_cg_solve.launches == before + 1
    assert sr_cg.sr_cg_solve.last_path == B21_PATHS[s]
    assert torch.equal(sr_cg.sr_cg_solve(t, c, 64), x)
    plain = sr_cg.cg_solve_plain(t, c, 64)
    exact = torch.cholesky_solve(c[:, None], torch.linalg.cholesky(t))[:, 0]
    for ref in (plain, exact):
        assert float((x - ref).norm() / ref.norm()) < 1e-4


@pytest.mark.parametrize("s", [8, 250, 500, 1000])
def test_b21_exact_convergence_guard(cuda, s):
    """2 I x = 1 converges in one step; the 1e-30 guards then freeze the
    iterate instead of dividing 0 by 0, on each path (one block, clusters
    of 4 and 8, the grid)."""
    x = sr_cg.sr_cg_solve(2.0 * torch.eye(s, device=cuda), torch.ones(s, device=cuda), 64)
    assert sr_cg.sr_cg_solve.last_path == B21_PATHS[s]
    assert torch.equal(x, torch.full((s,), 0.5, device=cuda))


def test_minsr_training_steps_launch_their_kernels(cuda):
    """minSR on the card: the TFIM step runs K3, B17 and B21 (no K1/K2), the
    J1-J2 step B11, B19, B20 and B21 (no B7, B9 or B9's replay), once per
    step each."""
    cfg = TrainConfig(num_samples=B, optimizer="minsr", learning_rate=5e-2)
    for ansatz, ham, fns in (
            (PRNN1D(N, (16,), device=cuda), TFIM1D(N, 1.0),
             (tk.tfim_sample_and_flip_sum, fused_jac.jac_sweep, sr_cg.sr_cg_solve,
              fused_gru.gru_log_prob, fused_gru_bwd.gru_log_prob_bwd)),
            (CRNNU1(N, (16,), device=cuda), J1J2(N, j2=0.2),
             (jk.j1j2_sample_and_exchange, fused_jac.rollout_hist, fused_jac.sweep_dgates,
              sr_cg.sr_cg_solve, fused_crnn.crnn_log_amp_parts, fused_crnn.crnn_replay,
              fused_crnn_bwd.crnn_log_amp_bwd))):
        trainer = VMCTrainer(ansatz, ham, cfg)
        state = trainer.init()
        counts = [fn.launches for fn in fns]
        state, ms = trainer.run_steps(state, 2)
        idle = 3 if fused_crnn.crnn_replay in fns else 2
        want = [2] * (len(fns) - idle) + [0] * idle
        assert [fn.launches - c for fn, c in zip(fns, counts)] == want
        assert bool(torch.isfinite(ms["mean_energy"]).all())


@pytest.mark.parametrize("kind", ["tfim", "parity", "j1j2"])
def test_minsr_direction_on_the_kernels_matches_plain(cuda, kind):
    """The rows and the minSR direction through the kernels against the
    plain rows and a Cholesky solve, both on the card."""
    if kind == "j1j2":
        models = [CRNNU1(N, (16,), impl=impl, device=cuda) for impl in ("auto", "plain")]
        s = _sector(cuda)
    else:
        models = [PRNN1D(N, (16,), parity=kind == "parity", impl=impl, device=cuda)
                  for impl in ("auto", "plain")]
        s = _samples(cuda)
    models[0].init(torch.Generator().manual_seed(5))
    models[1].load_state_dict(models[0].state_dict())
    gen = torch.Generator().manual_seed(6)
    e_re, e_im = (torch.randn(B, generator=gen).to(cuda) for _ in range(2))
    if kind != "j1j2":
        e_im = None
    dirs = []
    for model, solver in zip(models, ("cg", "chol")):
        rows_re, rows_im = minsr.per_sample_log_amp_grad_trees(model, s)
        dirs.append(minsr.minsr_direction_tree(
            rows_re, rows_im, e_re, e_im, e_re.mean(), None if e_im is None else e_im.mean(),
            1e-2, solver=solver))
    for a, b in zip(interop.tree_leaves(dirs[0]), interop.tree_leaves(dirs[1])):
        _close_to_max(a, b, rel=1e-3)
