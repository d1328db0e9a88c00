"""PyTorch port: the plain versions of B9's three stages and of B20's
stored-gates route, as their CUDA kernels now compute them, held on the CPU
against the JAX package.

* B9 runs K2's three stages (``csrc/fused_crnn_bwd.cu``): the replay, B10's
  base pass storing K2's A rows, the gates and two head seeds per site
  (a_n, the cotangent of the amplitude logits' difference through the U(1)
  renormalisation, and q_n, the phase seed on the target's logit); the
  reverse sweep seeded by both heads, its 3U-long sum in four slices added
  in order; the weight cotangent as one product over the (sample, site)
  rows in chunks summed in chunk order.
  ``fused_crnn_bwd.log_amp_bwd_staged_plain`` does the same with tensor ops;
  it is held against JAX's ``crnn_log_amp_bwd`` in interpret mode,
  ``jax.grad`` of the jnp path and the port's autograd plain version; the
  replay's seeds against ``vmc/jacobian.py::crnn_head_seeds``.
* B20 sweeps from the gates B19 stores (``fused_jac.sweep_stored_plain``
  on ``rollout_hist_plain(..., store=True)``), held against JAX's
  ``sweep_dgates`` in interpret mode.

Inputs are drawn with numpy from a seed and carried across by ``interop``.
Tolerances: gradients 1e-4 of max(1, largest |entry|) (f32 recurrences
and sums taken in another order); seeds 1e-5; (Re, Im) log psi 1e-5 per
site.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.crnn_u1 import CRNNU1 as JCRNNU1
from rnnwavefunctions_tpu.ops import fused_jac as jfused_jac
from rnnwavefunctions_tpu.ops.fused_crnn_bwd import crnn_log_amp_bwd as jcrnn_log_amp_bwd
from rnnwavefunctions_tpu_torch import CRNNU1, interop
from rnnwavefunctions_tpu_torch.ops import fused_crnn, fused_crnn_bwd, fused_jac
from rnnwavefunctions_tpu_torch.vmc import jacobian

torch.set_num_threads(1)

B = 13  # odd: the reverse sweep takes two samples a block


def _case(n, u, u1, seed=0):
    """JAX CRNNU1 and its params (Glorot plus seeded noise, so no bias is
    zero), the port's weights holding the same values, the port's model,
    (B, n) zero-magnetisation samples and two cotangents."""
    jans = JCRNNU1(num_sites=n, units=(u,), u1=u1, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(100 * n + u + int(u1))
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    model = CRNNU1(n, (u,), u1=u1, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    samples = np.stack([rng.permutation(n) < n // 2 for _ in range(B)]).astype(np.int32)
    g_re, g_im = (rng.standard_normal(B).astype(np.float32) for _ in range(2))
    weights = tuple(w.detach() for w in model.weights())
    return jans, params, model, weights, samples, g_re, g_im


def _flat(tree):
    return [tree["rnn"][0][k] for k in ("wx", "wh", "bx", "bh")] + [
        tree[h][k] for h in ("head_ampl", "head_phase") for k in ("w", "b")]


def _assert_grads(got, want, rel=1e-4):
    for a, ref in zip(got, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(a), ref, rtol=0,
                                   atol=rel * max(1.0, float(np.abs(ref).max())))


# u1 on and off; N even, and odd, where a late site's mask forbids every
# class of a sample with N//2 ups (the renormalisation's clamp); a narrow U
# and the flagship's
@pytest.mark.parametrize("u", [7, 50])
@pytest.mark.parametrize("n", [10, 9], ids=["even", "odd"])
@pytest.mark.parametrize("u1", [True, False], ids=["u1", "no_u1"])
def test_b9_staged_plain_matches_jax_interpret_and_grad(u1, n, u):
    jans, params, _, w, samples, g_re, g_im = _case(n, u, u1)
    s = torch.from_numpy(samples)
    got = fused_crnn_bwd.log_amp_bwd_staged_plain(w, s, torch.from_numpy(g_re),
                                                  torch.from_numpy(g_im), u1)
    with pltpu.force_tpu_interpret_mode():
        pallas = jcrnn_log_amp_bwd(params, jnp.asarray(samples), jnp.asarray(g_re),
                                   jnp.asarray(g_im), u1)
    _assert_grads(got, _flat(pallas))
    _assert_grads(got, fused_crnn_bwd.log_amp_bwd_plain(w, s, torch.from_numpy(g_re),
                                                        torch.from_numpy(g_im), u1))
    if u1 and n % 2:
        # the jnp path takes log 0 = -inf for a forbidden target, where the
        # kernels take the finite LOG_ZERO and pass no gradient through the
        # clamped renormalisation
        return

    def loss(p):
        re, im = jans._log_amp_parts_jnp(p, jnp.asarray(samples))
        return jnp.sum(g_re * re) + jnp.sum(g_im * im)

    _assert_grads(got, _flat(jax.grad(loss)(params)))


@pytest.mark.parametrize("u1", [True, False], ids=["u1", "no_u1"])
@pytest.mark.parametrize("n", [10, 9, 1], ids=["even", "odd", "one"])
def test_replay_plain_gives_b7_and_its_stages_fit(u1, n):
    """The replay's (Re, Im) are B7's plain values bit for bit; A holds the
    states and inputs, C's head columns the seeds times the cotangents."""
    _, _, _, w, samples, g_re, g_im = _case(n, 7, u1)
    s = torch.from_numpy(samples)
    grads, replay, rev = fused_crnn_bwd.crnn_log_amp_bwd_stages(
        w, s, torch.from_numpy(g_re), torch.from_numpy(g_im), u1)
    re, im = fused_crnn.log_amp_parts_plain(w, s, u1)
    assert torch.equal(replay.re, re) and torch.equal(replay.im, im)
    assert replay.hist.shape == (B, n, 7) and replay.gates.shape == (B, n, 28)
    assert replay.seeds.shape == (B, n, 2) and rev.heads.shape == (B, n, 3)
    x = s.to(torch.float32)
    torch.testing.assert_close(replay.rows[:, 1:, 7 + 2], x, rtol=0, atol=0)
    torch.testing.assert_close(rev.heads[..., 0], torch.from_numpy(g_re)[:, None]
                               * replay.seeds[..., 0], rtol=0, atol=0)
    dq = torch.from_numpy(g_im)[:, None] * replay.seeds[..., 1]
    torch.testing.assert_close(rev.heads[..., 1] + rev.heads[..., 2], dq, rtol=0, atol=0)
    _assert_grads(grads, fused_crnn_bwd.log_amp_bwd_plain(
        w, s, torch.from_numpy(g_re), torch.from_numpy(g_im), u1))


@pytest.mark.parametrize("u1", [True, False], ids=["u1", "no_u1"])
def test_replay_seeds_match_crnn_head_seeds(u1):
    """a_n and q_n against the closed-form logit cotangents of minSR's rows
    on the replay's own states: dla = (a_n, -a_n), dlp at the target q_n."""
    n = 10
    _, _, model, w, samples, _, _ = _case(n, 12, u1, seed=3)
    s = torch.from_numpy(samples)
    replay = fused_crnn.replay_plain(w, s, u1)
    dla, dlp = jacobian.crnn_head_seeds(model, replay.hist, s, torch.cumsum(s, dim=1) - s,
                                        torch.arange(n))
    a, q = replay.seeds[..., 0], replay.seeds[..., 1]
    torch.testing.assert_close(dla[..., 0], a, rtol=0, atol=1e-5)
    torch.testing.assert_close(dla[..., 1], -a, rtol=0, atol=1e-5)
    target = torch.gather(dlp, -1, s.long()[..., None])[..., 0]
    torch.testing.assert_close(target, q, rtol=1e-5, atol=1e-6)
    assert bool((torch.gather(dlp, -1, 1 - s.long()[..., None]) == 0).all())


@pytest.mark.parametrize("chunk_rows", [fused_crnn_bwd.CHUNK_ROWS, 7, 1])
def test_b9_weight_cotangent_over_many_chunks(chunk_rows):
    """B (N + 1) = 143 rows in one chunk of the kernel's size, and ragged
    and one-row chunkings, give the same gradients to rounding."""
    _, _, _, w, samples, g_re, g_im = _case(10, 7, True, seed=5)
    s, gr, gi = torch.from_numpy(samples), torch.from_numpy(g_re), torch.from_numpy(g_im)
    replay = fused_crnn.replay_plain(w, s, True)
    rev = fused_crnn_bwd.reverse_plain(w, s, gr, gi, replay)
    got = fused_crnn_bwd.weight_cotangent_plain(replay, rev, chunk_rows=chunk_rows)
    _assert_grads(got, fused_crnn_bwd.log_amp_bwd_plain(w, s, gr, gi, True), rel=1e-5)


def test_autograd_function_keeps_no_replay_on_the_cpu():
    """CRNNLogAmpParts on CPU tensors runs the plain path (the card's forward
    stores B9's replay); under no_grad the entry point runs B7's plain loop."""
    _, _, _, w, samples, g_re, g_im = _case(8, 12, True, seed=7)
    s = torch.from_numpy(samples)
    ws = [t.clone().requires_grad_(True) for t in w]
    re, im = fused_crnn.log_amp_parts(tuple(ws), s, True)
    ((torch.from_numpy(g_re) * re).sum() + (torch.from_numpy(g_im) * im).sum()).backward()
    _assert_grads([t.grad for t in ws], fused_crnn_bwd.log_amp_bwd_plain(
        w, s, torch.from_numpy(g_re), torch.from_numpy(g_im), True), rel=1e-5)
    with torch.no_grad():
        re0, im0 = fused_crnn.log_amp_parts(tuple(ws), s, True)
    assert not re0.requires_grad and torch.equal(re0, re.detach())
    assert fused_crnn.crnn_replay.launches == 0 and fused_crnn.crnn_log_amp_parts.launches == 0


@pytest.mark.parametrize("n,b", [(1, 4), (6, 5), (40, 3)], ids=["n1", "odd-b", "long"])
def test_b20_stored_gates_route_matches_pallas_interpret(n, b):
    """B19's plain version storing the gates, then the sweep from the stored
    gates (B20's route on the card) for two parts, against the JAX kernels
    in interpret mode; and against the plain sweep that recomputes the
    gates."""
    u = 12
    jans = JCRNNU1(num_sites=n, units=(u,))
    params = jans.init(jax.random.PRNGKey(15))
    rng = np.random.default_rng(16)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    model = CRNNU1(n, (u,), device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    s = np.stack([rng.permutation(n) < n // 2 for _ in range(b)]).astype(np.int32)
    douts = rng.standard_normal((2, b, n, u)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        hist = jfused_jac.rollout_hist(params, jnp.asarray(s))
        dgs = jfused_jac.sweep_dgates(params, jnp.asarray(s), hist,
                                      [jnp.transpose(d, (1, 2, 0)) for d in douts])
    trunk = tuple(t.detach() for t in model.weights()[:4])
    st = torch.from_numpy(s)
    got_hist, gates = fused_jac.rollout_hist(trunk, st, store=True)
    np.testing.assert_allclose(got_hist.numpy(), np.transpose(hist, (2, 0, 1)),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got_hist, fused_jac.rollout_hist(trunk, st))
    got = fused_jac.sweep_dgates(trunk, st, got_hist, torch.from_numpy(douts), gates=gates)
    for p in range(2):
        np.testing.assert_allclose(got[p].numpy(), np.transpose(dgs[p], (2, 0, 1)),
                                   rtol=1e-4, atol=2e-6)
    _assert_grads([got], [fused_jac.sweep_dgates_plain(trunk, st, got_hist,
                                                       torch.from_numpy(douts))], rel=1e-5)
