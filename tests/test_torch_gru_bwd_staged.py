"""PyTorch port: the plain versions of K1 and K2 as their CUDA kernels now
compute them, held on the CPU against the JAX package.

* K1 runs the teacher-forced base pass of ``csrc/tfim_flip.cu``; its plain
  version ``fused_gru.base_pass_plain`` (and the replay K1 stores
  for K2, ``fused_gru.replay_plain``) against JAX's ``_log_prob_pallas`` in
  interpret mode.
* K2 runs in three stages (``csrc/fused_gru_bwd.cu``): the replay, the
  reverse sweep with its 3U-long sum in four slices added in order, and
  the weight cotangent as one product over the (sample, site) rows in
  chunks summed in chunk order.  ``fused_gru_bwd.log_prob_bwd_staged_plain``
  does the same with tensor ops; it is held against JAX's
  ``gru_log_prob_bwd`` in interpret mode, ``jax.grad`` of the jnp path and
  the port's autograd plain version.

Ragged shapes: B in {1, 5, 17}, N in {1, 2, 9}, U in {7, 16}; inputs are
drawn with numpy from a seed and carried across by ``interop``.
Tolerances: log p 1e-5; gradients 1e-5 of max(1, largest |entry|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
from rnnwavefunctions_tpu.ops import fused_gru as jfused_gru
from rnnwavefunctions_tpu.ops.fused_gru_bwd import gru_log_prob_bwd as jgru_log_prob_bwd
from rnnwavefunctions_tpu_torch import PRNN1D, interop
from rnnwavefunctions_tpu_torch.ops import fused_gru, fused_gru_bwd

torch.set_num_threads(1)

SHAPES = [(b, n, u) for b in (1, 5, 17) for n in (1, 2, 9) for u in (7, 16)]
NAMES = ("wx", "wh", "bx", "bh")


def _case(b, n, u, seed=0):
    """JAX params (Glorot plus seeded noise, so no bias is zero), the port's
    weights holding the same values, (b, n) samples and a cotangent."""
    jans = JPRNN1D(num_sites=n, units=(u,), impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(1000 * b + 10 * n + u)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    model = PRNN1D(n, (u,), device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    samples = rng.integers(0, 2, (b, n)).astype(np.int32)
    g = rng.standard_normal(b).astype(np.float32)
    return jans, params, tuple(w.detach() for w in model.weights()), samples, g


def _flat(tree):
    return [tree["rnn"][0][k] for k in NAMES] + [tree["head"]["w"], tree["head"]["b"]]


def _assert_grads(got, want):
    for a, ref in zip(got, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("b,n,u", SHAPES)
def test_k1_route_plain_matches_jax_interpret(b, n, u):
    _, params, w, samples, _ = _case(b, n, u)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused_gru._log_prob_pallas(params, jnp.asarray(samples)))
    s = torch.from_numpy(samples)
    _, lp, *_ = fused_gru.base_pass_plain(w, samples=s)
    np.testing.assert_allclose(lp.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(fused_gru.replay_plain(w, s).lp.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(fused_gru.gru_log_prob(w, s).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,n,u", SHAPES)
def test_k2_staged_plain_matches_jax_interpret_and_grad(b, n, u):
    jans, params, w, samples, g = _case(b, n, u)
    got = fused_gru_bwd.log_prob_bwd_staged_plain(w, torch.from_numpy(samples),
                                                  torch.from_numpy(g))
    with pltpu.force_tpu_interpret_mode():
        pallas = jgru_log_prob_bwd(params, jnp.asarray(samples), jnp.asarray(g))
    _assert_grads(got, _flat(pallas))
    want = jax.grad(lambda p: jnp.sum(
        jnp.asarray(g) * jans._log_prob_plain_jnp(p, jnp.asarray(samples))))(params)
    _assert_grads(got, _flat(want))


@pytest.mark.parametrize("b,n,u", SHAPES)
def test_k2_staged_plain_matches_autograd_plain(b, n, u):
    _, _, w, samples, g = _case(b, n, u)
    s, gt = torch.from_numpy(samples), torch.from_numpy(g)
    staged, replay, rev = fused_gru_bwd.gru_log_prob_bwd_stages(w, s, gt)
    want = fused_gru.log_prob_bwd_plain(w, s, gt)
    _assert_grads(staged, want)
    _assert_grads(fused_gru_bwd.gru_log_prob_bwd(w, s, gt), want)
    assert replay.hist.shape == (b, n, u) and replay.gates.shape == (b, n, 4 * u)
    assert rev.da.shape == (b, n, 3 * u) and rev.dl1.shape == (b, n)
    # A's rows hold the states and inputs; C's the gate and head cotangents
    x = s.to(torch.float32)
    torch.testing.assert_close(replay.rows[:, 1:, u + 1], 1.0 - x, rtol=0, atol=0)
    torch.testing.assert_close(rev.dl1, gt[:, None] * (x - replay.p1), rtol=0, atol=0)


@pytest.mark.parametrize("chunk_rows", [fused_gru_bwd.CHUNK_ROWS, 7, 1])
def test_k2_weight_cotangent_over_many_chunks(chunk_rows):
    """B (N + 1) = 640 rows: two chunks of the kernel's size, and the
    ragged and one-row chunkings give the same gradients to rounding."""
    _, _, w, samples, g = _case(64, 9, 7)
    s, gt = torch.from_numpy(samples), torch.from_numpy(g)
    replay = fused_gru.replay_plain(w, s)
    rev = fused_gru_bwd.reverse_plain(w, s, gt, replay)
    got = fused_gru_bwd.weight_cotangent_plain(replay, rev, chunk_rows=chunk_rows)
    _assert_grads(got, fused_gru.log_prob_bwd_plain(w, s, gt))


def test_autograd_function_runs_the_plain_path_on_the_cpu():
    """GRULogProb keeps no replay on the CPU (the card's forward stores one
    for K2): its gradient is the plain version's."""
    _, _, w, samples, g = _case(5, 9, 16)
    ws = [t.clone().requires_grad_(True) for t in w]
    lp = fused_gru.log_prob(tuple(ws), torch.from_numpy(samples))
    (torch.from_numpy(g) * lp).sum().backward()
    _assert_grads([t.grad for t in ws],
                  fused_gru.log_prob_bwd_plain(w, torch.from_numpy(samples),
                                               torch.from_numpy(g)))
