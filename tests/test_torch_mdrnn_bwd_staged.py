"""PyTorch port: B14's three stages (``csrc/fused_mdrnn_bwd.cu``) as tensor
ops, held on the CPU against the JAX package.

* Stage 1, B12 storing the replay: ``fused_mdrnn.replay_plain``'s log p
  against JAX's ``mdrnn_log_prob`` in interpret mode.
* Stages 2 and 3: the reverse sweep with each recurrent product's U-long
  sum in four slices added in order, and the weight cotangent as one
  product over the (sample, site) rows with A gathered from the history,
  in chunks summed in chunk order
  (``fused_mdrnn_bwd.log_prob_bwd_staged_plain``), against JAX's
  ``mdrnn_log_prob_bwd`` in interpret mode, ``jax.grad`` of the jnp path
  and the port's autograd plain version.

Lattices 3x4 and 4x4, U = 8 and U = 50, B = 37; inputs are drawn with numpy
from a seed and carried across by ``interop``.  Tolerances: log p 1e-5 per
site; gradients 1e-4 of max(1, largest |entry|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.ops import fused_mdrnn as jfused_mdrnn
from rnnwavefunctions_tpu.ops.fused_mdrnn_bwd import mdrnn_log_prob_bwd as jmdrnn_log_prob_bwd
from rnnwavefunctions_tpu_torch.ops import fused_mdrnn, fused_mdrnn_bwd
from test_torch_mdrnn import NAMES, _pair, _samples

torch.set_num_threads(1)

B = 37
CASES = [(nx, ny, u) for nx, ny in ((3, 4), (4, 4)) for u in (8, 50)]
IDS = [f"{nx}x{ny}_u{u}" for nx, ny, u in CASES]


def _case(nx, ny, u):
    jans, params, model = _pair(nx, ny, units=u, seed=10 * nx + ny + u)
    rng = np.random.default_rng(nx * 100 + ny * 10 + u)
    samples = _samples(B, nx, ny, seed=u)
    g = rng.standard_normal(B).astype(np.float32)
    return jans, params, tuple(w.detach() for w in model.weights()), samples, g


def _close_to_max(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("nx,ny,u", CASES, ids=IDS)
def test_b14_staged_plain_matches_jax_interpret_and_grad(nx, ny, u):
    jans, params, w, samples, g = _case(nx, ny, u)
    ts, tg = torch.from_numpy(samples), torch.from_numpy(g)
    got = fused_mdrnn_bwd.log_prob_bwd_staged_plain(w, ts, tg)
    js = jnp.asarray(samples)
    with pltpu.force_tpu_interpret_mode():
        pallas = jmdrnn_log_prob_bwd(params, js, jnp.asarray(g), nx, ny)
    # log_amp = 0.5 log p: its gradient with 2 g is log p's with g
    want = jax.grad(lambda p: jnp.sum(2.0 * g * jans.log_amp(p, js)))(params)
    autograd = fused_mdrnn.log_prob_bwd_plain(w, ts, tg)
    for i, (m, k) in enumerate(NAMES):
        _close_to_max(got[i].numpy(), pallas[m][k])
        _close_to_max(got[i].numpy(), want[m][k])
        _close_to_max(got[i].numpy(), autograd[i].numpy())


@pytest.mark.parametrize("nx,ny,u", CASES, ids=IDS)
def test_b12_storing_replay_matches_jax_interpret(nx, ny, u):
    _, params, w, samples, _ = _case(nx, ny, u)
    ts = torch.from_numpy(samples)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused_mdrnn.mdrnn_log_prob(params, jnp.asarray(samples), nx, ny))
    replay = fused_mdrnn.mdrnn_log_prob(w, ts, store=True)
    np.testing.assert_allclose(replay.lp.numpy(), want, rtol=0, atol=1e-5 * nx * ny)
    # the stored history is the plain sweep's, in visit order, and p1 its
    # head's probability of an up spin
    _, lp, hist, _ = fused_mdrnn.sweep_plain(w, nx, ny, samples=ts)
    torch.testing.assert_close(replay.hist, hist, atol=0, rtol=0)
    torch.testing.assert_close(replay.lp, lp, atol=0, rtol=0)
    logits = hist @ w[5] + w[6]
    torch.testing.assert_close(replay.p1, torch.softmax(logits, dim=-1)[..., 1],
                               atol=1e-6, rtol=0)
    assert fused_mdrnn.mdrnn_log_prob.launches == 0


def test_b14_stages_on_cpu_are_the_staged_plain_version():
    """On CPU tensors B14's stage view runs the staged plain version: C's
    rows hold dl1 = g (s - p1) in visit order, and the gradients equal
    ``log_prob_bwd_staged_plain``'s bit for bit."""
    nx, ny, u = 4, 3, 8
    _, _, w, samples, g = _case(nx, ny, u)
    ts, tg = torch.from_numpy(samples), torch.from_numpy(g)
    grads, replay, cot = fused_mdrnn_bwd.mdrnn_log_prob_bwd_stages(w, ts, tg)
    for a, b in zip(grads, fused_mdrnn_bwd.log_prob_bwd_staged_plain(w, ts, tg)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    xx, yy = fused_mdrnn.visit_order(nx, ny)
    spins = ts[:, xx, yy].to(torch.float32)
    torch.testing.assert_close(cot[..., u], tg[:, None] * (spins - replay.p1), atol=0, rtol=0)
    assert fused_mdrnn_bwd.mdrnn_log_prob_bwd.launches == 0
