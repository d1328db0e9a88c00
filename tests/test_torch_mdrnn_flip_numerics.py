"""PyTorch port: the arithmetic of B15/B16's suffix pass on the tensor cores
(``csrc/mdrnn_flip.cu``), emulated on the CPU and held against the JAX
package's ``mdrnn_flip_ratio_sum`` (its Pallas kernel in interpret mode, as
tests/test_torch_mdrnn.py runs it), so that the chosen numerics are known
to meet the tolerances before any card runs them.

Each suffix site is one product [W_h; W_v]^T . [h_h; h_v] by wgmma in TF32
made float32-accurate by the 3xTF32 split: each operand x = hi + lo, hi = x
with the low 13 mantissa bits cleared, lo = (x - hi) cleared the same way.
Per k-step of 8 (each half padded to a multiple of 8 units, the half of an
absent neighbour skipped), the accumulators take W_lo.h_hi, then W_hi.h_lo,
then W_hi.h_hi in float32; the gate update adds them to the input terms
b + uh[x_h] + uv[x_v] (an absent neighbour's term skipped) and applies the
ELU.  The vertical state
is split where it is staged as the product's B operand, from the row
buffer's plain float32 or from the base history; the horizontal one where
the gate update writes it: both splits are the same function of the
float32 state, applied here at the product.  The base pass is the
unchanged sweep (the port's plain version).

Tolerances are chip_smoke.py's: log p 1e-5 per site, ratio sums 1e-4
relative.  The helpers live here and nothing on the port's path imports
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.models.mdrnn2d import MDRNN2D as JMDRNN2D
from rnnwavefunctions_tpu.ops import mdrnn_flip_kernel as jmk
from rnnwavefunctions_tpu_torch import MDRNN2D, interop
from rnnwavefunctions_tpu_torch.ops import mdrnn_flip_kernel as mk

torch.set_num_threads(1)

B = 16


def _pair(nx, ny, u, seed):
    """JAX params (Glorot plus seeded noise, so no bias is zero) and the
    port's weights holding the same values."""
    jans = JMDRNN2D(nx=nx, ny=ny, units=u, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    model = MDRNN2D(nx, ny, u, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return params, tuple(w.detach() for w in model.weights())


def _tf32(x):
    """x cut to TF32: the low 13 of float32's 23 mantissa bits cleared."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _pad_rows(m, kp):
    out = torch.zeros(kp, *m.shape[1:])
    out[: m.shape[0]] = m
    return out


def _tensor_core_site(weights, hh, xh, sh, hv, xv, sv):
    """One suffix site as the kernel computes it (the signature of
    ``fused_mdrnn.site_step``, whose place it takes in the plain suffix
    loop): (h_new, logit_0, logit_1)."""
    uh, uv, wh, wv, b, hw, hb = weights
    u = wh.shape[0]
    kp = -(-u // 8) * 8
    a = b.expand(hh.shape[0], -1)
    if sh:
        a = a + uh[xh.long()]
    if sv:
        a = a + uv[xv.long()]
    acc = torch.zeros(hh.shape[0], u)
    halves = ([(hh, wh)] if sh else []) + ([(hv, wv)] if sv else [])
    for h, w in halves:
        hp, wp = _pad_rows(h.T, kp).T, _pad_rows(w, kp)
        for k0 in range(0, kp, 8):
            h_hi, h_lo = _split(hp[:, k0:k0 + 8])
            w_hi, w_lo = _split(wp[k0:k0 + 8])
            acc = acc + h_hi @ w_lo
            acc = acc + h_lo @ w_hi
            acc = acc + h_hi @ w_hi
    pre = a + acc
    h = torch.where(pre > 0, pre, torch.exp(torch.clamp(pre, max=0.0)) - 1.0)
    logits = h @ hw + hb
    return h, logits[:, 0], logits[:, 1]


@pytest.mark.parametrize("u", [12, 50])
@pytest.mark.parametrize("nx,ny", [(3, 3), (4, 3), (3, 5)], ids=["3x3", "4x3", "3x5"])
def test_tensor_core_suffix_scheme_matches_jax(monkeypatch, nx, ny, u):
    """The suffix sites in the 3xTF32 scheme give the JAX kernel's ratio
    sums within 1e-4 relative and its base log p within 1e-5 per site, and
    every flipped configuration's log p within 1e-5 per site of the plain
    float32 suffix."""
    params, weights = _pair(nx, ny, u, seed=31 + u)
    s = np.random.default_rng(32).integers(0, 2, (B, nx, ny)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        j_ratio, j_lp = jmk.mdrnn_flip_ratio_sum(params, jnp.asarray(s), nx, ny)
    spins, lp, hist, pfx = mk.base_pass_plain(weights, nx, ny, samples=torch.from_numpy(s))
    want_lpf = mk.flip_log_probs_plain(weights, spins, hist, pfx, nx, ny)
    monkeypatch.setattr(mk, "site_step", _tensor_core_site)
    lpf = mk.flip_log_probs_plain(weights, spins, hist, pfx, nx, ny)
    tol = 1e-5 * nx * ny
    np.testing.assert_allclose(lpf.numpy(), want_lpf.numpy(), atol=tol, rtol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=tol, rtol=0)
    np.testing.assert_allclose(mk.ratio_sum(lpf, lp).numpy(), np.asarray(j_ratio), rtol=1e-4)
    # the scheme is not a no-op: TF32 alone is ~3 digits, far from float32
    assert float((_tf32(weights[2]) - weights[2]).abs().max()) > 1e-5
