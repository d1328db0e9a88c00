"""The frozen reference against the port's plain path (``impl="plain"``, on
the CPU) on the same parameters and samples: log p, local energies, the
loss gradient, the minSR direction, one Adam and one SGD update."""

import math

import pytest
import torch

from benchmark.reference import FP32, TF32, gru_chain, mdrnn_lattice, round_tf32, tfim, vmc
from benchmark.system import make_weights
from rnnwavefunctions_tpu_torch import MDRNN2D, PRNN1D, TFIM1D, TFIM2D
from rnnwavefunctions_tpu_torch.vmc import minsr
from rnnwavefunctions_tpu_torch.vmc.local_energy import make_local_energy_fn
from rnnwavefunctions_tpu_torch.vmc.loss import surrogate_loss

CASES = {
    "chain": dict(make=lambda: PRNN1D(9, (12,), impl="plain", device="cpu"),
                  ham=lambda: TFIM1D(9, bx=1.0), ref=gru_chain, bx=1.0),
    "lattice": dict(make=lambda: MDRNN2D(3, 4, units=10, impl="plain", device="cpu"),
                    ham=lambda: TFIM2D(3, 4, bx=3.0, encoding="grid"),
                    ref=mdrnn_lattice, bx=3.0),
}


def _terms(c):
    return {"bx": c["bx"], "jz": 1.0}


def _setup(case, seed=1234567, s=40):
    c = CASES[case]
    ansatz = c["make"]()
    params = make_weights(ansatz, seed)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator().manual_seed(7))
              for k, v in params.items()}  # non-zero biases too
    with torch.no_grad():
        for k, p in ansatz.named_parameters():
            p.copy_(params[k])
    samples = ansatz.sample(s, torch.Generator().manual_seed(seed))
    return c, ansatz, params, samples


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_prob_matches_plain_path(case):
    c, ansatz, params, samples = _setup(case)
    got = c["ref"].log_prob(params, samples)
    want = ansatz.log_prob(samples).double()
    assert got.dtype == torch.float64
    assert torch.allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_local_energy_matches_plain_path(case):
    c, ansatz, params, samples = _setup(case)
    e_ref, _ = tfim.local_energy(c["ref"], params, samples, _terms(c))
    le = make_local_energy_fn(ansatz, c["ham"]())
    e_port, _, _ = le(samples, ansatz.log_amp(samples))
    assert torch.allclose(e_ref, e_port.double(), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_gradient_matches_autograd_of_plain_path(case):
    c, ansatz, params, samples = _setup(case)
    e, _ = tfim.local_energy(c["ref"], params, samples, _terms(c))
    got = vmc.loss_gradient(c["ref"], params, samples, e)
    e32 = e.float()
    ansatz.zero_grad()
    surrogate_loss(ansatz.log_amp(samples), None, e32, None, e32.mean(), None).backward()
    for k, p in ansatz.named_parameters():
        scale = p.grad.abs().max()
        assert torch.allclose(got[k], p.grad, atol=1e-4 * float(scale), rtol=0), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_minsr_direction_matches_plain_path(case):
    c, ansatz, params, samples = _setup(case, s=24)
    e, _ = tfim.local_energy(c["ref"], params, samples, _terms(c))
    rows = vmc.log_psi_rows(c["ref"], params, samples)
    got = vmc.minsr_direction(rows, e, 1e-2)
    rows_re, _ = minsr.per_sample_log_amp_grad_trees(ansatz, samples)
    e32 = e.float()
    tree = minsr.minsr_direction_tree(rows_re, None, e32, None, e32.mean(), None, 1e-2,
                                      solver="chol")
    from rnnwavefunctions_tpu_torch.interop import param_tree, tree_leaves

    names = {id(p): k for k, p in ansatz.named_parameters()}
    for p, d in zip(tree_leaves(param_tree(ansatz)), tree_leaves(tree)):
        k = names[id(p)]
        assert torch.allclose(got[k], d, atol=2e-3 * float(d.abs().max()), rtol=0), k


def test_adam_and_sgd_match_torch_optim():
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(5, 4, generator=gen), "b": torch.randn(3, generator=gen)}
    grads = [{k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
             for _ in range(3)]
    for ref_opt, make in ((vmc.Adam(params, 5e-3), lambda ps: torch.optim.Adam(ps, lr=5e-3)),
                          (vmc.SGD(params, 5e-2), lambda ps: torch.optim.SGD(ps, lr=5e-2))):
        leaves = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
        opt = make(list(leaves.values()))
        ref = dict(params)
        for g in grads:
            for k, p in leaves.items():
                p.grad = g[k].clone()
            opt.step()
            ref = ref_opt.step(ref, g)
        for k, p in leaves.items():
            assert torch.allclose(ref[k], p.detach(), atol=1e-7, rtol=1e-6), k


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -12, 1.0 + 2 ** -12, -3.0 + 2 ** -9])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0 + 2 ** -9]
    assert FP32.mm is not TF32.mm


@pytest.mark.parametrize("case", sorted(CASES))
def test_tf32_reference_departs_from_fp32(case):
    """The control's precision moves log p by far more than float32
    round-off does."""
    c, _, params, samples = _setup(case)
    model = c["ref"]
    gap = (model.log_prob(params, samples, TF32) - model.log_prob(params, samples)).abs().max()
    assert float(gap) > 1e-4
    assert math.isfinite(float(gap))
