"""The benchmark's J1-J2 cell (``crnn_u1_j1j2`` on ``chain_n1000_s64_adam``):
its plain complex reference against the port's plain path and against exact
diagonalisation, its work count, its files, and a cut-down copy of the cell
run through the harness on the CPU."""

import ast
import dataclasses
import itertools
import math

import numpy as np
import pytest
import torch

from benchmark import check, roofline, run
from benchmark.faults import FAULTS
from benchmark.reference import crnn_chain, j1j2, vmc_complex
from benchmark.spec import BENCH_DIR, ROOT, load_cell, load_spec, metric_reader
from benchmark.system import make_weights
from benchmark.work import crnn_chain as work
from rnnwavefunctions_tpu_torch import CRNNU1, J1J2, TrainConfig, VMCTrainer
from rnnwavefunctions_tpu_torch.ed import exact
from rnnwavefunctions_tpu_torch.vmc.local_energy import make_local_energy_fn
from rnnwavefunctions_tpu_torch.vmc.loss import surrogate_loss

CELL = "j1j2_n1000_s64_adam"
N, U, S = 12, 8, 16
TERMS = {"j1": 1.0, "j2": 0.2, "bz": 0.0, "marshall_sign": True, "periodic": False}
SEEDS = [2**31 + 101, 2**31 + 202]


def _set_up(seed, n=N, dtype=torch.float32):
    """A plain ``CRNNU1(n, (U,))`` with the benchmark's weights of ``seed``
    plus small biases, those weights by name, and S zero-magnetisation
    chains it drew."""
    ansatz = CRNNU1(n, (U,), impl="plain", device="cpu")
    params = make_weights(ansatz, seed)
    gen = torch.Generator().manual_seed(seed % 1000)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen) for k, v in params.items()}
    with torch.no_grad():
        for k, p in ansatz.named_parameters():
            p.copy_(params[k])
    samples = ansatz.sample(S, torch.Generator().manual_seed(seed % 997))
    return ansatz, {k: v.to(dtype) for k, v in params.items()}, samples


def _port_e_loc(ansatz, samples, n=N):
    le = make_local_energy_fn(ansatz, J1J2(n, j2=0.2, marshall_sign=True))
    e_re, e_im, _ = le(samples, ansatz.log_amp_parts(samples))
    return torch.complex(e_re.double(), e_im.double())


# Tolerances: the port's plain path and the reference run the same float32
# site arithmetic in another order (the reference's products as written,
# its sums in float64; the port's sums Kahan-corrected float32): each site
# term differs by float32 round-off, ~1e-7 of terms up to |log 2| and pi, so
# 12 sites give log psi gaps of ~1e-6 (2e-5 bounds them), ratios of psi
# relative gaps of the same size (E_loc: 2e-5 of the largest |E_loc|), and the
# gradient, a mean of products of those over the samples, 1e-4 of each
# leaf's largest entry, as the real cells' reference tests hold.


@pytest.mark.parametrize("seed", SEEDS)
def test_log_psi_matches_the_ports_plain_path(seed):
    ansatz, params, samples = _set_up(seed)
    re, im = crnn_chain.log_psi(params, samples)
    want_re, want_im = ansatz.log_amp_parts(samples)
    assert re.dtype == im.dtype == torch.float64
    assert torch.allclose(re, want_re.double(), atol=2e-5, rtol=0)
    assert torch.allclose(im, want_im.double(), atol=2e-5, rtol=0)
    assert torch.equal(crnn_chain.log_prob(params, samples), 2.0 * re)


@pytest.mark.parametrize("seed", SEEDS)
def test_complex_local_energy_matches_the_ports_plain_path(seed):
    ansatz, params, samples = _set_up(seed)
    e, lp = j1j2.local_energy(crnn_chain, params, samples, TERMS)
    want = _port_e_loc(ansatz, samples)
    assert e.dtype == torch.complex128 and bool((e.imag != 0).any())
    assert torch.allclose(e, want, atol=2e-5 * float(want.abs().max()), rtol=0)
    assert torch.allclose(lp, 2.0 * ansatz.log_amp_parts(samples)[0].double(), atol=4e-5,
                          rtol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_complex_loss_gradient_matches_the_ports_leaf_by_leaf(seed):
    ansatz, params, samples = _set_up(seed)
    e, _ = j1j2.local_energy(crnn_chain, params, samples, TERMS)
    got = vmc_complex.loss_gradient(crnn_chain, params, samples, e)
    e_re, e_im = e.real.float(), e.imag.float()
    ansatz.zero_grad()
    la_re, la_im = ansatz.log_amp_parts(samples)
    surrogate_loss(la_re, la_im, e_re, e_im, e_re.mean(), e_im.mean()).backward()
    for k, p in ansatz.named_parameters():
        assert float(p.grad.abs().max()) > 0, k
        assert torch.allclose(got[k], p.grad, atol=1e-4 * float(p.grad.abs().max()), rtol=0), k


def _sector(n):
    """Every zero-magnetisation chain of n sites, (C(n, n/2), n) int32, and
    its index in the basis of ``ed.exact`` (bit i is site i)."""
    rows = [[1 if i in ones else 0 for i in range(n)]
            for ones in itertools.combinations(range(n), n // 2)]
    samples = torch.tensor(rows, dtype=torch.int32)
    index = (samples.long() * (1 << torch.arange(n))).sum(1)
    return samples, index


@pytest.mark.parametrize("marshall_sign", [True, False])
def test_reference_energy_over_the_sector_is_the_exact_expectation(marshall_sign):
    """Over the exact U(1) distribution at N=8, sum p E_loc is
    <psi|H|psi>/<psi|psi> from the dense Hamiltonian: the reference in
    float64, so the two agree to round-off."""
    n = 8
    ansatz = CRNNU1(n, (U,), impl="plain", device="cpu")
    params = {k: v.double() for k, v in make_weights(ansatz, SEEDS[0]).items()}
    gen = torch.Generator().manual_seed(9)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen, dtype=torch.float64)
              for k, v in params.items()}
    samples, index = _sector(n)
    terms = {**TERMS, "marshall_sign": marshall_sign}
    e, lp = j1j2.local_energy(crnn_chain, params, samples, terms)
    p = torch.exp(lp)
    assert float(p.sum()) == pytest.approx(1.0, abs=1e-12)  # the mask keeps psi normalised
    re, im = crnn_chain.log_psi(params, samples)
    psi = np.zeros(1 << n, dtype=np.complex128)
    psi[index.numpy()] = torch.exp(torch.complex(re, im)).numpy()
    h = exact.j1j2_dense(n, j1=1.0, j2=0.2, marshall_sign=marshall_sign)
    want = np.vdot(psi, h @ psi) / np.vdot(psi, psi)
    got = complex((p * e).sum())
    assert got.real == pytest.approx(want.real, abs=1e-10)
    assert abs(got.imag) < 1e-10 and abs(want.imag) < 1e-12


def test_one_adam_update_of_the_reference_matches_the_ports_update():
    seed = SEEDS[1]
    ansatz, params, samples = _set_up(seed)
    lr = 5e-4
    trainer = VMCTrainer(ansatz, J1J2(N, j2=0.2, marshall_sign=True),
                         TrainConfig(num_samples=S, learning_rate=lr, seed=seed))
    state = trainer.init()
    with torch.no_grad():
        for k, p in ansatz.named_parameters():
            p.copy_(params[k])
    e = _port_e_loc(ansatz, samples)
    trainer._update(state, samples, e.real.float(), e.imag.float())
    lr32 = float(torch.tensor(lr, dtype=torch.float32))
    direction = vmc_complex.loss_gradient(crnn_chain, params, samples, e)
    stepped = vmc_complex.Adam(params, lr32).step(params, direction)
    for k, p in ansatz.named_parameters():
        moved = (p.detach() - params[k]).abs()
        assert float(moved.max()) > 0.5 * lr, k
        # Adam's first step is lr g / (|g| + eps): a gradient gap of ~1e-6 of
        # the leaf moves it by ~1e-6 lr, except where |g| is near eps
        assert torch.allclose(p.detach(), stepped[k], atol=1e-3 * lr, rtol=0), k


@pytest.mark.parametrize("n", [4, 6, 8])
def test_work_counts_the_sectors_mean_anti_aligned_pairs_and_suffixes(n):
    samples, _ = _sector(n)
    s = samples.long()
    nn, nnn = s[:, 1:] != s[:, :-1], s[:, 2:] != s[:, :-2]
    mean_pairs = float((nn.sum(1) + nnn.sum(1)).double().mean())
    assert work.expected_anti_aligned(n) == pytest.approx(mean_pairs, rel=1e-12)
    # the suffix of a pair starting at a runs N - 1 - a sites
    lengths = n - 1 - torch.arange(n)
    suffix = (nn * lengths[:n - 1]).sum(1) + (nnn * lengths[:n - 2]).sum(1)
    assert work.expected_suffix_sites(n) == pytest.approx(float(suffix.double().mean()),
                                                          rel=1e-12)


def test_work_counts_the_models_parameters_and_reads_the_cell():
    model = CRNNU1(N, (50,), device="cpu")
    assert work.crnn_params(50) == sum(p.numel() for p in model.parameters())
    cell = load_cell(CELL)
    least = roofline.least_s(roofline.step_work(cell.config, cell.traffic))
    assert sorted(least) == ["estimator", "gradient", "optimizer"]
    assert all(v > 0 for v in least.values())
    # at 1000 sites the suffixes are ~N/2 site steps per site of the base pass
    assert least["estimator"] > 100 * least["gradient"]


def test_the_cell_resolves_every_file():
    spec = load_spec()
    workload = {w["name"]: w for w in spec["workloads"]}[CELL]
    entry = {c["name"]: c for c in spec["configs"]}[workload["config"]]
    assert (ROOT / entry["file"]).is_file()
    assert (BENCH_DIR / "traffic" / f"{workload['traffic']}.json").is_file()
    assert (BENCH_DIR / "limits" / f"{CELL}.json").is_file()
    cell = load_cell(CELL)
    assert cell.chips == 1
    assert cell.config["program"]["ansatz"] == "CRNNU1"
    assert cell.traffic["lattice"] == {"num_sites": 1000} and cell.traffic["num_samples"] == 64
    ref = check.reference_of(cell.config)
    assert (ref.model, ref.hamiltonian, ref.vmc) == (crnn_chain, j1j2, vmc_complex)
    assert set(cell.limits) == {"logp_gap", "eloc_gap", "energy_gap", "grad_gap",
                                "update_gap", "nonfinite"}
    names = [m["name"] for m in cell.per_layer]
    assert "gradient_forward_ms_per_step" in names and "minsr_ms_per_step" not in names
    for name in names:
        assert callable(metric_reader(name))


def _small_cell():
    cell = load_cell(CELL)
    traffic = {**cell.traffic, "lattice": {"num_sites": N}, "num_samples": S, "log_every": 3,
               "warmup_blocks": 0}
    return dataclasses.replace(cell, traffic=traffic)


@pytest.mark.parametrize("seed", [2**31 + 7, 3 * 10**9 + 11])
def test_a_cut_down_cell_runs_set_up_window_and_check(seed):
    """N=12, S=16 on the plain path: set-up records 3 updates, a short
    window runs, and ``check.decide`` holds the program to the cell's own
    limits."""
    cell = _small_cell()
    trainer, state, record = run.set_up(cell, seed, "cpu")
    assert len(record.samples) == 3 and record.e_loc[0].is_complex()
    assert all(bool((s.sum(1) == N // 2).all()) for s in record.samples)
    window = run.run_window(trainer, state, 0.3, cell.traffic["log_every"], lambda: None)
    assert window.steps > 0 and all(math.isfinite(abs(e)) for e in window.energies)
    verdict = check.decide(cell.config, cell.traffic, record, window.energies, cell.limits)
    assert verdict.correct, verdict.lines()


def test_a_fault_in_the_cut_down_cell_is_caught():
    """One drawn spin flipped leaves the U(1) sector: the reference reads a
    finite, far larger log p gap."""
    cell = _small_cell()
    _, _, record = run.set_up(cell, SEEDS[0], "cpu", FAULTS["altered"])
    verdict = check.decide(cell.config, cell.traffic, record, [], cell.limits)
    assert not verdict.correct
    assert math.isfinite(verdict.values["logp_gap"])
    assert verdict.values["logp_gap"] > 1e3 * cell.limits["logp_gap"]


FORBIDDEN = {"jax", "jaxlib", "flax", "rnnwavefunctions_tpu", "rnnwavefunctions_tpu_torch"}


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_no_reference_module_imports_jax_or_the_port(path):
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & FORBIDDEN
