"""PyTorch port: the 2D MDRNN — B12 (log p), B13 (sampler), B14 (its VJP),
B15/B16 (the flip-ratio sum), MDRNN2D, its estimator and training — held on
the CPU against the JAX package's jnp path and its Pallas kernels in
interpret mode.  On a CPU tensor every wrapper runs its plain version; the
kernels themselves are checked on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Tolerances: log p 1e-5 per site (f32 recurrences summed in another order;
the jnp path sums in lattice order, the kernels in visit order, both
compensated), gradients 1e-4 of the largest entry.  The port's plain
versions hold the kernels' activation ``exp(min(pre, 0)) - 1``, the jnp path
``jax.nn.elu`` (expm1): they differ by f32 rounding only."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rnnwavefunctions_tpu.hamiltonians.tfim2d import TFIM2D as JTFIM2D
from rnnwavefunctions_tpu.models.mdrnn2d import MDRNN2D as JMDRNN2D
from rnnwavefunctions_tpu.ops import fused_mdrnn as jfused_mdrnn
from rnnwavefunctions_tpu.ops import mdrnn_flip_kernel as jmk
from rnnwavefunctions_tpu.ops.fused_mdrnn_bwd import mdrnn_log_prob_bwd as jmdrnn_log_prob_bwd
from rnnwavefunctions_tpu.vmc import local_energy as jle
from rnnwavefunctions_tpu.vmc.loss import surrogate_loss as jsurrogate_loss
from rnnwavefunctions_tpu_torch import MDRNN2D, TFIM2D, TrainConfig, VMCTrainer, interop
from rnnwavefunctions_tpu_torch.ed import exact
from rnnwavefunctions_tpu_torch.models import cells
from rnnwavefunctions_tpu_torch.ops import fused_mdrnn, fused_mdrnn_bwd
from rnnwavefunctions_tpu_torch.ops import mdrnn_flip_kernel as mk
from rnnwavefunctions_tpu_torch.vmc import local_energy

torch.set_num_threads(1)

U, B = 8, 37
SHAPES = [(3, 3), (4, 3), (3, 4), (2, 5)]
IDS = ["3x3", "4x3", "3x4", "2x5"]
NAMES = (("cell", "uh"), ("cell", "uv"), ("cell", "wh"), ("cell", "wv"), ("cell", "b"),
         ("head", "w"), ("head", "b"))


def _pair(nx, ny, units=U, seed=0, local_dim=2):
    """A JAX MDRNN2D with its params and the port's MDRNN2D holding the same
    parameters (JAX-initialised, every tensor perturbed so the biases are
    not zero)."""
    jans = JMDRNN2D(nx=nx, ny=ny, units=units, local_dim=local_dim, impl="jnp")
    params = jans.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    model = MDRNN2D(nx, ny, units, local_dim=local_dim, device="cpu")
    interop.load_params(model, jax.tree.map(np.asarray, params))
    return jans, params, model


def _samples(b, nx, ny, seed=1, d=2):
    return np.random.default_rng(seed).integers(0, d, (b, nx, ny)).astype(np.int32)


def _weights(model):
    return tuple(w.detach() for w in model.weights())


def _close_rel(got, want, rel=1e-4):
    """Agreement to ``rel`` of the largest entry (f32 sums in another order)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _lattice_basis(nx, ny):
    """All 2^(Nx Ny) configurations as (S, Nx, Ny) grids; code bit y*Nx + x
    is the spin at (x, y) (the y-major basis of ``tfim2d_dense``)."""
    n = nx * ny
    codes = np.arange(1 << n)
    flat = ((codes[:, None] >> np.arange(n)) & 1).astype(np.int32)
    return np.ascontiguousarray(np.transpose(flat.reshape(-1, ny, nx), (0, 2, 1)))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_b12_plain_matches_jnp_and_pallas_interpret(shape):
    nx, ny = shape
    jans, params, model = _pair(nx, ny)
    samples = _samples(B, nx, ny)
    got = fused_mdrnn.mdrnn_log_prob(_weights(model), torch.from_numpy(samples)).numpy()
    tol = 1e-5 * nx * ny
    want = np.asarray(jans._log_prob_jnp(params, jnp.asarray(samples)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jfused_mdrnn.mdrnn_log_prob(params, jnp.asarray(samples), nx, ny))
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=0)
    np.testing.assert_allclose(model.log_prob(torch.from_numpy(samples)).detach().numpy(), got,
                               atol=0, rtol=0)
    assert fused_mdrnn.mdrnn_log_prob.launches == 0  # the CPU path launches nothing


def test_b14_autograd_matches_jax_grad_and_pallas_interpret():
    nx, ny = 3, 4
    jans, params, model = _pair(nx, ny, seed=2)
    samples = _samples(B, nx, ny, seed=3)
    g = np.random.default_rng(4).standard_normal(B).astype(np.float32)
    ts = torch.from_numpy(samples)
    (torch.from_numpy(g) * model.log_amp(ts)).sum().backward()
    got = [getattr(getattr(model, m), k).grad.numpy() for m, k in NAMES]
    js = jnp.asarray(samples)
    want = jax.grad(lambda p: jnp.sum(g * jans.log_amp(p, js)))(params)
    with pltpu.force_tpu_interpret_mode():
        pallas = jmdrnn_log_prob_bwd(params, js, jnp.asarray(0.5 * g), nx, ny)
    ops = fused_mdrnn_bwd.mdrnn_log_prob_bwd(_weights(model), ts, torch.from_numpy(0.5 * g))
    for i, (m, k) in enumerate(NAMES):
        _close_rel(got[i], np.asarray(want[m][k]))
        _close_rel(got[i], np.asarray(pallas[m][k]))
        _close_rel(ops[i].numpy(), got[i], rel=1e-6)
    assert fused_mdrnn_bwd.mdrnn_log_prob_bwd.launches == 0


def test_autograd_function_matches_plain_autograd():
    """The Function (B12 forward, B14 backward) and autograd through the
    plain sweep give the same values and gradients."""
    nx, ny = 4, 3
    _, _, model = _pair(nx, ny, seed=5)
    s = torch.from_numpy(_samples(B, nx, ny, seed=6))
    g = torch.randn(B, generator=torch.Generator().manual_seed(7))
    ws = [w.detach().requires_grad_(True) for w in model.weights()]
    lp = fused_mdrnn.log_prob(ws, s)
    (g * lp).sum().backward()
    want = fused_mdrnn.log_prob_bwd_plain(_weights(model), s, g)
    torch.testing.assert_close(lp.detach(), fused_mdrnn.log_prob_plain(_weights(model), s),
                               atol=0, rtol=0)
    for w, d in zip(ws, want):
        torch.testing.assert_close(w.grad, d, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 4), (4, 3), (1, 5), (5, 1)], ids=["3x4", "4x3", "1x5", "5x1"])
def test_b15_plain_matches_explicit_flips(shape):
    """Every flip's log p against the teacher-forced log p of the explicitly
    flipped lattice, flip by flip (a flip wired wrongly at the end of a row,
    where it becomes the vertical input of the site below, shows here), and
    the ratio sum against their sum.  1-wide lattices are chains."""
    nx, ny = shape
    _, _, model = _pair(nx, ny, seed=8)
    w = _weights(model)
    s = torch.from_numpy(_samples(B, nx, ny, seed=9))
    spins, lp, hist, pfx = mk.base_pass_plain(w, nx, ny, samples=s)
    lpf = mk.flip_log_probs_plain(w, spins, hist, pfx, nx, ny)
    xx, yy = fused_mdrnn.visit_order(nx, ny)
    for f in range(nx * ny):
        flipped = s.clone()
        flipped[:, xx[f], yy[f]] = 1 - flipped[:, xx[f], yy[f]]
        want = fused_mdrnn.log_prob_plain(w, flipped)
        torch.testing.assert_close(lpf[:, f], want, atol=1e-5 * nx * ny, rtol=0)
    ratio, lp15 = mk.mdrnn_flip_ratio_sum(w, s)
    torch.testing.assert_close(lp15, lp, atol=0, rtol=0)
    want_ratio = torch.exp(0.5 * (lpf - lp[:, None])).sum(dim=1)
    torch.testing.assert_close(ratio, want_ratio, rtol=1e-5, atol=0)
    assert mk.mdrnn_flip_ratio_sum.launches == 0


@pytest.mark.parametrize("shape", [(3, 4), (4, 3)], ids=["3x4", "4x3"])
def test_b15_plain_matches_pallas_interpret(shape):
    nx, ny = shape
    jans, params, model = _pair(nx, ny, seed=10)
    samples = _samples(B, nx, ny, seed=11)
    ratio, lp = mk.mdrnn_flip_ratio_sum(_weights(model), torch.from_numpy(samples))
    with pltpu.force_tpu_interpret_mode():
        j_ratio, j_lp = jmk.mdrnn_flip_ratio_sum(params, jnp.asarray(samples), nx, ny)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-5 * nx * ny, rtol=0)
    np.testing.assert_allclose(ratio.numpy(), np.asarray(j_ratio), rtol=1e-4)


def test_b13_and_b16_plain_samplers():
    """The log p a sampler returns is the teacher-forced one; B16's ratio is
    B15's on its own samples; B13 and B16 draw the same lattices; the draws
    are a function of (seed, offset)."""
    nx, ny = 3, 4
    _, _, model = _pair(nx, ny, seed=12)
    w = _weights(model)
    s13, lp13 = fused_mdrnn.mdrnn_sample(w, B, nx, ny, 7, 3)
    assert s13.shape == (B, nx, ny) and s13.dtype == torch.int32
    torch.testing.assert_close(lp13, fused_mdrnn.log_prob_plain(w, s13), atol=0, rtol=0)
    s16, lp16, r16 = mk.mdrnn_sample_and_flip_sum(w, B, nx, ny, 7, 3)
    assert torch.equal(s16, s13)
    torch.testing.assert_close(lp16, lp13, atol=0, rtol=0)
    r15, _ = mk.mdrnn_flip_ratio_sum(w, s16)
    torch.testing.assert_close(r16, r15, atol=0, rtol=0)
    assert torch.equal(fused_mdrnn.mdrnn_sample(w, B, nx, ny, 7, 3)[0], s13)
    assert not torch.equal(fused_mdrnn.mdrnn_sample(w, B, nx, ny, 7, 4)[0], s13)
    with pytest.raises(ValueError, match="seed and offset"):
        fused_mdrnn.mdrnn_sample(w, B, nx, ny, -1, 0)
    assert fused_mdrnn.mdrnn_sample.launches == mk.mdrnn_sample_and_flip_sum.launches == 0


def test_sampler_frequencies_match_exact_density():
    """At 2x2 the frequencies of 20k draws from fed uniforms match the exact
    density of the JAX model over the 16 lattices within 0.02."""
    nx, ny, draws = 2, 2, 20000
    jans, params, model = _pair(nx, ny, seed=13)
    uni = torch.rand(draws, nx * ny, generator=torch.Generator().manual_seed(14))
    samples, _ = fused_mdrnn.sample_plain(_weights(model), uni, nx, ny)
    codes = np.transpose(samples.numpy(), (0, 2, 1)).reshape(draws, -1) @ (2 ** np.arange(4))
    freq = np.bincount(codes, minlength=16) / draws
    probs = np.exp(np.asarray(jans.log_prob(params, jnp.asarray(_lattice_basis(nx, ny)))))
    np.testing.assert_allclose(probs.sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(freq, probs, atol=0.02)
    # the model's own sampler draws the same way
    s2, lp2 = model.sample_with_log_prob(64, torch.Generator().manual_seed(15))
    torch.testing.assert_close(lp2, model.log_prob(s2).detach(), atol=1e-5 * 4, rtol=0)


def test_generic_estimator_matches_jax_and_dense():
    """The port's generic estimator on an impl="plain" MDRNN against the JAX
    package's on the same samples, and the dense-H brute force."""
    nx, ny, bx = 2, 3, 0.9
    jans, params, model = _pair(nx, ny, units=6, seed=16)
    model.impl = "plain"
    ham = TFIM2D(nx, ny, bx=bx, encoding="grid")
    samples = _samples(16, nx, ny, seed=17)
    ts = torch.from_numpy(samples)
    le = local_energy.make_local_energy_fn(model, ham)
    assert le.needs_log_amp
    got = le(ts, model.log_amp(ts).detach())[0].numpy()
    jham = JTFIM2D(nx=nx, ny=ny, bx=bx, encoding="grid")
    js = jnp.asarray(samples)
    want = np.asarray(jle.make_local_energy_fn(jans, jham)(params, js, jans.log_amp(params, js))[0])
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    h = exact.tfim2d_dense(nx, ny, bx)
    la = model.log_amp(torch.from_numpy(_lattice_basis(nx, ny))).detach().numpy()
    dense = []
    for s in samples:
        code = int(np.transpose(s).reshape(-1) @ (2 ** np.arange(nx * ny)))
        col = h[:, code]
        nz = np.nonzero(col)[0]
        dense.append(np.sum(col[nz] * np.exp(la[nz] - la[code])))
    np.testing.assert_allclose(got, np.asarray(dense), rtol=2e-4)


def test_select_family_and_the_mdrnn_flip_path(monkeypatch):
    """None on the CPU; "mdrnn_flip" only when the ansatz runs its kernels
    (faked here: the wrappers then get CPU tensors and run B15/B16's plain
    versions), whose energies equal the generic estimator's."""
    nx, ny = 3, 3
    _, _, model = _pair(nx, ny, seed=18)
    ham = TFIM2D(nx, ny, bx=1.1, encoding="grid")
    assert local_energy._select_family(model, ham) is None
    assert local_energy.make_fused_sample_energy_fn(model, ham) is None
    generic = local_energy.make_local_energy_fn(model, ham)
    monkeypatch.setattr(model, "_use_kernels", lambda: True)
    assert local_energy._select_family(model, ham) == "mdrnn_flip"
    assert local_energy._select_family(model, TFIM2D(nx, ny, bx=1.1)) is None  # flat encoding
    assert local_energy._select_family(model, TFIM2D(nx, ny, bx=0.0, encoding="grid")) is None
    fused = local_energy.make_fused_sample_energy_fn(model, ham)
    samples, la, e, e_im = fused(B, 5, 6)
    assert e_im is None and samples.shape == (B, nx, ny)
    want, _, _ = generic(samples, model.log_amp(samples).detach())
    torch.testing.assert_close(e, want, rtol=1e-5, atol=1e-5)
    e15, _, la15 = local_energy.make_local_energy_fn(model, ham)(samples)
    torch.testing.assert_close(e15, e, atol=0, rtol=0)
    torch.testing.assert_close(la15, la, atol=0, rtol=0)


def test_local_dim3_plain_sweep_matches_jnp():
    nx, ny = 3, 2
    jans, params, model = _pair(nx, ny, seed=19, local_dim=3)
    samples = _samples(B, nx, ny, seed=20, d=3)
    got = model.log_prob(torch.from_numpy(samples)).detach().numpy()
    want = np.asarray(jans._log_prob_jnp(params, jnp.asarray(samples)))
    np.testing.assert_allclose(got, want, atol=1e-5 * nx * ny, rtol=0)
    s, lp = model.sample_with_log_prob(16, torch.Generator().manual_seed(21))
    assert int(s.max()) <= 2 and s.shape == (16, nx, ny)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jans._log_prob_jnp(params, jnp.asarray(s.numpy()))),
                               atol=1e-5 * nx * ny)
    assert not model._kernelizable()  # the kernels take two local states


def test_params_round_trip_and_shape_checks():
    params = JMDRNN2D(nx=3, ny=2, units=5, impl="jnp").init(jax.random.PRNGKey(22))
    tree = jax.tree.map(np.asarray, params)
    model = MDRNN2D(3, 2, 5, device="cpu")
    interop.load_params(model, tree)
    got, got_def = jax.tree.flatten(interop.params_to_numpy(model))
    want, want_def = jax.tree.flatten(tree)
    assert got_def == want_def
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="does not match"):
        interop.load_params(MDRNN2D(3, 2, 6, device="cpu"), tree)
    with pytest.raises(ValueError, match="7 weight tensors"):
        fused_mdrnn.check_weights(_weights(model)[:6])


def test_init_is_seeded_in_cell_then_head_order():
    a = MDRNN2D(3, 3, 16, device="cpu").init(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(3)
    draws = [cells.glorot_(torch.empty(*shape), gen)
             for shape in ((2, 16), (2, 16), (16, 16), (16, 16), (16, 2))]
    for got, want in zip((a.cell.uh, a.cell.uv, a.cell.wh, a.cell.wv, a.head.w), draws):
        assert torch.equal(got, want)
    assert float(a.cell.b.detach().abs().max()) == 0.0
    assert float(a.head.b.detach().abs().max()) == 0.0
    assert a.plain_positive and not a.is_complex


def test_default_device_and_dispatch_rules(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MDRNN2D(3, 3, 8)
    assert not MDRNN2D(3, 3, 8, device="cpu")._use_kernels()
    with pytest.raises(ValueError, match="CUDA"):
        MDRNN2D(3, 3, 8, impl="kernel", device="cpu")._use_kernels()
    with pytest.raises(ValueError, match="local_dim=2"):
        MDRNN2D(3, 3, 8, local_dim=3, impl="kernel", device="cpu")._use_kernels()
    assert MDRNN2D(16, 16, 50, device="cpu")._kernelizable()


# ---- the trainer on the MDRNN path


def test_two_updates_on_fed_samples_match_jax():
    """Estimator, loss, gradient and Adam, two steps on the same fed samples,
    reach the same parameters as the JAX package with optax."""
    nx, ny, b = 3, 2, 24
    jans, params, model = _pair(nx, ny, seed=23)
    jham = JTFIM2D(nx=nx, ny=ny, bx=1.0, encoding="grid")
    jenergy = jle.make_local_energy_fn(jans, jham)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)
    trainer = VMCTrainer(model, TFIM2D(nx, ny, bx=1.0, encoding="grid"), TrainConfig(num_samples=b))
    state = trainer.init()
    interop.load_params(trainer.ansatz, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(24)
    for _ in range(2):
        s = rng.integers(0, 2, (b, nx, ny)).astype(np.int32)
        js = jnp.asarray(s)
        e, _, _ = jenergy(params, js, jans.log_amp(params, js))
        e_mean = jnp.mean(e)
        grads = jax.grad(lambda p: jsurrogate_loss(
            jans.log_amp(p, js), None, e, None, e_mean, None))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ts = torch.from_numpy(s)
        e_port, _, _ = trainer.local_energy(ts, trainer.ansatz.log_amp(ts).detach())
        np.testing.assert_allclose(e_port.numpy(), np.asarray(e), rtol=1e-5, atol=1e-5)
        trainer._update(state, ts, e_port)
    for a, w in zip(jax.tree.leaves(interop.params_to_numpy(trainer.ansatz)),
                    jax.tree.leaves(params)):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-5)


def test_short_cpu_run_approaches_ed():
    nx, ny = 2, 2
    e_exact = exact.ground_state_energy(exact.tfim2d_dense(nx, ny, 1.0))
    trainer = VMCTrainer(MDRNN2D(nx, ny, 12, device="cpu"), TFIM2D(nx, ny, 1.0, encoding="grid"),
                         TrainConfig(num_samples=200, learning_rate=1e-2))
    state = trainer.init()
    state, ms = trainer.run_steps(state, 120)
    e_vmc = float(ms["mean_energy"][-20:].mean())
    assert abs(e_vmc - e_exact) / abs(e_exact) < 5e-2


def test_steps_are_reproducible_from_the_seed():
    def run():
        trainer = VMCTrainer(MDRNN2D(3, 2, 8, device="cpu"), TFIM2D(3, 2, 1.0, encoding="grid"),
                             TrainConfig(num_samples=32, seed=7))
        state = trainer.init()
        return trainer.run_steps(state, 3)[1]["mean_energy"]

    assert torch.equal(run(), run())
