"""PyTorch port: the kernel wrappers' shared contract, ``ops/launch.py``, on
the CPU.  The key draw against the expression checkpoints were written
with; the launch path, the launch counts and every wrapper's card path with
the kernel library, the device guard and the stream faked (this build of
PyTorch has no CUDA)."""

import contextlib
import ctypes
import sys
import types

import pytest
import torch

from rnnwavefunctions_tpu_torch.ops import build, launch


def test_draw_key_is_the_generators_pair_of_words():
    """``draw_key`` takes the pair that the trainer and the models drew
    inline, and leaves the generator where that draw left it, so runs and
    resumed checkpoints draw the same keys."""
    got, want = torch.Generator().manual_seed(123), torch.Generator().manual_seed(123)
    for _ in range(5):
        key = launch.draw_key(got)
        inline = torch.randint(0, 2**32, (2,), generator=want, dtype=torch.int64).tolist()
        assert key == tuple(inline)
        assert all(0 <= word < 2**32 for word in key)
        assert torch.equal(got.get_state(), want.get_state())


@pytest.fixture
def fake_card(monkeypatch):
    """A kernel library whose entry points record their arguments and
    return 7 (a CUDA error) for ``rnnwf_refused``, 0 otherwise; the device
    guard records its device and the stream handle is 99."""
    calls, devices = [], []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 7 if name == "rnnwf_refused" else 0
            return entry

    @contextlib.contextmanager
    def guard(device):
        devices.append(device)
        yield

    monkeypatch.setattr(launch, "load_library", lambda: types.SimpleNamespace(lib=Lib()))
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(launch, "stream_of", lambda device: 99)
    return calls, devices


def test_launch_passes_its_arguments_in_order_and_raises_on_an_error(fake_card):
    calls, devices = fake_card
    t, u = torch.zeros(3), torch.ones(2)
    launch.launch("rnnwf_ok", "cuda:1", t, None, 5, 2.5, u)
    assert calls == [("rnnwf_ok", (t.data_ptr(), None, 5, 2.5, u.data_ptr(), 99))]
    assert devices == ["cuda:1"]
    launch.call("rnnwf_query", "cuda:0", 4, t)  # a query takes no stream
    assert calls[-1] == ("rnnwf_query", (4, t.data_ptr()))
    with pytest.raises(RuntimeError, match="rnnwf_refused: CUDA error 7"):
        launch.launch("rnnwf_refused", "cuda:0", t)


def test_counts_launches_counts_calls_that_launched(fake_card):
    """A call counts once however many kernels it launches, in the
    innermost counted wrapper; a call that launches nothing (the CPU path)
    or is refused counts nothing; a wrapper's twin counts in its owner."""

    @launch.counts_launches()
    def inner(on_card, kernels=1, name="rnnwf_ok"):
        for _ in range(kernels if on_card else 0):
            launch.launch(name, "cuda:0")

    @launch.counts_launches()
    def outer(on_card, own):
        if own:
            launch.launch("rnnwf_ok", "cuda:0")
        inner(on_card)

    @launch.counts_launches(inner)
    def twin(on_card):
        inner.__wrapped__(on_card, kernels=2)

    inner(False)
    assert inner.launches == 0
    inner(True, kernels=3)
    assert inner.launches == 1
    with pytest.raises(RuntimeError):
        inner(True, name="rnnwf_refused")
    assert inner.launches == 1
    outer(True, own=False)
    assert (outer.launches, inner.launches) == (0, 2)
    outer(True, own=True)
    assert (outer.launches, inner.launches) == (1, 3)
    twin(True)
    assert inner.launches == 4 and not hasattr(twin, "launches")
    inner.launches = 0  # a caller may reset a count
    inner(True)
    assert inner.launches == 1


# every counted wrapper's card path, on CPU tensors with the device checks and
# the launch's C call faked: (the wrapper whose count moves, the call)
def _card_calls():
    from rnnwavefunctions_tpu_torch import CRNNU1, MDRNN2D, PRNN1D
    from rnnwavefunctions_tpu_torch.ops import (
        fused_crnn, fused_crnn_bwd, fused_gru, fused_gru_bwd, fused_jac, fused_mdrnn,
        fused_mdrnn_bwd, sr_cg)
    from rnnwavefunctions_tpu_torch.ops import j1j2_exchange_kernel as jk
    from rnnwavefunctions_tpu_torch.ops import mdrnn_flip_kernel as mk
    from rnnwavefunctions_tpu_torch.ops import tfim_flip_kernel as tk

    gen = torch.Generator().manual_seed(0)
    wp = tuple(w.detach() for w in PRNN1D(5, (8,), device="cpu").init(gen).weights())
    wc = tuple(w.detach() for w in CRNNU1(6, (8,), device="cpu").init(gen).weights())
    wm = tuple(w.detach() for w in MDRNN2D(2, 3, 8, device="cpu").init(gen).weights())
    s = torch.randint(0, 2, (3, 5), generator=gen, dtype=torch.int32)
    sc = torch.tensor([[0, 1] * 3, [1, 0] * 3], dtype=torch.int32)
    sm = torch.randint(0, 2, (3, 2, 3), generator=gen, dtype=torch.int32)
    g, g2 = torch.ones(3), torch.ones(2)
    hist, douts = torch.zeros(2, 6, 8), torch.zeros(2, 2, 6, 8)
    exch = dict(u1=True, el_nn=0.5, el_nnn=0.1, has_nnn=True)
    return {
        "K1": (fused_gru.gru_log_prob, lambda: fused_gru.gru_log_prob(wp, s)),
        "K1 storing": (fused_gru.gru_log_prob, lambda: fused_gru.gru_log_prob(wp, s, True)),
        "B5": (fused_gru.gru_sample, lambda: fused_gru.gru_sample(wp, 3, 5, 1, 2)),
        "K2": (fused_gru_bwd.gru_log_prob_bwd,
               lambda: fused_gru_bwd.gru_log_prob_bwd(wp, s, g)),
        "K2 from the replay": (fused_gru_bwd.gru_log_prob_bwd,
                               lambda: fused_gru_bwd.gru_log_prob_bwd(
                                   wp, s, g, replay=fused_gru.replay_plain(wp, s))),
        "K2 stages": (fused_gru_bwd.gru_log_prob_bwd,
                      lambda: fused_gru_bwd.gru_log_prob_bwd_stages(wp, s, g)),
        "K3": (tk.tfim_sample_and_flip_sum, lambda: tk.tfim_sample_and_flip_sum(wp, 3, 5, 1, 2)),
        "K4": (tk.tfim_flip_ratio_sum, lambda: tk.tfim_flip_ratio_sum(wp, s)),
        "B6a": (tk.tfim_flip_log_probs, lambda: tk.tfim_flip_log_probs(wp, s)),
        "B6b": (tk.tfim_sample_and_flip_log_probs,
                lambda: tk.tfim_sample_and_flip_sum(wp, 3, 5, 1, 2, per_flip=True)),
        "B7": (fused_crnn.crnn_log_amp_parts,
               lambda: fused_crnn.crnn_log_amp_parts(wc, sc, True)),
        "B9's replay": (fused_crnn.crnn_replay, lambda: fused_crnn.crnn_replay(wc, sc, True)),
        "B8": (fused_crnn.crnn_sample, lambda: fused_crnn.crnn_sample(wc, 2, 6, 1, 2, True)),
        "B9": (fused_crnn_bwd.crnn_log_amp_bwd,
               lambda: fused_crnn_bwd.crnn_log_amp_bwd(wc, sc, g2, g2, True)),
        "B9 stages": (fused_crnn_bwd.crnn_log_amp_bwd,
                      lambda: fused_crnn_bwd.crnn_log_amp_bwd_stages(wc, sc, g2, g2, True)),
        "B10": (jk.j1j2_exchange_offdiag, lambda: jk.j1j2_exchange_offdiag(wc, sc, **exch)),
        "B11": (jk.j1j2_sample_and_exchange,
                lambda: jk.j1j2_sample_and_exchange(wc, 2, 6, 1, 2, **exch)),
        "B12": (fused_mdrnn.mdrnn_log_prob, lambda: fused_mdrnn.mdrnn_log_prob(wm, sm, True)),
        "B13": (fused_mdrnn.mdrnn_sample, lambda: fused_mdrnn.mdrnn_sample(wm, 3, 2, 3, 1, 2)),
        "B14": (fused_mdrnn_bwd.mdrnn_log_prob_bwd,
                lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd(wm, sm, g)),
        "B14 stages": (fused_mdrnn_bwd.mdrnn_log_prob_bwd,
                       lambda: fused_mdrnn_bwd.mdrnn_log_prob_bwd_stages(wm, sm, g)),
        "B15": (mk.mdrnn_flip_ratio_sum, lambda: mk.mdrnn_flip_ratio_sum(wm, sm)),
        "B16": (mk.mdrnn_sample_and_flip_sum,
                lambda: mk.mdrnn_sample_and_flip_sum(wm, 3, 2, 3, 1, 2)),
        "B17": (fused_jac.jac_sweep, lambda: fused_jac.jac_sweep(wp, s)),
        "B19": (fused_jac.rollout_hist, lambda: fused_jac.rollout_hist(wc[:4], sc, True)),
        "B20": (fused_jac.sweep_dgates, lambda: fused_jac.sweep_dgates(wc[:4], sc, hist, douts)),
        "B21": (sr_cg.sr_cg_solve, lambda: sr_cg.sr_cg_solve(torch.eye(4), torch.ones(4))),
    }


CARD_CALLS = ("K1", "K1 storing", "B5", "K2", "K2 from the replay", "K2 stages", "K3", "K4",
              "B6a", "B6b", "B7", "B9's replay", "B8", "B9", "B9 stages", "B10", "B11", "B12",
              "B13", "B14", "B14 stages", "B15", "B16", "B17", "B19", "B20", "B21")


@pytest.mark.parametrize("kernel", CARD_CALLS)
def test_card_path_passes_each_entry_point_its_c_arguments(monkeypatch, kernel):
    """Each wrapper's card path, run on CPU tensors with the device checks
    and the C call faked: every launch passes its entry point exactly the
    arguments ``build.SIGNATURES`` declares, of the declared kinds (tensors
    or None for pointers), the stream last; the wrapper counts one call."""
    import ctypes
    import sys

    from rnnwavefunctions_tpu_torch.ops import build

    calls = _card_calls()
    assert sorted(calls) == sorted(CARD_CALLS)
    owner, run = calls[kernel]
    for name, module in list(sys.modules.items()):
        if name.startswith("rnnwavefunctions_tpu_torch.ops.") and hasattr(module, "is_cpu_call"):
            monkeypatch.setattr(module, "is_cpu_call", lambda *tensors: False)
    queries = types.SimpleNamespace(**{
        f"rnnwf_{kind}_bwd_partial_floats": lambda b, n, u: 7 for kind in ("gru", "crnn", "mdrnn")
    }, rnnwf_j1j2_num_bonds=lambda n, nnn, periodic: 2 * n)
    for module in ("fused_gru_bwd", "fused_crnn_bwd", "fused_mdrnn_bwd", "j1j2_exchange_kernel"):
        monkeypatch.setattr(sys.modules[f"rnnwavefunctions_tpu_torch.ops.{module}"],
                            "load_library", lambda: types.SimpleNamespace(lib=queries))
    monkeypatch.setattr(launch, "stream_of", lambda device: 99)
    launched = []

    def fake_call(name, device, *args):
        argtypes = build.SIGNATURES[name][0]
        assert len(args) == len(argtypes), (name, len(args), len(argtypes))
        for a, kind in zip(args, argtypes):
            if kind is ctypes.c_void_p:
                assert a is None or isinstance(a, torch.Tensor) or a == 99, (name, a)
            elif kind is ctypes.c_float:
                assert isinstance(a, float), (name, a)
            elif kind in (ctypes.c_int, ctypes.c_uint, ctypes.c_longlong):
                assert isinstance(a, int) and not isinstance(a, bool), (name, a)
        launched.append(name)

    monkeypatch.setattr(launch, "call", fake_call)
    monkeypatch.setattr(sys.modules["rnnwavefunctions_tpu_torch.ops.mdrnn_flip_kernel"],
                        "call", lambda name, device, *args: None)
    monkeypatch.setattr(owner, "launches", 0)  # the other tests' counts stay as they were
    run()
    assert launched
    assert owner.launches == 1
