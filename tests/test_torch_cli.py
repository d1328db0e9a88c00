"""PyTorch port: the 1D-TFIM entry points (``cli/run_1dtfim.py``, the loop
of ``cli/run_loop.py``, ``VMCTrainer.fit``, the metrics, checkpoints and
parameter summary, ``compat.run_1DTFIM``) on the CPU, held against the
JAX package's CLI and modules at its tests' tiny sizes (N=6, U=8, S=32)."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from rnnwavefunctions_tpu import compat as jcompat
from rnnwavefunctions_tpu.cli import run_1dtfim as jrun_1dtfim
from rnnwavefunctions_tpu_torch import PRNN1D, TFIM1D, TrainConfig, VMCTrainer, compat, interop
from rnnwavefunctions_tpu_torch.cli import run_1dtfim
from rnnwavefunctions_tpu_torch.cli.run_loop import run_training
from rnnwavefunctions_tpu_torch.utils.checkpoints import Checkpointer
from rnnwavefunctions_tpu_torch.utils.metrics import MetricsSeries
from rnnwavefunctions_tpu_torch.utils.summary import summarize_params
from rnnwavefunctions_tpu_torch.vmc.trainer import make_schedule

torch.set_num_threads(1)

TINY = ["--systemsize", "6", "--num-units", "8", "--numsamples", "32", "--num-devices", "1"]
TAG = "N6_samp32_Jz1Bx1.0_GRURNN_OBC_TFIM_units_8x1"


def _port(argv, workdir):
    return run_1dtfim.main(argv + TINY + ["--workdir", str(workdir), "--device", "cpu"])


def _artifacts(workdir):
    """The names in a run's directory, and each series' length."""
    names = sorted(os.listdir(workdir))
    lengths = {n: len(np.load(os.path.join(workdir, n))) for n in names if n.endswith(".npy")}
    steps = [json.loads(line)["step"] for n in names if n.endswith(".jsonl")
             for line in open(os.path.join(workdir, n))]
    return names, lengths, steps


def _latest(workdir):
    ckpt = Checkpointer(os.path.join(str(workdir), f"ckpt_{TAG}"), torch.nn.Module())
    return torch.load(ckpt.path(ckpt.latest_step()), weights_only=True)


@pytest.mark.parametrize("runs", [
    [["--numsteps", "12"]],
    [["--numsteps", "10"], ["--numsteps", "20", "--resume"]],
], ids=["fresh", "resumed"])
def test_artifacts_match_the_jax_cli(tmp_path, runs):
    """The same argv writes the same file names (series, JSONL log,
    checkpoint directory), series lengths and logged steps as the JAX CLI,
    each package in its own directory."""
    for argv in runs:
        mean_e, var_e = _port(argv, tmp_path / "port")
        jmean, jvar = jrun_1dtfim.main(argv + TINY + ["--workdir", str(tmp_path / "jax")])
        assert len(mean_e) == len(jmean) and len(var_e) == len(jvar)
        assert np.isfinite(mean_e).all() and np.isfinite(var_e).all()
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "jax")
    assert f"ckpt_{TAG}" in os.listdir(tmp_path / "port")


def _flags(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.choices, a.nargs, a.type)
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_parser_flags_match_the_jax_cli():
    """The JAX parser's flags, names and defaults, without the two that set
    TPU-only machinery and with --device."""
    got, want = _flags(run_1dtfim.build_parser()), _flags(jrun_1dtfim.build_parser())
    dropped = {"--jax-cache-dir", "--matmul-precision"}
    assert set(got) == set(want) - dropped | {"--device"}
    assert {k: got[k] for k in set(want) - dropped} == {k: want[k] for k in set(want) - dropped}
    assert got["--device"][1] is None


@pytest.mark.parametrize("flag,value,item", [
    ("--cell", "lstm", "A5"), ("--dtype", "float64", "A6"), ("--tp", "2", "A7"),
    ("--num-devices", "2", "A7"),
])
def test_refuses_what_is_not_ported(tmp_path, capsys, flag, value, item):
    with pytest.raises(SystemExit) as e:
        run_1dtfim.main(["--numsteps", "2", "--workdir", str(tmp_path), "--device", "cpu",
                         flag, value])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} {value} is not ported yet" in err and f"ROADMAP {item}" in err
    assert not os.listdir(tmp_path)  # refused before any work


@pytest.mark.parametrize("extra", [
    [], ["--schedule", "staged", "--lr-stage-bounds", "5", "15", "--lr-stage-scales", "0.5",
         "0.5"],
    ["--optimizer", "minsr", "--learningrate", "5e-2", "--schedule", "harmonic"],
], ids=["adam", "adam-staged", "minsr-harmonic"])
def test_resumed_run_equals_uninterrupted(tmp_path, extra):
    """20 steps, or 10 steps, a resume from the checkpoint and 10 more:
    the same series and parameters, bit for bit."""
    whole = _port(["--numsteps", "20"] + extra, tmp_path / "whole")
    _port(["--numsteps", "10"] + extra, tmp_path / "split")
    split = _port(["--numsteps", "20", "--resume"] + extra, tmp_path / "split")
    assert len(whole[0]) == 21
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for name in ("meanEnergy", "varEnergy"):
        np.testing.assert_array_equal(np.load(tmp_path / "whole" / f"{name}_{TAG}.npy"),
                                      np.load(tmp_path / "split" / f"{name}_{TAG}.npy"))
    a, b = _latest(tmp_path / "whole"), _latest(tmp_path / "split")
    assert a["step"] == b["step"] == 21
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert torch.equal(a["generator"], b["generator"])


def _tiny_trainer(config=TrainConfig(num_samples=32)):
    return VMCTrainer(PRNN1D(6, (8,), device="cpu"), TFIM1D(6, 1.0), config)


def test_ckpt_cadence_saves_exact_step(tmp_path):
    """With ckpt_every not a multiple of log_every, the checkpoint of loop
    index 25 holds exactly the state after 26 updates (blocks stop at
    checkpoint steps), the state a run of 25 loop indices ends in."""
    run_training(_tiny_trainer(), 27, str(tmp_path / "a"), "cadence", log_every=10,
                 save_every=10, ckpt_every=25)
    ckpt = Checkpointer(str(tmp_path / "a" / "ckpt_cadence"), torch.nn.Module())
    assert ckpt.all_steps() == [26, 28]
    trainer = _tiny_trainer()
    state, _, _ = run_training(trainer, 25, str(tmp_path / "b"), "cadence")
    saved = torch.load(ckpt.path(26), weights_only=True)
    assert saved["step"] == state.step == 26
    assert all(torch.equal(saved["params"][k], v) for k, v in trainer.ansatz.state_dict().items())


def test_checkpointer_keeps_the_newest_three(tmp_path):
    trainer = _tiny_trainer()
    state = trainer.init()
    ckpt = Checkpointer(str(tmp_path), trainer.ansatz)
    for _ in range(5):
        trainer.step(state)
        ckpt.save(state)
    assert ckpt.all_steps() == [3, 4, 5] and ckpt.latest_step() == 5
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    fresh = _tiny_trainer()
    restored = Checkpointer(str(tmp_path), fresh.ansatz).restore(fresh.init(), step=4)
    assert restored.step == 4
    with pytest.raises(ValueError, match="shape"):
        wide = VMCTrainer(PRNN1D(6, (9,), device="cpu"), TFIM1D(6, 1.0))
        Checkpointer(str(tmp_path), wide.ansatz).restore(wide.init())


def test_resume_from_adam_to_minsr(tmp_path, capsys):
    """Refining an Adam-trained wavefunction with minSR: the parameters, the
    generator and the step come back, the optimizer starts fresh (SGD), and
    the schedule reads the restored step."""
    _port(["--numsteps", "10"], tmp_path)
    adam = _latest(tmp_path)
    capsys.readouterr()
    mean_e, _ = _port(["--numsteps", "20", "--resume", "--optimizer", "minsr",
                       "--learningrate", "5e-2", "--schedule", "inverse"], tmp_path)
    assert "re-initialized the optimizer state" in capsys.readouterr().out
    assert len(mean_e) == 21 and np.isfinite(mean_e).all()
    minsr = _latest(tmp_path)
    assert adam["optimizer_kind"] == "Adam" and minsr["optimizer_kind"] == "SGD"
    lr = minsr["optimizer"]["param_groups"][0]["lr"]
    want = TrainConfig(learning_rate=5e-2, schedule="inverse")
    assert lr == make_schedule(want)(20)  # the last update's rate, counted from step 0
    # the minSR checkpoint restores whole under minSR
    trainer = VMCTrainer(PRNN1D(6, (8,), device="cpu"), TFIM1D(6, 1.0),
                         TrainConfig(num_samples=32, optimizer="minsr", learning_rate=5e-2,
                                     schedule="inverse"))
    ckpt = Checkpointer(os.path.join(str(tmp_path), f"ckpt_{TAG}"), trainer.ansatz)
    state = ckpt.restore(trainer.init())  # the minSR checkpoint, same kind
    assert state.step == 21


def test_metrics_resume_keeps_the_common_prefix(tmp_path):
    """A crash between the two .npy flushes leaves var shorter: the resume
    keeps both series to their common prefix, and truncation drops the JSONL
    records of steps trained again, as the JAX module does."""
    m = MetricsSeries(str(tmp_path), "t")
    for i in range(5):
        m.append(-float(i), 0.1 * i)
        m.log_jsonl(i)
    m.flush_npy()
    np.save(m.var_path, np.asarray(m.var_energy[:3]))
    r = MetricsSeries(str(tmp_path), "t", resume=True)
    assert r.mean_energy == [0.0, -1.0, -2.0] and r.step == 3
    r.truncate(2)
    assert [json.loads(line)["step"] for line in open(r._jsonl_path)] == [0, 1]
    MetricsSeries(str(tmp_path), "t")  # a fresh run starts a new log
    assert not os.path.exists(r._jsonl_path)


def test_summary_matches_the_jax_table():
    from rnnwavefunctions_tpu.models.prnn1d import PRNN1D as JPRNN1D
    from rnnwavefunctions_tpu.utils.summary import summarize_params as jsummarize

    import jax

    model = PRNN1D(6, (8,), device="cpu").init(torch.Generator().manual_seed(0))
    params = JPRNN1D(num_sites=6, units=(8,)).init(jax.random.PRNGKey(0))
    assert summarize_params(model) == jsummarize(params)
    assert summarize_params(model).endswith(f"{sum(p.numel() for p in model.parameters())}")
    assert interop.params_to_numpy(model)["head"]["w"].shape == (8, 2)


def test_fit_is_a_function_of_the_seed_and_steps():
    """``fit``'s series and parameters do not depend on its block size; the
    callback sees every log_every-th step."""
    seen = []
    a = _tiny_trainer()
    sa, mean_a, var_a = a.fit(23, log_every=10, callback=lambda k, m: seen.append(k))
    b = _tiny_trainer()
    sb, mean_b, var_b = b.fit(23, log_every=7)
    assert seen == [0, 10, 20] and len(mean_a) == 23 and sa.step == sb.step == 23
    assert mean_a == mean_b and var_a == var_b
    assert all(torch.equal(p, q) for p, q in zip(a.ansatz.parameters(), b.ansatz.parameters()))


def test_profile_dir_writes_one_trace(tmp_path):
    run_training(_tiny_trainer(), 12, str(tmp_path), "prof", profile_dir=str(tmp_path / "p"))
    assert os.listdir(tmp_path / "p") == ["trace_prof.json"]
    events = json.load(open(tmp_path / "p" / "trace_prof.json"))["traceEvents"]
    # the traced block's copy and its JSONL write are inside the trace
    assert {"rnnwf.readback", "rnnwf.cli.log"} <= {e.get("name") for e in events}


def test_compat_run_1dtfim(tmp_path):
    """The JAX function's names and defaults, plus a last ``device``; it
    returns arrays of numsteps + 1 entries."""
    got = list(inspect.signature(compat.run_1DTFIM).parameters.values())
    want = list(inspect.signature(jcompat.run_1DTFIM).parameters.values())
    assert [(p.name, p.default) for p in got[:-1]] == [(p.name, p.default) for p in want]
    assert (got[-1].name, got[-1].default) == ("device", None)
    assert not hasattr(compat, "run_J1J2")
    mean_e, var_e = compat.run_1DTFIM(numsteps=4, systemsize=6, num_units=8, numsamples=32,
                                      workdir=str(tmp_path), device="cpu")
    assert isinstance(mean_e, np.ndarray) and mean_e.shape == var_e.shape == (5,)
