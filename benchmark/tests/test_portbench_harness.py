"""The harness is driven by data, imports no JAX, refuses to run without a
card, and reduces a trace as ``trace.py`` says."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import trace
from benchmark.spec import ROOT, load_cell, load_spec, metric_reader


def _copy_checkout(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_config_traffic_metric_and_cell_are_found_by_name(tmp_path):
    root = _copy_checkout(tmp_path)
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "prnn1d_gru50_tfim1d.json").read_text())
    config.update(name="prnn1d_gru64_tfim1d", units=64)
    (bench / "configs" / "prnn1d_gru64_tfim1d.json").write_text(json.dumps(config))
    (bench / "traffic" / "chain_n50_s256_adam.json").write_text(json.dumps(
        {"lattice": {"num_sites": 50}, "num_samples": 256, "optimizer": "adam",
         "learning_rate": 0.005, "log_every": 10, "warmup_blocks": 1, "check_steps": 3}))
    (bench / "metrics" / "steps_traced.py").write_text(
        "def read(summary):\n    return float(summary['steps'])\n")
    (bench / "limits" / "tfim1d_n50_gru64.json").write_text(
        json.dumps({"limits": {"logp_gap": 1e-3}}))
    spec = load_spec(root)
    spec["configs"].append({"name": "prnn1d_gru64_tfim1d", "source": "test",
                            "file": "benchmark/configs/prnn1d_gru64_tfim1d.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tfim1d_n50_gru64", "config": "prnn1d_gru64_tfim1d",
                              "traffic": "chain_n50_s256_adam", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                              "source": "device_trace", "layer": "whole step",
                              "moves": "steps_per_s", "workloads": ["tfim1d_n50_gru64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell("tfim1d_n50_gru64", root)
    assert cell.config["units"] == 64 and cell.traffic["num_samples"] == 256
    assert cell.limits == {"logp_gap": 1e-3}
    assert [m["name"] for m in cell.end_to_end] == ["steps_per_s", "block_ms_p95", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert "steps_traced" in names and "minsr_ms_per_step" not in names
    assert metric_reader("steps_traced", root)({"steps": 7}) == 7.0
    # the cells already there are unchanged
    assert load_cell("tfim1d_n1000_minsr", root) == load_cell("tfim1d_n1000_minsr")


def test_every_metric_of_every_cell_has_its_files():
    spec = load_spec()
    for w in spec["workloads"]:
        cell = load_cell(w["name"])
        assert cell.chips == 1
        for m in cell.per_layer:
            assert callable(metric_reader(m["name"]))


def test_harness_imports_no_jax():
    code = ("import sys, benchmark.run, benchmark.calibrate, benchmark.check, "
            "benchmark.trace, benchmark.system, benchmark.faults, benchmark.roofline, "
            "benchmark.reference.gru_chain, benchmark.reference.mdrnn_lattice, "
            "benchmark.reference.tfim, benchmark.reference.vmc, "
            "rnnwavefunctions_tpu_torch.vmc.trainer\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "rnnwavefunctions_tpu"}
    assert "rnnwavefunctions_tpu_torch" in top


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.gru_chain, benchmark.reference.mdrnn_lattice, "
            "benchmark.reference.tfim, benchmark.reference.vmc\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not top & {"jax", "rnnwavefunctions_tpu", "rnnwavefunctions_tpu_torch"}


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "mdrnn_16x16_adam", "--seed", str(2**31 + 5), "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_outside_a_checkout_exits_nonzero(tmp_path):
    root = _copy_checkout(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "mdrnn_16x16_adam", "--seed", "1", "--seconds", "1"],
                         cwd=root, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _ev(name, kind, start, end, corr=0, linked=0, thread=1):
    return trace.Event(name, kind, start, end, corr, linked, thread)


def test_summarize_attributes_by_innermost_range_and_counts_idle():
    P = trace.PREFIX
    events = [
        _ev(trace.WINDOW, "op", 0, 1000, corr=1),
        _ev(P + "_sample_and_energy", "op", 0, 100, corr=2),
        _ev(P + "_update", "op", 100, 400, corr=3),
        _ev("aten::mul", "op", 110, 120, corr=4),
        _ev(P + "optimizer.step", "op", 300, 390, corr=5),
        _ev("cudaLaunchKernel", "runtime", 10, 12, corr=900, linked=2),
        _ev("cudaLaunchKernel", "runtime", 112, 114, corr=901, linked=4),
        _ev("cudaLaunchKernel", "runtime", 305, 306, corr=902, linked=5),
        _ev("cudaStreamSynchronize", "runtime", 150, 200, corr=903, linked=3),
        _ev("k3_kernel(float*)", "device", 20, 220, corr=900, linked=2),
        _ev("k2_kernel", "device", 230, 330, corr=901, linked=4),
        _ev("adam_kernel", "device", 330, 360, corr=902, linked=5),
        _ev(P + "_update", "device", 100, 400),  # a host range mirrored on the device
        _ev("memcpy_DtoH", "device", 990, 1010, corr=904),
        _ev("aten::copy_", "op", 400, 1000, corr=6),
        _ev("cudaMemcpyAsync", "runtime", 905, 999, corr=904, linked=6),
    ]
    s = trace.summarize(events)
    assert s["window_s"] == 1000e-9
    assert s["steps"] == 1
    assert s["device_s"] == pytest.approx({"_sample_and_energy": 200e-9, "_update": 100e-9,
                                           "optimizer.step": 30e-9, "other": 10e-9})
    assert s["busy_s"] == pytest.approx((200 + 130 + 10) * 1e-9)
    assert s["host_s"] == pytest.approx((100 + 300 - 50) * 1e-9)
    assert s["breakdown"]["device_ops"][0] == ["k3_kernel", pytest.approx(200e-9)]
    idle = dict(s["breakdown"]["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(1000e-9 - s["busy_s"])
    assert idle["aten::copy_"] == pytest.approx(630e-9)


def test_ranges_wrap_the_trainer_on_the_instance():
    class Opt:
        def step(self):
            return "stepped"

    class T:
        def _sample_and_energy(self, state):
            return "se"

        def _update(self, *a):
            return "up"

        def _set_minsr_direction(self, *a):
            return "sr"

    class S:
        optimizer = Opt()

    t, s = T(), S()
    s.optimizer = Opt()
    trace.add_ranges(t, s)
    assert "_update" in t.__dict__ and "step" in s.optimizer.__dict__
    assert (t._sample_and_energy(None), t._update(), t._set_minsr_direction(),
            s.optimizer.step()) == ("se", "up", "sr", "stepped")
    assert "_update" not in T().__dict__


def test_the_check_takes_the_reference_modules_the_configuration_names(monkeypatch):
    """``check.follow`` imports the model, the Hamiltonian and the update
    that the configuration's ``reference`` names, so a new configuration
    brings modules of its own and edits no file of the check."""
    import types

    import torch

    from benchmark import check
    from benchmark.reference import gru_chain, tfim, vmc
    from benchmark.system import FirstSteps

    calls = []
    hamiltonian = types.ModuleType("benchmark.reference.test_hamiltonian")

    def local_energy(model, params, samples, terms, precision):
        calls.append(("local_energy", model, terms["bx"]))
        return tfim.local_energy(model, params, samples, terms, precision)

    hamiltonian.local_energy = local_energy
    update = types.ModuleType("benchmark.reference.test_update")
    for name in ("log_psi_rows", "minsr_direction", "Adam", "SGD"):
        setattr(update, name, getattr(vmc, name))

    def loss_gradient(model, *args):
        calls.append(("loss_gradient", model))
        return vmc.loss_gradient(model, *args)

    update.loss_gradient = loss_gradient
    monkeypatch.setitem(sys.modules, hamiltonian.__name__, hamiltonian)
    monkeypatch.setitem(sys.modules, update.__name__, update)
    config = {"reference": {"model": "gru_chain", "hamiltonian": "test_hamiltonian",
                            "vmc": "test_update", "bx": 0.5, "jz": 1.0}}
    traffic = {"optimizer": "adam", "learning_rate": 0.005}
    gen = torch.Generator().manual_seed(3)
    params = {"rnn.0.wx": torch.randn(2, 12, generator=gen),
              "rnn.0.wh": torch.randn(4, 12, generator=gen) / 2,
              "rnn.0.bx": torch.zeros(12), "rnn.0.bh": torch.zeros(12),
              "head.w": torch.randn(4, 2, generator=gen), "head.b": torch.zeros(2)}
    record = FirstSteps(params, 1, samples=[torch.randint(0, 2, (6, 5), generator=gen)])
    out = check.follow(config, traffic, record)
    assert calls == [("local_energy", gru_chain, 0.5), ("loss_gradient", gru_chain)]
    assert len(out.params) == 1 and sorted(out.first) == sorted(params)
