"""The harness takes a complex amplitude and hands the program's spans to
per-layer metrics: a complex ansatz's cell runs its set-up, window and
check on the CPU; mean energies are judged as complex numbers, and a real
cell's readings stay those of the real formulas; ``run.traced_summary``
carries the program's spans, and the five readers of them read them."""

import dataclasses
import math

import pytest
import torch

from benchmark import check, program_spans, run
from benchmark.spec import BENCH_DIR, Cell, load_cell, load_spec, metric_reader
from benchmark.system import FirstSteps
from benchmark.tests.test_portbench_spans import _two_blocks

SEED = 2**31 + 4321
SPAN_METRICS = ("launches_per_step", "boundary_idle_ms_per_block", "optimizer_ms_per_step",
                "minsr_rows_ms_per_step", "minsr_solve_ms_per_step")


def _complex_cell() -> Cell:
    """``CRNNU1(8, (8,))`` on ``J1J2(8, j2=0.2)``, Adam, on the plain path."""
    config = {"program": {"ansatz": "CRNNU1", "ansatz_kwargs": {"units": [8]},
                          "hamiltonian": "J1J2", "hamiltonian_kwargs": {"j2": 0.2}}}
    traffic = {"lattice": {"num_sites": 8}, "num_samples": 16, "optimizer": "adam",
               "learning_rate": 0.005, "log_every": 3, "warmup_blocks": 0, "check_steps": 3}
    return Cell("crnn_j1j2_n8", 1, config, traffic, {}, [], [])


def test_a_complex_cell_runs_set_up_window_and_readings():
    cell = _complex_cell()
    trainer, state, record = run.set_up(cell, SEED, "cpu")
    assert len(record.energies) == 3 and record.e_loc[0].is_complex()
    assert any(e.imag != 0.0 for e in record.energies)
    window = run.run_window(trainer, state, 0.5, cell.traffic["log_every"], lambda: None)
    assert window.steps > 0 and all(isinstance(e, complex) for e in window.energies)
    values = check.readings(record, record, window.energies)
    assert values == {"logp_gap": 0.0, "eloc_gap": 0.0, "energy_gap": 0.0, "grad_gap": 0.0,
                      "update_gap": 0.0, "nonfinite": 0.0}


def _real_record(seed: int, shift: float = 0.0) -> FirstSteps:
    gen = torch.Generator().manual_seed(seed)
    params0 = {"a": torch.randn(4, 3, generator=gen), "b": torch.randn(3, generator=gen),
               "c": torch.randn(2, 2, generator=gen)}
    rec = FirstSteps(params0, 2)
    for _ in range(2):
        rec.samples.append(torch.randint(0, 2, (5, 6), generator=gen))
        rec.log_prob.append(torch.randn(5, generator=gen, dtype=torch.float64))
        rec.e_loc.append(torch.randn(5, generator=gen, dtype=torch.float64) - 3.0)
        rec.params.append({k: v + 0.1 * torch.randn(v.shape, generator=gen)
                           for k, v in params0.items()})
        rec.energies.append(complex(float(rec.e_loc[-1].mean()) + shift))
    rec.first = {k: torch.randn(v.shape, generator=gen) for k, v in params0.items()}
    return rec


def _parent_readings(got: FirstSteps, ref: FirstSteps, window_energies):
    """The real formulas the check used before energies were complex."""
    got_e = [float(e.real) for e in got.energies]
    ref_e = [float(e.real) for e in ref.energies]
    leaves = check.by_leaf(got, ref)
    return {
        "logp_gap": max(float((a - b).abs().max()) for a, b in zip(got.log_prob, ref.log_prob)),
        "eloc_gap": max(float((a - b).abs().max() / b.abs().mean())
                        for a, b in zip(got.e_loc, ref.e_loc)),
        "energy_gap": max(abs(a - b) / abs(b) for a, b in zip(got_e, ref_e)),
        "grad_gap": max(leaves["grad"].values()),
        "update_gap": max(leaves["update"].values()),
        "nonfinite": float(sum(1 for e in window_energies if not math.isfinite(e))),
    }


@pytest.mark.parametrize("seeds", [(1, 2), (3, 4), (5, 5)])
def test_a_real_record_reads_as_the_real_formulas_give_it(seeds):
    got, ref = _real_record(seeds[0], 1e-4), _real_record(seeds[1])
    window = [-2.5, float("inf"), -2.4]
    values = check.readings(got, ref, [complex(e) for e in window])
    assert values == _parent_readings(got, ref, window)


def test_a_part_that_is_not_finite_counts_in_nonfinite():
    rec = _real_record(7)
    window = [complex(-2.5, 0.1), complex(math.nan, 0.0), complex(0.0, math.inf), -2.4]
    assert check.readings(rec, rec, window)["nonfinite"] == 2.0


def test_the_reported_means_imaginary_part_is_judged():
    rec = _real_record(8)
    moved = dataclasses.replace(rec, energies=[e + 1e-3j for e in rec.energies])
    gap = check.readings(moved, rec, [])["energy_gap"]
    assert gap == pytest.approx(max(1e-3 / abs(e) for e in rec.energies), rel=1e-12)


def test_the_reference_keeps_a_complex_mean_energy():
    config = {"reference": {"model": "gru_chain", "hamiltonian": "tfim", "vmc": "vmc",
                            "bx": 1.0, "jz": 1.0}}
    traffic = {"optimizer": "adam", "learning_rate": 0.005}
    gen = torch.Generator().manual_seed(3)
    params = {"rnn.0.wx": torch.randn(2, 12, generator=gen),
              "rnn.0.wh": torch.randn(4, 12, generator=gen) / 2,
              "rnn.0.bx": torch.zeros(12), "rnn.0.bh": torch.zeros(12),
              "head.w": torch.randn(4, 2, generator=gen), "head.b": torch.zeros(2)}
    samples = torch.randint(0, 2, (6, 5), generator=gen)
    out = check.follow(config, traffic, FirstSteps(params, 1, samples=[samples]))
    (energy,) = out.energies
    assert isinstance(energy, complex) and energy.imag == 0.0
    assert energy.real == float(out.e_loc[0].mean())


def test_the_traced_summary_carries_the_programs_spans():
    cell = load_cell("tfim1d_n1000_minsr")
    events = _two_blocks()
    summary = run.traced_summary(cell, events)
    assert summary["program"] == program_spans.summarize(events)
    assert summary["least_s"] and "busy_s" in summary
    want = program_spans.readings(summary["program"])
    assert sorted(want) == ["boundary_idle_ms_per_block", "launches_per_step",
                            "optimizer_ms_per_step"]
    for name in SPAN_METRICS:
        assert metric_reader(name)(summary) == want.get(name)


def test_the_minsr_readers_read_rows_and_the_rest_of_the_direction():
    spans = {"rnnwf.step": {"count": 4, "device_s": 1.0, "launches": 380},
             "rnnwf.minsr": {"count": 4, "device_s": 0.5, "launches": 300},
             "rnnwf.minsr.rows": {"count": 4, "device_s": 0.4, "launches": 60}}
    summary = {"program": {"spans": spans, "boundaries": 0, "boundary_idle_s": 0.0}}
    read = {name: metric_reader(name)(summary) for name in SPAN_METRICS}
    assert read == pytest.approx({"launches_per_step": 95.0, "boundary_idle_ms_per_block": None,
                                  "optimizer_ms_per_step": None,
                                  "minsr_rows_ms_per_step": 100.0,
                                  "minsr_solve_ms_per_step": 25.0})


def test_without_the_programs_spans_the_readers_return_none():
    cell = load_cell("mdrnn_16x16_adam")
    events = [e for e in _two_blocks() if not e.name.startswith(program_spans.PREFIX)]
    summary = run.traced_summary(cell, events)
    assert summary["program"] == {"spans": {}, "boundaries": 0, "boundary_idle_s": 0.0}
    assert all(metric_reader(name)(summary) is None for name in SPAN_METRICS)


def test_every_per_layer_metric_has_its_reader_and_names_cells():
    spec = load_spec()
    cells = {w["name"] for w in spec["workloads"]}
    names = [m["name"] for m in spec["per_layer"]]
    assert set(SPAN_METRICS) <= set(names)
    for m in spec["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert callable(metric_reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells, m["name"]
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


SMALL = {"mdrnn_16x16_adam": {"nx": 4, "ny": 4}, "tfim1d_n1000_minsr": {"num_sites": 20}}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_traced_run_reads_the_programs_spans(name):
    """``run_cell``'s traced branch on the CPU's plain path: the program's
    spans reach the readers (no CUDA launch and no device time there)."""
    cell = load_cell(name)
    traffic = {**cell.traffic, "lattice": SMALL[name], "num_samples": 8, "log_every": 3,
               "warmup_blocks": 0}
    out = run.run_cell(dataclasses.replace(cell, traffic=traffic), SEED, 0.3, True, "cpu")
    metrics = out["result"]["metrics"]
    assert out["result"]["correct"] is True
    assert metrics["launches_per_step"] == {"value": 0.0, "unit": "launches"}
    assert "optimizer_ms_per_step" in metrics
    assert ("minsr_rows_ms_per_step" in metrics) == (traffic["optimizer"] == "minsr")
