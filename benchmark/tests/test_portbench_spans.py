"""``program_spans.summarize`` on synthetic traces: device time by the span
open at the launch on any thread, launch calls (a graph counting once) and
the idle at block boundaries, the per-layer readings of them; the entry
point's exit without a card; and ``trace.summarize`` untouched by the
program's spans."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import program_spans, trace

ROOT = Path(__file__).resolve().parents[2]


def _ev(name, kind, start, end, corr=0, linked=0, thread=1):
    return trace.Event(name, kind, start, end, corr, linked, thread)


def _two_blocks():
    return [
        _ev(trace.WINDOW, "op", 0, 1000, corr=1),
        # block 1: one step, then its readback
        _ev("rnnwf.block", "op", 0, 300, corr=2),
        _ev("rnnwf.step", "op", 0, 300, corr=3),
        _ev("rnnwf.sample_energy", "op", 0, 100, corr=4),
        _ev("rnnwf.gradient", "op", 100, 200, corr=5),
        _ev("rnnwf.optimizer", "op", 250, 290, corr=6),
        _ev("cudaLaunchKernel", "runtime", 10, 12, corr=900),
        _ev("k3", "device", 20, 150, corr=900),
        # the backward, launched from the autograd thread inside rnnwf.gradient
        _ev("cudaLaunchKernel", "runtime", 150, 152, corr=901, thread=2),
        _ev("k2", "device", 160, 260, corr=901),
        _ev("cudaLaunchKernel", "runtime", 260, 262, corr=902),
        _ev("adam", "device", 270, 280, corr=902),
        # a graph: one launch call, two kernels
        _ev("cudaGraphLaunch", "runtime", 280, 285, corr=903),
        _ev("g1", "device", 290, 300, corr=903),
        _ev("g2", "device", 300, 310, corr=903),
        _ev("rnnwf.step", "device", 0, 300),  # a host range mirrored on the device
        _ev("rnnwf.readback", "op", 300, 400, corr=7),
        _ev("cudaMemcpyAsync", "runtime", 305, 395, corr=904),
        _ev("memcpy_DtoH", "device", 320, 330, corr=904),
        # block 2, and a last readback that no launch follows
        _ev("rnnwf.block", "op", 400, 700, corr=8),
        _ev("rnnwf.step", "op", 400, 700, corr=9),
        _ev("cudaLaunchKernel", "runtime", 410, 412, corr=905),
        _ev("k3", "device", 450, 500, corr=905),
        _ev("rnnwf.readback", "op", 700, 800, corr=10),
        _ev("cudaMemcpyAsync", "runtime", 710, 790, corr=906),
        _ev("memcpy_DtoH", "device", 750, 760, corr=906),
    ]


def test_device_time_counts_under_every_open_span_on_any_thread():
    spans = program_spans.summarize(_two_blocks())["spans"]
    seconds = {name: s["device_s"] * 1e9 for name, s in spans.items()}
    assert seconds == pytest.approx({
        "rnnwf.block": 310, "rnnwf.step": 310, "rnnwf.sample_energy": 130,
        "rnnwf.gradient": 100, "rnnwf.optimizer": 30, "rnnwf.readback": 20})
    assert {name: s["count"] for name, s in spans.items()} == {
        "rnnwf.block": 2, "rnnwf.step": 2, "rnnwf.sample_energy": 1, "rnnwf.gradient": 1,
        "rnnwf.optimizer": 1, "rnnwf.readback": 2}


def test_launches_count_kernel_launch_calls_and_a_graph_once():
    spans = program_spans.summarize(_two_blocks())["spans"]
    assert {name: s["launches"] for name, s in spans.items()} == {
        "rnnwf.block": 5, "rnnwf.step": 5, "rnnwf.sample_energy": 1, "rnnwf.gradient": 1,
        "rnnwf.optimizer": 2, "rnnwf.readback": 0}


def test_boundary_idle_runs_from_the_readback_to_the_next_blocks_first_operation():
    s = program_spans.summarize(_two_blocks())
    # [300, 450] less g2 (300-310) and the copy (320-330); the last readback
    # has no launch after it
    assert s["boundaries"] == 1
    assert s["boundary_idle_s"] == pytest.approx(130e-9)


def test_a_trace_without_the_programs_spans_gives_nothing_to_read():
    events = [e for e in _two_blocks() if not e.name.startswith("rnnwf.")]
    program = program_spans.summarize(events)
    assert program == {"spans": {}, "boundaries": 0, "boundary_idle_s": 0.0}
    assert program_spans.readings(program) == {}


def test_the_readings_read_the_spans():
    read = program_spans.readings(program_spans.summarize(_two_blocks()))
    assert read == pytest.approx({"optimizer_ms_per_step": 30e-6 / 2,
                                  "launches_per_step": 2.5,
                                  "boundary_idle_ms_per_block": 130e-6})
    minsr = {"rnnwf.step": {"count": 4, "device_s": 1.0, "launches": 0},
             "rnnwf.minsr": {"count": 4, "device_s": 0.5, "launches": 0},
             "rnnwf.minsr.rows": {"count": 4, "device_s": 0.4, "launches": 0}}
    read = program_spans.readings({"spans": minsr, "boundaries": 0, "boundary_idle_s": 0.0})
    assert read == pytest.approx({"launches_per_step": 0.0,
                                  "minsr_rows_ms_per_step": 100.0,
                                  "minsr_solve_ms_per_step": 25.0})


def test_the_readings_without_a_card_exit_nonzero_and_print_nothing():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.program_spans", "--workload",
                          "tfim1d_n1000_minsr", "--seed", str(2**31 + 5), "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_trace_summarize_is_unchanged_by_the_programs_spans():
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
        _ev(P + "_update", "device", 100, 400),
        _ev("memcpy_DtoH", "device", 990, 1010, corr=904),
        _ev("aten::copy_", "op", 400, 1000, corr=6),
        _ev("cudaMemcpyAsync", "runtime", 905, 999, corr=904, linked=6),
    ]
    spans = [
        _ev("rnnwf.step", "op", 0, 400, corr=20),
        _ev("rnnwf.sample_energy", "op", 1, 99, corr=21),
        _ev("rnnwf.gradient", "op", 101, 299, corr=22),
        _ev("rnnwf.optimizer", "op", 301, 389, corr=23),
        _ev("rnnwf.readback", "op", 400, 1000, corr=24),
        _ev("rnnwf.step", "device", 0, 400),
    ]
    before, after = trace.summarize(events), trace.summarize(events + spans)
    idle_before = before["breakdown"].pop("idle_gaps")
    idle_after = after["breakdown"].pop("idle_gaps")
    assert after == before
    # only the names of idle gaps may change, to the program's spans
    assert sum(v for _, v in idle_after) == pytest.approx(sum(v for _, v in idle_before))
