"""The correctness check fails what it has to fail: the control (the
reference in TF32 in the program's place) and each fault planted in the
program, driving the rest of a run (``run_cell``) without the harness's
look for a card.  On the CPU the program runs its plain path with few
samples, at the cells' lattices for the control and at smaller ones for
the faults; the test marked ``cuda`` reads the control at each cell's own
size on the card."""

import dataclasses

import pytest
import torch

from benchmark import check
from benchmark.calibrate import readings_of
from benchmark.faults import FAULTS
from benchmark.run import run_cell
from benchmark.spec import load_spec, load_cell

CELLS = [w["name"] for w in load_spec()["workloads"]]
SEED = 2**31 + 12345


# the CPU runs' samples per update: the cells' lattices, with few samples
SAMPLES = {"mdrnn_16x16_adam": 16, "tfim1d_n1000_minsr": 8}
# the faults show at any size: smaller lattices than the cells'
FAULT_LATTICES = {"mdrnn_16x16_adam": {"nx": 6, "ny": 6},
                  "tfim1d_n1000_minsr": {"num_sites": 60}}


def _small(name: str, samples: int, lattice=None):
    cell = load_cell(name)
    traffic = {**cell.traffic, "num_samples": samples, "log_every": 3, "warmup_blocks": 0}
    if lattice is not None:
        traffic["lattice"] = lattice
    return dataclasses.replace(cell, traffic=traffic)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs the kernels")
    return "cuda"


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    cell = _small(name, SAMPLES[name])
    ((_, program, *_), (_, control, *_)), _ = readings_of(cell, SEED, "cpu", control=True)
    assert check.judge(program, cell.limits), program
    assert not check.judge(control, cell.limits), control


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_makes_a_run_incorrect(name, fault):
    cell = _small(name, 16, FAULT_LATTICES[name])
    out = run_cell(cell, SEED + 1, 0.01, False, "cpu", plant=FAULTS[fault])
    assert out["result"]["correct"] is False, out["result"]["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_own_size_on_the_card(name, card):
    cell = load_cell(name)
    for seed in (SEED + 2, SEED + 3, SEED + 4):
        ((_, program, *_), (_, control, *_)), _ = readings_of(cell, seed, card, control=True)
        assert check.judge(program, cell.limits), program
        assert not check.judge(control, cell.limits), control


def test_the_witness_reads_each_side_against_float64():
    """The round-off witness: the program, the float32 reference and the
    control each on its own path, read against the float64 reference; at a
    small size the float32 reference stays close to float64, and the
    control does not; the program's first direction, against float64 from
    the program's own first local energies, reads its kernels alone."""
    cell = _small("mdrnn_16x16_adam", 12, {"nx": 3, "ny": 4})
    _, lines = readings_of(cell, SEED + 5, "cpu", with_witness=True)
    got = {kind[len("witness:"):]: (values, leaves) for kind, values, _, leaves in lines}
    assert sorted(got) == sorted(["program", "reference_fp32", "control",
                                  "program_vs_f64_on_program_e_loc", "f64_on_program_e_loc"])
    assert got["reference_fp32"][0]["logp_gap"] < 1e-4
    assert got["control"][0]["logp_gap"] > 10 * got["reference_fp32"][0]["logp_gap"]
    # on the CPU the program's path is the plain path in float32
    assert got["program_vs_f64_on_program_e_loc"][0]["grad_gap"] < 1e-4
    values, leaves = got["program"]
    assert set(leaves["grad"]) == {"cell.uh", "cell.uv", "cell.wh", "cell.wv", "cell.b",
                                   "head.w", "head.b"}
    assert max(leaves["grad"].values()) == values["grad_gap"]
