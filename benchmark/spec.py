"""Finds a cell's parts by name: ``BENCHMARK.json`` names the cell, its
configuration and traffic and the metrics it reports; each of those is a
file of its own under ``benchmark/``.

* a configuration: ``configs/<name>.json`` (its ``file`` in
  ``BENCHMARK.json``), the model's sizes, how the program builds it, which
  plain reference models it, and the precision it states;
* a traffic mix: ``traffic/<name>.json``, the lattice, the samples per
  step, the optimizer and its settings, the steps per ``fit`` block;
* a per-layer metric: ``metrics/<name>.py``, whose ``read(summary)``
  returns its value from the traced window's summary, or None where that
  holds nothing to read;
* a cell's correctness check: ``limits/<cell>.json``, the limit of each
  number compared (``check.py``).

Adding any of them is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_spec(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError for a
    name the file does not hold."""
    spec = load_spec(root)
    workload = {w["name"]: w for w in spec["workloads"]}[name]
    entry = {c["name"]: c for c in spec["configs"]}[workload["config"]]
    config = json.loads((root / entry["file"]).read_text())
    bench = root / "benchmark"
    traffic = json.loads((bench / "traffic" / f"{workload['traffic']}.json").read_text())
    check = json.loads((bench / "limits" / f"{name}.json").read_text())
    return Cell(
        name=name,
        chips=workload["chips"],
        config=config,
        traffic=traffic,
        limits=check["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str, root: Path = ROOT) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
