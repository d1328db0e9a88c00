"""Training metrics: the reference's published .npy artifact series plus
structured JSONL logs.

Counterpart of ``rnnwavefunctions_tpu/utils/metrics.py`` (a copy: the port
imports nothing of the JAX package), for one process, so without its
``write=`` flag.  The reference appends mean/var energy per step and
``np.save``s the full series every 10 steps under ``Check_Points/`` with
hyperparameter-encoding filenames, and prints a summary line every 10
steps.  ``MetricsSeries`` keeps that artifact contract
(``meanEnergy_<tag>.npy`` / ``varEnergy_<tag>.npy``, loadable for resume)
and adds a ``metrics_<tag>.jsonl`` structured log with wall-clock timing.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Union

import numpy as np

Number = Union[float, complex]


class MetricsSeries:
    def __init__(self, directory: str, tag: str, resume: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.tag = tag
        self.mean_energy: List[Number] = []
        self.var_energy: List[float] = []
        self._t0 = time.time()
        self._jsonl_path = os.path.join(self.directory, f"metrics_{tag}.jsonl")
        if resume and os.path.exists(self.mean_path):
            mean = np.load(self.mean_path)
            cast = complex if np.iscomplexobj(mean) else float
            self.mean_energy = [cast(x) for x in mean]
            # np.save is not atomic and the two series flush one after the
            # other: a crash between them can leave var missing or shorter,
            # so keep the common prefix instead of failing the resume
            if os.path.exists(self.var_path):
                self.var_energy = [float(x) for x in np.load(self.var_path)]
            n = min(len(self.mean_energy), len(self.var_energy))
            del self.mean_energy[n:]
            del self.var_energy[n:]
        elif not resume and os.path.exists(self._jsonl_path):
            os.remove(self._jsonl_path)

    @property
    def mean_path(self) -> str:
        return os.path.join(self.directory, f"meanEnergy_{self.tag}.npy")

    @property
    def var_path(self) -> str:
        return os.path.join(self.directory, f"varEnergy_{self.tag}.npy")

    @property
    def step(self) -> int:
        """Resume point, reference-style: number of recorded steps."""
        return len(self.mean_energy)

    def append(self, mean_e: Number, var_e: float) -> None:
        self.mean_energy.append(mean_e)
        self.var_energy.append(var_e)

    def truncate(self, num_steps: int) -> None:
        """Drops the entries past ``num_steps`` (resume: the restored
        checkpoint's step wins over a series that flushed ahead), and the
        JSONL records of the steps that will be trained again."""
        del self.mean_energy[num_steps:]
        del self.var_energy[num_steps:]
        if os.path.exists(self._jsonl_path):
            kept = []
            with open(self._jsonl_path) as f:
                for line in f:
                    try:
                        # entry j <-> step j: step num_steps is trained
                        # again, so its old record goes too
                        if json.loads(line)["step"] >= num_steps:
                            break
                    except (ValueError, KeyError):
                        break
                    kept.append(line)
            with open(self._jsonl_path, "w") as f:
                f.writelines(kept)

    def flush_npy(self) -> None:
        np.save(self.mean_path, np.asarray(self.mean_energy))
        np.save(self.var_path, np.asarray(self.var_energy))

    def log_jsonl(self, step: int, **extra) -> None:
        rec = {
            "step": step,
            "wall_time_s": round(time.time() - self._t0, 3),
            "mean_energy": _jsonable(self.mean_energy[-1]),
            "var_energy": _jsonable(self.var_energy[-1]),
        }
        rec.update({k: _jsonable(v) for k, v in extra.items()})
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def print_line(self, step: int, num_samples: int) -> None:
        """The reference's per-10-step console line (minus its blank
        lines)."""
        print(
            f"mean(E): {self.mean_energy[-1]}, var(E): {self.var_energy[-1]}, "
            f"#samples {num_samples}, #Step {step}"
        )


def _jsonable(v):
    if isinstance(v, (np.generic, np.ndarray)):
        v = v.item()  # NumPy scalars are not JSON-serializable
    if isinstance(v, complex):
        return {"re": v.real, "im": v.imag}
    return v
