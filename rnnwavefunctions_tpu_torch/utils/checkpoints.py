"""Checkpoint / resume with ``torch.save``.

Counterpart of ``rnnwavefunctions_tpu/utils/checkpoints.py`` (Orbax).  The
reference saves every 500 steps under ``Check_Points/<workload>/`` and
resumes from the saved state.  Here one file per step,
``<directory>/step_<step>.pt``, holds everything a resumed run needs to go on
exactly as an uninterrupted one would:

- ``params``: the ansatz's ``state_dict`` (the port's parameters live in
  the module, not in the ``TrainState``);
- ``optimizer``: the optimizer's ``state_dict``, and ``optimizer_kind``, its
  class name ("Adam", or "SGD" under minSR);
- ``generator``: the per-step ``torch.Generator``'s state, the run's whole
  random stream;
- ``step``: the number of updates taken.

A file is written to a temporary name and moved into place with
``os.replace``, so a reader never sees half a checkpoint; the newest
``max_to_keep`` files stay, as Orbax's ``max_to_keep``.  An Orbax
checkpoint of the JAX package is not readable here.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from ..vmc.trainer import TrainState

_NAME = re.compile(r"step_(\d+)\.pt")


class Checkpointer:
    """Saves and restores a ``TrainState`` together with the parameters of
    ``ansatz``."""

    def __init__(self, directory: str, ansatz: torch.nn.Module, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.ansatz = ansatz
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        """The file of ``step``."""
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: Optional[int] = None) -> None:
        if step is None:
            step = state.step
        payload = {
            "params": self.ansatz.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "optimizer_kind": type(state.optimizer).__name__,
            "generator": state.generator.get_state(),
            "step": state.step,
        }
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def _load_params(self, saved) -> None:
        """Copies the saved parameters into the ansatz; ``ValueError`` when a
        tensor is missing or its shape differs from the configured ansatz's."""
        params = saved["params"]
        for name, p in self.ansatz.state_dict().items():
            if name not in params:
                raise ValueError(f"checkpoint has no parameter {name!r} "
                                 f"(saved: {sorted(params)})")
            if tuple(params[name].shape) != tuple(p.shape):
                raise ValueError(
                    f"checkpoint parameter {name!r} has shape {tuple(params[name].shape)} "
                    f"but the configured ansatz expects {tuple(p.shape)}"
                )
        self.ansatz.load_state_dict(params)

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Restores the parameters, the optimizer state, the generator and
        the step into ``state`` (obtain one from ``trainer.init()``);
        ``ValueError`` when the checkpoint's optimizer is of another kind
        than ``state``'s."""
        saved = self._load(step)
        kind = type(state.optimizer).__name__
        if saved["optimizer_kind"] != kind:
            raise ValueError(f"checkpoint optimizer {saved['optimizer_kind']}, "
                             f"configured {kind}")
        self._load_params(saved)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.generator.set_state(saved["generator"])
        state.step = int(saved["step"])
        return state

    def restore_params_and_step(self, state: TrainState,
                                step: Optional[int] = None) -> TrainState:
        """Resume under another optimizer: restores the parameters, the
        generator and the step and keeps ``state``'s fresh optimizer (its
        moments zeroed; the schedule reads the restored step)."""
        saved = self._load(step)
        self._load_params(saved)
        state.generator.set_state(saved["generator"])
        state.step = int(saved["step"])
        return state
