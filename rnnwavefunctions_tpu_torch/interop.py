"""Parameter interchange with the JAX package.

The JAX ``PRNN1D`` keeps its parameters as a pytree
``{"rnn": [{"wx", "wh", "bx", "bh"}, ...], "head": {"w", "b"}}``
(``rnnwavefunctions_tpu/models/cells.py``, ``models/prnn1d.py``).  The
PyTorch ``PRNN1D`` stores the same tensors in the same layout, so the
conversion is a copy both ways and a round trip is bit-exact.  The pytree
is passed as NumPy arrays (``jax.tree.map(np.asarray, params)``); this
module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_GRU_KEYS = ("wx", "wh", "bx", "bh")


@torch.no_grad()
def load_params(model, tree: Dict[str, Any]) -> None:
    """Copies a NumPy parameter pytree into ``model`` in place (the
    parameters keep their device; optimizers holding them stay valid)."""
    if len(tree["rnn"]) != len(model.rnn):
        raise ValueError(
            f"pytree has {len(tree['rnn'])} layers, the model {len(model.rnn)}"
        )
    pairs = [
        (getattr(layer, k), cell[k])
        for layer, cell in zip(model.rnn, tree["rnn"])
        for k in _GRU_KEYS
    ]
    pairs += [(model.head.w, tree["head"]["w"]), (model.head.b, tree["head"]["b"])]
    for param, arr in pairs:
        src = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(
                f"shape {tuple(src.shape)} does not match the model's {tuple(param.shape)}"
            )
        param.copy_(src)


def params_to_numpy(model) -> Dict[str, Any]:
    """The model's parameters as the JAX package's pytree of NumPy arrays."""
    as_np = lambda p: p.detach().cpu().numpy().copy()  # noqa: E731
    return {
        "rnn": [{k: as_np(getattr(layer, k)) for k in _GRU_KEYS} for layer in model.rnn],
        "head": {"w": as_np(model.head.w), "b": as_np(model.head.b)},
    }
