"""Parameter interchange with the JAX package.

The JAX ansatze keep their parameters as pytrees: ``PRNN1D``'s is
``{"rnn": [{"wx", "wh", "bx", "bh"}, ...], "head": {"w", "b"}}`` and
``CRNNU1``'s has ``"head_ampl"`` and ``"head_phase"`` in place of ``"head"``
(``rnnwavefunctions_tpu/models/{cells,prnn1d,crnn_u1}.py``).  The PyTorch
modules store the same tensors in the same layout, so the conversion is a
copy both ways and a round trip is bit-exact.  The model names its heads
(``head_names``), which decides the tree's kind.  The pytree
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
    for name in model.head_names:
        head = getattr(model, name)
        pairs += [(head.w, tree[name]["w"]), (head.b, tree[name]["b"])]
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
    tree = {"rnn": [{k: as_np(getattr(layer, k)) for k in _GRU_KEYS} for layer in model.rnn]}
    for name in model.head_names:
        head = getattr(model, name)
        tree[name] = {"w": as_np(head.w), "b": as_np(head.b)}
    return tree
