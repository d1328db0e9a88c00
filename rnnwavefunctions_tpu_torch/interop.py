"""Parameter interchange with the JAX package.

The JAX ansatze keep their parameters as pytrees: ``PRNN1D``'s is
``{"rnn": [{"wx", "wh", "bx", "bh"}, ...], "head": {"w", "b"}}``,
``CRNNU1``'s has ``"head_ampl"`` and ``"head_phase"`` in place of ``"head"``,
and ``MDRNN2D``'s is ``{"cell": {"uh", "uv", "wh", "wv", "b"}, "head": {"w",
"b"}}`` (``rnnwavefunctions_tpu/models/{cells,prnn1d,crnn_u1,mdrnn2d}.py``).
The PyTorch modules store the same tensors in the same layout, so the
conversion is a copy both ways and a round trip is bit-exact.  The model
declares its tree's layout: a GRU stack ``rnn`` (a list of layers) where it
has one, the single-module entries ``cell_trees`` (entry -> tensor names)
and its heads ``head_names``.  The pytree is passed as NumPy arrays
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_GRU_KEYS = ("wx", "wh", "bx", "bh")
_HEAD_KEYS = ("w", "b")


def _entries(model):
    """(tree entry, module, tensor names) of every single-module entry."""
    entries = [(name, getattr(model, name), keys)
               for name, keys in getattr(model, "cell_trees", {}).items()]
    return entries + [(name, getattr(model, name), _HEAD_KEYS) for name in model.head_names]


@torch.no_grad()
def load_params(model, tree: Dict[str, Any]) -> None:
    """Copies a NumPy parameter pytree into ``model`` in place (the
    parameters keep their device; optimizers holding them stay valid)."""
    pairs = []
    if hasattr(model, "rnn"):
        if len(tree["rnn"]) != len(model.rnn):
            raise ValueError(
                f"pytree has {len(tree['rnn'])} layers, the model {len(model.rnn)}"
            )
        pairs += [
            (getattr(layer, k), cell[k])
            for layer, cell in zip(model.rnn, tree["rnn"])
            for k in _GRU_KEYS
        ]
    for name, module, keys in _entries(model):
        pairs += [(getattr(module, k), tree[name][k]) for k in keys]
    for param, arr in pairs:
        src = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(
                f"shape {tuple(src.shape)} does not match the model's {tuple(param.shape)}"
            )
        param.copy_(src)


def param_tree(model) -> Dict[str, Any]:
    """The model's parameters (the ``nn.Parameter`` objects themselves) in
    the JAX package's pytree layout."""
    tree = {}
    if hasattr(model, "rnn"):
        tree["rnn"] = [{k: getattr(layer, k) for k in _GRU_KEYS} for layer in model.rnn]
    for name, module, keys in _entries(model):
        tree[name] = {k: getattr(module, k) for k in keys}
    return tree


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one layout (dicts, lists, tensors)."""
    if isinstance(trees[0], dict):  # sorted keys: leaves in tree_leaves order
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(trees[0])}
    if isinstance(trees[0], (list, tuple)):
        return [tree_map(fn, *ts) for ts in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order: dict entries by sorted key,
    list entries in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree, leaves: List[Any]):
    """A tree of ``tree``'s layout holding ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def params_to_numpy(model) -> Dict[str, Any]:
    """The model's parameters as the JAX package's pytree of NumPy arrays."""
    return tree_map(lambda p: p.detach().cpu().numpy().copy(), param_tree(model))
