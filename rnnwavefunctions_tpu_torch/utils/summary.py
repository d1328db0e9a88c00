"""Parameter summaries: the reference's trainable-variable printout as a
utility.  Counterpart of ``rnnwavefunctions_tpu/utils/summary.py``; the
names are the JAX package's pytree paths (``interop.param_tree``), so the
table reads line for line as the JAX package's."""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from ..interop import param_tree


def _named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) in ``jax.tree.leaves`` order: dict entries by sorted
    key, list entries in order as ``[i]``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _named_leaves(t, f"{prefix}[{i}]/")
    else:
        yield prefix[:-1], tree


def summarize_params(model: torch.nn.Module) -> str:
    """Per-tensor shapes plus the total, as a printable table."""
    lines = [f"{name:40s} {str(tuple(p.shape)):16s} {str(p.dtype).removeprefix('torch.')}"
             for name, p in _named_leaves(param_tree(model))]
    lines.append(f"The number of params is {sum(p.numel() for p in model.parameters())}")
    return "\n".join(lines)
