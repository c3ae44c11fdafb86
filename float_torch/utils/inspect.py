"""Model inspection — parameter counting and architecture tables (twin of
``float_tpu.utils.inspect``).

Replaces the reference's BaseModel.print_architecture (basemodel.py:29-89,
output captured in doc/NETWORKS.md).  Works over an ``nn.Module`` (such as
the pipeline's :class:`~float_torch.models.init.ParamTree`), a state_dict,
or a nested dict whose leaves have a ``shape`` (tensors, numpy arrays).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def num2str(num: float, precision: int = 2) -> str:
    if not num:
        return "N/A"
    if abs(num) >= 1e6:
        return f"{num / 1e6:.{precision}f} M"
    if abs(num) >= 1e3:
        return f"{num / 1e3:.{precision}f} K"
    return str(int(num))


def _nested(tree: Any) -> Any:
    """A module or a state_dict -> the nested dict of its tensors (dotted
    keys split), so both count and print as the pytree they mirror."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if not isinstance(tree, Mapping):
        return tree
    out: dict = {}
    for key, value in tree.items():
        *path, leaf = str(key).split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _nested(value)
    return out


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def count_params(tree: Any) -> int:
    """Elements of every tensor of ``tree`` (a module counts its
    state_dict, buffers included, as a pytree counts its leaves)."""
    return sum(int(np.prod(t.shape)) for t in _leaves(_nested(tree)))


def architecture_table(params: Any, max_depth: int = 1) -> str:
    """Per-subtree parameter counts, indented by depth; ``max_depth`` < 0
    walks every level."""
    params = _nested(params)
    lines = []

    def walk(tree, name, depth):
        lines.append(f"{'  ' * depth}{name}: {num2str(count_params(tree))} "
                     "params")
        if isinstance(tree, dict) and (max_depth < 0 or depth < max_depth):
            for k in sorted(tree, key=lambda s: (len(s), s)):
                if isinstance(tree[k], dict):
                    walk(tree[k], k, depth + 1)

    for key in params:
        walk(params[key], key, 0)
    lines.append(f"TOTAL: "
                 f"{num2str(sum(count_params(v) for v in params.values()))}"
                 " params")
    return "\n".join(lines)
