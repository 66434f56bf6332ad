"""Misc host utilities (port of ``cs_vit_tpu/utils/misc.py``; parity:
`cs_vit/utils/misc.py`, `utils/tensor.py`).

The memory stats and the grad-norm summary take a tree: a tensor, a numpy
array, or a dict, list or tuple nesting them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch


def brief_dict(output: dict, prefix: str = ""):
    """Print a one-line summary per entry of a (nested) result dict."""
    for k, v in output.items():
        if hasattr(v, "shape"):
            kind = type(v).__name__
            print(f"{prefix}{k}: {kind}, {list(v.shape)}")
        elif isinstance(v, (str, int, float, list, tuple)):
            print(f"{prefix}{k}: {type(v).__name__}, {v}")
        elif v is None:
            print(f"{prefix}{k}: None")
        elif isinstance(v, dict):
            brief_dict(v, f"{prefix}{k}.")
        else:
            print(f"{prefix}{k}: {type(v).__name__}")


def to_tuple(x: Union[Any, Tuple]) -> Tuple:
    return x if isinstance(x, tuple) else (x, x)


def tree_leaves(tree) -> List[Any]:
    """The arrays of a tree, depth first in insertion order (None is no leaf)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def get_array_memory(arr) -> int:
    """Bytes held by one tensor or array."""
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    if hasattr(arr, "nbytes"):
        return int(arr.nbytes)
    return int(np.asarray(arr).nbytes)


def stat_tree_memory(tree) -> Dict[str, int]:
    """Total/leaf-count memory stats for a tree of tensors or arrays."""
    leaves = tree_leaves(tree)
    return {"total_bytes": sum(get_array_memory(x) for x in leaves),
            "num_arrays": len(leaves)}


def calculate_gradient_norm(grads, compat: bool = True) -> float:
    """Gradient-norm summary of a tree of grads.

    ``compat=True`` replicates the reference's logging quirk
    (`cs_vit/utils/tensor.py:10`): the sum of the squared per-leaf norms
    times 0.5 (NOT the square root). ``compat=False`` gives the true global
    L2 norm. Each leaf's squares are summed in f32, the leaves' sums as
    Python floats.
    """
    sq = sum(float(torch.sum(torch.as_tensor(g).float() ** 2)) for g in tree_leaves(grads))
    if compat:
        return sq * 0.5
    return math.sqrt(sq)
