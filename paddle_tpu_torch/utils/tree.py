"""Path-keyed flattening of a state tree (dicts, lists, tuples), shared
by the checkpoint layout and the quantized collectives.

A leaf's key is its path joined by '/': dict keys sorted (as jax flattens
them), list and tuple items by index. The checkpoint manifests store
these keys, so the reference package reads them as its own.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

__all__ = ["flatten", "unflatten"]


def flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` of ``tree`` in key order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def unflatten(tree, values: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(tree, dict):
        return {k: unflatten(v, values, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(unflatten(v, values, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]
