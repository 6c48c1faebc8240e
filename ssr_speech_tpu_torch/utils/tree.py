"""Nested dict / list / tuple trees of tensors, flattened in JAX's order.

``jax.tree.leaves`` visits dict keys sorted and sequences in order; the
port's optimizer state and bundles keep that order, so a state saved by one
package lines up leaf for leaf with the other's. (``torch.utils._pytree``
visits dict keys in insertion order, which is why the port has its own.)
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.leaves`` order (empty containers have none)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def to_numpy_tree(tree):
    """Tensors -> numpy arrays throughout a nested dict/list (for bundles)."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)
