"""Map a function over the tensors of a nested structure, or list them:
dicts, lists, tuples and the GL/GL2 named tuples (the port's
jax.tree.map and jax.tree.leaves)."""

import torch


def tree_map(fn, tree, *rest):
    """fn(leaf, *matching leaves of `rest`) at every tensor of `tree`;
    None stays None."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"cannot map over {type(tree).__name__}")


def tree_leaves(tree) -> list:
    """The tensors of `tree` in tree_map's order (the port's
    jax.tree.leaves); None and any other non-container leaf are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []
