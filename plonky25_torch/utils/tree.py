"""Map a function over the tensors of a nested structure: dicts, lists,
tuples and the GL/GL2 named tuples (the port's jax.tree.map)."""

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
