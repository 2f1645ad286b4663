"""Map a function over the tensors of a nested structure, list them, or
describe its shape: dicts, lists, tuples and the GL/GL2 named tuples (the
port's jax.tree.map, jax.tree.leaves and jax.tree.structure with the
leaves' shapes)."""

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


def tree_signature(tree):
    """A hashable description of `tree`: its containers (dict keys, list
    and tuple lengths, named-tuple types) and each tensor's shape and
    dtype.  Two trees with one signature fit the same static buffers."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, tree_signature(v))
                                 for k, v in sorted(tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(map(tree_signature, tree))
    raise TypeError(f"cannot describe {type(tree).__name__}")
