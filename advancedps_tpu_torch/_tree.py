"""Trees of tensors: a tensor, or a tuple, list or dict of trees.

The sweep's particle state, its snapshots and a reference trajectory may be
such trees, each leaf with the particle (or time) axis leading, as the JAX
engine moves any pytree.  A namedtuple is rebuilt as its own type.  Anything
that is not a tuple, list or dict is a leaf.
"""

from __future__ import annotations

import torch

__all__ = ["tree_map", "tree_flatten", "tree_unflatten", "is_tree", "tree_at", "tree_rows",
           "tree_stack", "as_reference"]


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree)


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), children))
    if hasattr(tree, "_fields"):  # a namedtuple
        return type(tree)(*children)
    return type(tree)(children)


def is_tree(x) -> bool:
    """True for a tuple, list or dict (a tree with children), False for a leaf."""
    return isinstance(x, (tuple, list, dict))


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees ``rest`` of the
    same structure; the result has ``tree``'s structure."""
    if not is_tree(tree):
        return fn(tree, *rest)
    kids = _children(tree)
    others = [_children(r) for r in rest]
    if any(len(o) != len(kids) for o in others):
        raise ValueError("trees of different structure")
    return _rebuild(tree, [tree_map(fn, k, *(o[i] for o in others)) for i, k in enumerate(kids)])


def tree_flatten(tree):
    """``(leaves, structure)``: the leaves in order, and what
    :func:`tree_unflatten` needs to rebuild the tree from new leaves."""
    leaves = []
    structure = tree_map(lambda leaf: leaves.append(leaf), tree)
    return leaves, structure


def tree_unflatten(structure, leaves):
    """The tree of ``structure`` (from :func:`tree_flatten`) with ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def tree_at(tree, t):
    """Step ``t`` of a series (a tensor or a tree of ``[T, ...]`` leaves)."""
    return None if tree is None else tree_map(lambda a: a[t], tree)


def tree_rows(tree, idx):
    """The rows ``idx`` of every leaf."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def tree_stack(trees):
    """Trees of one structure stacked leaf by leaf on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def as_reference(ref, device):
    """A reference trajectory on ``device``: a tensor as float32 (as it has
    always been taken), a tree's leaves in their own dtypes."""
    if is_tree(ref):
        return tree_map(lambda a: torch.as_tensor(a, device=device), ref)
    return torch.as_tensor(ref, dtype=torch.float32, device=device)
