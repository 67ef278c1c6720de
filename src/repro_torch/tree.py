"""Trees of tensors: the port's parameters, gradients, optimizer state and
batches are nested dicts, lists and tuples of tensors (``None`` where the
JAX package's tree has an empty subtree, as ``stack["shared_attn"]``)."""
from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_map_with_path", "tree_paths"]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` and the matching entries of
    ``rest``, in a tree of the same structure; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of ``tree``, in insertion order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, tensor)`` over the tensors of ``tree``, in a tree of the
    same structure; paths as :func:`tree_paths` spells them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, _join(path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, _join(path, i)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_paths(tree, path: str = "") -> list:
    """(path, tensor) for every tensor of ``tree``, dict keys in sorted order
    and sequences by index, as ``jax.tree_util`` flattens a tree; a path
    joins the keys and indices with ``/``, as the JAX package's checkpoints
    key their leaves."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in tree_paths(tree[k], _join(path, k))]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree) for e in tree_paths(v, _join(path, i))]
    return [(path, tree)]


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)
