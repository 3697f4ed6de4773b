"""Parameter trees: nested dicts and lists of tensors.

The port's counterpart of the ``jax.tree`` calls the training path makes.
Leaves come in ``jax.tree_util``'s order (dict keys sorted at every
level, list items in order), and a leaf's path is its keys and list
indices, as ``tree_flatten_with_path`` names them.  Anything that is not
a dict, list or tuple is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def leaves_with_path(tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable = None):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest`` (which follow ``tree``'s structure at least down to its
    leaves, as ``jax.tree.map`` takes them), walked in leaf order.
    ``is_leaf`` stops the walk at a node of ``tree``."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf)
                for k in sorted(tree)}
    out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, v in enumerate(tree)]
    return type(tree)(out) if isinstance(tree, tuple) else out


def unflatten(like, flat: List[Any]):
    """A tree of ``like``'s structure holding ``flat`` in leaf order."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), like)
    end = object()
    if next(it, end) is not end:
        raise ValueError("unflatten: more values than leaves")
    return out
