"""The port's parameter, gradient and optimizer-state trees: nested
dicts, lists and tuples whose leaves are tensors — the counterpart of
``jax.tree`` for the training path.  Leaves come in insertion order;
a leaf's path key joins its dict keys and sequence indices with ``/``
(``layers/3/mix/wq``), as the JAX package's checkpoint manifest does.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def leaves_with_paths(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))


def leaves(tree, like=None) -> list:
    """The leaves of ``tree`` in order.  Given ``like``, a tree that
    ``tree`` mirrors down to ``like``'s leaves: the entries of ``tree``
    at those places, whatever they hold (a tree of layouts, each leaf's
    a tuple, as a list in ``like``'s leaf order)."""
    if like is None:
        return [leaf for _, leaf in leaves_with_paths(tree)]
    out: list = []
    map_tree(lambda _, entry: out.append(entry), like, tree)
    return out


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a tree of the results."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
