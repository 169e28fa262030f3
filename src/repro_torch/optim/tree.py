"""A small tree walk for the port's parameter and optimizer-state trees.

The reference maps over pytrees with ``jax.tree``; the port's trees are
lists and tuples (the ConvNet's ``[(w, b) | None]``), named tuples
(``QTensor``), dicts and tensor leaves.  ``None`` is an empty subtree, as
in ``jax.tree``: it holds no leaf and maps to ``None``.  Dict keys are
walked in sorted order, so ``leaves`` lists leaves in the reference's
order.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> List[Any]:
    """The leaves of ``tree`` in order (``None`` holds none)."""
    out: List[Any] = []

    def walk(t):
        if t is None:
            return
        if is_leaf is not None and is_leaf(t):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for c in t:
                walk(c)
        else:
            out.append(t)

    walk(tree)
    return out


def unflatten(like: Any, values, is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``like``'s structure with its leaves replaced, in order, by ``values``."""
    it = iter(values)

    def build(t):
        if t is None:
            return None
        if is_leaf is not None and is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(c) for c in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(c) for c in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure up to ``tree``'s leaves)."""
    cols = [leaves(tree, is_leaf)] + [leaves(r, is_leaf) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees disagree in their number of leaves")
    return unflatten(tree, [fn(*args) for args in zip(*cols)], is_leaf)
