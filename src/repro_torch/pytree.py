"""Pytrees of tensors: nested dicts, lists and tuples (named tuples kept),
as the parameter, cache and optimizer-state trees of the LM stack are."""
from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped pytrees, the structure of
    the first kept; None stays None."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        if isinstance(t0, tuple) and hasattr(t0, "_fields"):
            return type(t0)(*out)
        return type(t0)(out)
    if t0 is None:
        return None
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a pytree in ``tree_map`` order (None skipped)."""
    out = []
    tree_map(out.append, tree)
    return out
