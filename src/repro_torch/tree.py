"""Nested dict/list trees of tensors (weights, the adapter store's layout):
the port's counterpart of the ``jax.tree`` functions it needs. Dict keys
are visited in sorted order, as ``jax.tree_util`` visits them, so
``leaves`` and ``map_`` agree on the order of a tree's leaves."""
from __future__ import annotations


def paths(tree, prefix=()):
    """(path, leaf) pairs of a tree, depth first; a path joins the keys and
    list indices with "/" ("stages/0/slot0/attn/wq")."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from paths(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def leaves(tree) -> list:
    """The leaves of ``tree``, depth first."""
    return [leaf for _, leaf in paths(tree)]


def map_(fn, tree, *rest):
    """``fn`` applied leafwise to ``tree`` and trees of its structure,
    leaves visited in the order of ``leaves(tree)``."""
    if isinstance(tree, dict):
        return {k: map_(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [map_(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)])
    return fn(tree, *rest)


def map_with_path(fn, tree, prefix=()):
    """``fn(path, leaf)`` applied leafwise, ``path`` as ``paths`` gives it."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [map_with_path(fn, t, prefix + (str(i),))
                               for i, t in enumerate(tree)])
    return fn("/".join(prefix), tree)


def _rebuild(tree, items: list):
    """A list or tuple of ``tree``'s type holding ``items`` (a NamedTuple,
    such as an optimizer's state, by its fields)."""
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def unflatten(template, leaves_):
    """A tree of ``template``'s structure holding ``leaves_`` in the order
    of ``leaves(template)``."""
    it = iter(leaves_)
    return map_(lambda _: next(it), template)
