"""Parameter trees of the port: nested dicts (and lists) of tensors.

The JAX package walks its pytrees with ``jax.tree_util``; these helpers
walk the port's the same way: dict keys in sorted order (JAX's order for
dicts), lists by index, and each leaf's path as JAX's ``keystr`` writes it
(``['blocks']['attn']['wq']``, ``['tail'][0]``), so a path names the same
leaf in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def flatten_with_paths(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)] in JAX's leaf order; a path is the tuple of dict keys
    and list indices from the root."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_paths(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def keystr(path: Path) -> str:
    """JAX's ``keystr`` of a path: ``['key']`` per dict key, ``[i]`` per
    list index."""
    return "".join(f"[{k!r}]" for k in path)


def map_tree(fn: Callable, tree):
    """``fn`` applied to every leaf, in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def unflatten_like(like, new_leaves: list):
    """A tree of ``like``'s structure holding ``new_leaves`` in the order
    of :func:`flatten_with_paths`."""
    new_leaves = list(new_leaves)
    n = len(leaves(like))
    if len(new_leaves) != n:
        raise ValueError(f"unflatten_like: {len(new_leaves)} leaves for a "
                         f"tree of {n}")
    return _rebuild(like, iter(new_leaves))


def _rebuild(tree, it):
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)
