"""Pytrees of tensors in ``jax.tree_util``'s leaf order.

The training state is nested NamedTuples, tuples and dicts, as in the
reference.  Flattening follows JAX's order so a checkpoint's leaf list is
the same in both packages: a NamedTuple's fields and a tuple's or list's
items in order, a dict's values by sorted key, a dataclass's fields in
declaration order (the reference registers ``StackState`` as a dataclass
pytree), ``None`` an empty node (no leaf); anything else (a tensor, an
array, a number, a tuple subclass that is not a NamedTuple) is a leaf.

``tree_flatten_with_path`` also gives each leaf its key path, as
``jax.tree_util.tree_flatten_with_path`` does: a dict key or a field
name (a string) or a sequence index (an int) per level.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


class TreeDef:
    """The structure of a flattened tree: ``unflatten`` rebuilds it."""

    def __init__(self, kind: str, meta: Any, children: Tuple["TreeDef", ...]):
        self.kind = kind  # leaf | none | dict | tuple | list | named | data
        self.meta = meta  # dict keys, the NamedTuple or dataclass type
        self.children = children

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def unflatten(self, leaves: List[Any]) -> Any:
        it = iter(leaves)
        out = self._build(it)
        if next(it, None) is not None:
            raise ValueError("more leaves than the tree holds")
        return out

    def _build(self, it) -> Any:
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        items = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, items))
        if self.kind == "named":
            return self.meta(*items)
        if self.kind == "data":
            return self.meta(**{f.name: v for f, v in
                                zip(dataclasses.fields(self.meta), items)})
        return tuple(items) if self.kind == "tuple" else items

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(repr(c) for c in self.children)
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {repr(c)}" for k, c in
                                   zip(self.meta, self.children)) + "}"
        if self.kind in ("named", "data"):
            return f"{self.meta.__name__}({inner})"
        return f"({inner})" if self.kind == "tuple" else f"[{inner}]"


def _walk(node: Any, path: tuple, leaves: List[Tuple[tuple, Any]]
          ) -> TreeDef:
    # a module-level function: a recursive closure would be a reference
    # cycle holding ``leaves`` (and every leaf) until the next gc
    if node is None:
        return TreeDef("none", None, ())
    if isinstance(node, dict):
        keys = sorted(node)
        return TreeDef("dict", keys, tuple(_walk(node[k], path + (k,), leaves)
                                           for k in keys))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return TreeDef("named", type(node), tuple(
            _walk(v, path + (f,), leaves) for f, v in zip(node._fields, node)))
    if type(node) in (tuple, list):
        return TreeDef("tuple" if type(node) is tuple else "list", None,
                       tuple(_walk(v, path + (i,), leaves)
                             for i, v in enumerate(node)))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return TreeDef("data", type(node), tuple(
            _walk(getattr(node, f.name), path + (f.name,), leaves)
            for f in dataclasses.fields(node)))
    leaves.append((path, node))
    return TreeDef("leaf", None, ())


def tree_flatten_with_path(tree: Any
                           ) -> Tuple[List[Tuple[tuple, Any]], TreeDef]:
    """([(key path, leaf), ...], structure) in leaf order."""
    leaves: List[Tuple[tuple, Any]] = []
    spec = _walk(tree, (), leaves)
    return leaves, spec


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    with_path, spec = tree_flatten_with_path(tree)
    return [leaf for _, leaf in with_path], spec


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (of the same structure)."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"trees of {len(leaves)} and {len(o)} leaves")
    return spec.unflatten([fn(*xs) for xs in zip(leaves, *others)])


def tree_map_with_path(fn: Callable[..., Any], tree: Any) -> Any:
    """``fn(key path, leaf)`` over the leaves of ``tree``."""
    with_path, spec = tree_flatten_with_path(tree)
    return spec.unflatten([fn(path, leaf) for path, leaf in with_path])
