"""Pytrees of tensors in ``jax.tree_util``'s leaf order.

The training state is nested NamedTuples, tuples and dicts, as in the
reference.  Flattening follows JAX's order so a checkpoint's leaf list is
the same in both packages: a NamedTuple's fields and a tuple's or list's
items in order, a dict's values by sorted key, ``None`` an empty node
(no leaf); anything else (a tensor, an array, a number) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


class TreeDef:
    """The structure of a flattened tree: ``unflatten`` rebuilds it."""

    def __init__(self, kind: str, meta: Any, children: Tuple["TreeDef", ...]):
        self.kind = kind          # leaf | none | dict | tuple | list | named
        self.meta = meta          # dict keys or the NamedTuple class
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
        if self.kind == "named":
            return f"{self.meta.__name__}({inner})"
        return f"({inner})" if self.kind == "tuple" else f"[{inner}]"


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def walk(node: Any) -> TreeDef:
        if node is None:
            return TreeDef("none", None, ())
        if isinstance(node, dict):
            keys = sorted(node)
            return TreeDef("dict", keys, tuple(walk(node[k]) for k in keys))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return TreeDef("named", type(node), tuple(walk(v) for v in node))
        if isinstance(node, (tuple, list)):
            return TreeDef("tuple" if isinstance(node, tuple) else "list",
                           None, tuple(walk(v) for v in node))
        leaves.append(node)
        return TreeDef("leaf", None, ())

    spec = walk(tree)
    return leaves, spec


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
