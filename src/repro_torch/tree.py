"""Key-path walk of the port's state trees, in the order and with the names
that `jax.tree_util.tree_flatten_with_path` gives the JAX package's.

A node is a dataclass (its fields in declaration order), a NamedTuple (its
fields), a dict (its keys, sorted) or a list / tuple (its items); ``None``
is an empty node, as JAX treats it, so an optional field that is off is no
leaf; anything else is a leaf.  A path is a tuple of steps, each
``("attr", name)``, ``("key", key)`` or ``("idx", i)``.

Checkpoint file names (`checkpoint/checkpoint.py`) and the chaos log
(`runtime/chaos.py`) spell paths as JAX does, so that both frameworks
read each other's checkpoints and write the same log.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

Path = Tuple[Tuple[str, Any], ...]


def _children(node) -> list:
    """(kind, name, child) of a container node in JAX's order; None for a
    leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [("attr", f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("attr", n, getattr(node, n)) for n in node._fields]
    if isinstance(node, dict):
        return [("key", k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [("idx", i, v) for i, v in enumerate(node)]
    return None


def flatten_with_path(tree: Any) -> List[Tuple[Path, Any]]:
    """[(path, leaf), ...] in JAX's leaf order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for kind, name, child in kids:
            walk(child, path + ((kind, name),))
    walk(tree, ())
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template: Any, new_leaves) -> Any:
    """A tree of ``template``'s structure holding ``new_leaves`` in
    `flatten_with_path` order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            return next(it)
        vals = [build(child) for _, _, child in kids]
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(
                node, **{name: v for (_, name, _), v in zip(kids, vals)})
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        if isinstance(node, dict):
            return {name: v for (_, name, _), v in zip(kids, vals)}
        return type(node)(vals)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    return unflatten(tree, [fn(leaf) for leaf in leaves(tree)])


def keystr(path: Path) -> str:
    """`jax.tree_util.keystr` of the same path: ``.ext.eta``, ``['T']``,
    ``[0]``."""
    return "".join(f".{name}" if kind == "attr" else f"[{name!r}]"
                   for kind, name in path)


def key_name(path: Path) -> str:
    """The checkpoint's leaf key: ``state/.ext/.eta``, ``step``, ``b/d/0``
    (JAX's `_flatten`: a field keeps its leading dot, a dict key and an
    index are bare)."""
    return "/".join(f".{name}" if kind == "attr" else str(name)
                    for kind, name in path)
