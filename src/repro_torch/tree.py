"""Trees of tensors in the JAX package's order.

The LM half of the port keeps parameters, optimizer states and checkpoints
as plain nested containers of tensors (dicts, lists, tuples, NamedTuples),
as the JAX package keeps pytrees. Their leaves are visited in JAX's order:
dict keys sorted, sequences and NamedTuple fields in order, ``None`` an
empty subtree. So leaf *i* of a tree here is leaf *i* of the same tree in
the JAX package, which the checkpoints, the optimizers' per-leaf draws and
the K-FAC leaf names rely on.

A path is a tuple of ``(kind, entry)`` steps, ``kind`` one of ``"key"``
(a dict key), ``"idx"`` (a sequence index) or ``"name"`` (a NamedTuple
field), as JAX's ``DictKey`` / ``SequenceKey`` / ``GetAttrKey``.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in JAX's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], path + (("key", k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += flatten_with_path(getattr(tree, f), path + (("name", f),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += flatten_with_path(x, path + (("idx", i),))
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in order."""
    it = iter(new_leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def _build(t, it):
    # module-level: a nested function that calls itself is a reference
    # cycle, which would hold the leaves (tensors) until the cyclic garbage
    # collector runs
    if t is None:
        return None
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if _is_namedtuple(t):
        return type(t)(*(_build(getattr(t, f), it) for f in t._fields))
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` applied to every leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def path_str(path: tuple, sep: str) -> str:
    """Entries of a path joined by ``sep`` (``"a/0/wq"``)."""
    return sep.join(str(entry) for _, entry in path)


def describe(tree) -> str:
    """A one-line picture of the structure, leaves as ``*`` (the port's
    counterpart of the ``treedef`` string in a checkpoint manifest)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={describe(getattr(tree, f))}" for f in tree._fields) + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(describe(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(describe(x) for x in tree) + ")"
    return "*"
