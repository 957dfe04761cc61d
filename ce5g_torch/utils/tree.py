"""Key paths over nested dicts, lists, tuples and NamedTuples: the
containers ``jax.tree_util`` flattens, with its leaf order (dict keys
sorted) and its ``keystr`` names (``['key']``, ``[0]``, ``.field``)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) of every leaf, in ``jax.tree_util`` order. ``None``
    is an empty subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from leaves_with_path(getattr(tree, field), f"{path}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from leaves_with_path(item, f"{path}[{i}]")
    else:
        yield path, tree


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf, the containers rebuilt around them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)
