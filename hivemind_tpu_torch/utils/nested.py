"""Nested structure flatten/pack/map (the port's own copy of
hivemind_tpu/utils/nested.py): leaves of dicts, lists and tuples in a deterministic
order (dict keys sorted), packed back into a structure, mapped leaf by leaf, and
structures compared by their nesting. Used for host-side structures such as RPC
tensor lists and state trees.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def nested_flatten(t: Any) -> Iterator[Any]:
    """Yield leaves of a nested structure of dicts/lists/tuples in deterministic order."""
    if isinstance(t, (list, tuple)):
        for item in t:
            yield from nested_flatten(item)
    elif isinstance(t, dict):
        for key in sorted(t):
            yield from nested_flatten(t[key])
    else:
        yield t


def nested_pack(flat: Any, structure: Any) -> Any:
    """Inverse of nested_flatten: arrange leaves from ``flat`` into the shape of ``structure``."""
    return _nested_pack(iter(flat), structure)


def _nested_pack(flat_iter: Iterator[Any], structure: Any) -> Any:
    if isinstance(structure, (list, tuple)):
        return type(structure)(_nested_pack(flat_iter, item) for item in structure)
    if isinstance(structure, dict):
        return {key: _nested_pack(flat_iter, structure[key]) for key in sorted(structure)}
    return next(flat_iter)


def nested_map(fn: Callable[[Any], Any], *structures: Any) -> Any:
    """Apply fn to corresponding leaves of one or more identically-shaped structures."""
    if not structures:
        raise ValueError("nested_map needs at least one structure")
    head = structures[0]
    if isinstance(head, (list, tuple)):
        return type(head)(nested_map(fn, *items) for items in zip(*structures))
    if isinstance(head, dict):
        return {key: nested_map(fn, *(s[key] for s in structures)) for key in sorted(head)}
    return fn(*structures)


def nested_compare(t: Any, u: Any) -> bool:
    """True if two structures have the same nesting (leaf values are not compared)."""
    if isinstance(t, (list, tuple)) and isinstance(u, (list, tuple)):
        return type(t) == type(u) and len(t) == len(u) and all(
            nested_compare(a, b) for a, b in zip(t, u)
        )
    if isinstance(t, dict) and isinstance(u, dict):
        return t.keys() == u.keys() and all(nested_compare(t[k], u[k]) for k in t)
    return not isinstance(t, (list, tuple, dict)) and not isinstance(u, (list, tuple, dict))
