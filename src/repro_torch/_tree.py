"""A small explicit pytree: flatten, name and rebuild nested state.

The port's stand-in for ``jax.tree_util`` where the runtime and the
checkpoint manager need one (``torch.utils._pytree`` is private).
Containers: tuples, lists, dicts (keys in sorted order, as JAX orders
them), ``None`` (no leaves) and the classes registered with
``register_node`` (``RunState``, ``CommLedger``). Anything else is a leaf:
tensors, numpy arrays, Python and numpy scalars.

A leaf's name is the ``/``-joined path of dict keys and child indices, the
names the reference's checkpoint manager writes into its manifests, so the
two packages name the same state alike.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

__all__ = ["register_node", "flatten_with_names", "unflatten", "tree_leaves"]

# cls -> (flatten: obj -> (children tuple, aux), unflatten: (aux, children) -> obj)
_NODES: Dict[type, Tuple[Callable, Callable]] = {}


def register_node(cls: type, flatten: Callable, unflatten: Callable) -> None:
    _NODES[cls] = (flatten, unflatten)


def _flatten(tree, path: str, names: List[str], leaves: List[Any]):
    """Append ``tree``'s leaves and names; return its structure."""
    def child(key, sub):
        return _flatten(sub, f"{path}/{key}" if path else str(key), names,
                        leaves)

    if tree is None:
        return ("none",)
    if type(tree) in _NODES:
        children, aux = _NODES[type(tree)][0](tree)
        return ("node", type(tree), aux,
                [child(i, c) for i, c in enumerate(children)])
    if isinstance(tree, (tuple, list)):
        return (type(tree), [child(i, c) for i, c in enumerate(tree)])
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys, [child(k, tree[k]) for k in keys])
    names.append(path)
    leaves.append(tree)
    return ("leaf",)


def flatten_with_names(tree) -> Tuple[List[str], List[Any], Any]:
    """(names, leaves, structure) of ``tree``, leaves in a fixed order."""
    names: List[str] = []
    leaves: List[Any] = []
    structure = _flatten(tree, "", names, leaves)
    return names, leaves, structure


def unflatten(structure, leaves: List[Any]):
    """Rebuild a tree of ``structure`` from ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "node":
            _, cls, aux, subs = node
            return _NODES[cls][1](aux, tuple(build(s) for s in subs))
        if kind == "dict":
            return {k: build(s) for k, s in zip(node[1], node[2])}
        return kind(build(s) for s in node[1])

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_leaves(tree) -> List[Any]:
    return flatten_with_names(tree)[1]
