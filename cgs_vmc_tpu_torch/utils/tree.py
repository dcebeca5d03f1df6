"""The one walker of the port's state trees: nested NamedTuples, tuples,
lists and dicts of tensors, generators and plain values (a TrainState, an
epoch's metrics, what pmean / psum and the rank-0 broadcast carry).

The walk visits a dict's values in sorted-key order, so the tensors'
order does not depend on the order keys were inserted in.  Kept apart on
purpose: models/base.py's params walkers (their insertion order fixes the
columns of SR's flat vector) and utils/checkpoint.py's tagged encoders.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


class _Leaf:
    """Where a tensor stood in a flattened tree."""

    def __repr__(self) -> str:
        return '<tensor>'


_LEAF = _Leaf()


def _rebuild(node, walk: Callable[[Any], Any]):
    """`node` with walk applied to its children in walk order, if it is a
    container (each dict keeps its own key order), else `node`."""
    if isinstance(node, dict):
        out = dict.fromkeys(node)
        for key in sorted(node):
            out[key] = walk(node[key])
        return out
    if isinstance(node, tuple) and hasattr(node, '_fields'):
        return type(node)(*(walk(v) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(walk(v) for v in node)
    return node


def _collect(node, kind: type, found: list) -> list:
    """`found` with every `kind` of `node` appended, in walk order; no
    tree is rebuilt."""
    if isinstance(node, kind):
        found.append(node)
    elif isinstance(node, dict):
        for key in sorted(node):
            _collect(node[key], kind, found)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _collect(value, kind, found)
    return found


def flatten(tree) -> Tuple[Any, List[torch.Tensor]]:
    """(skeleton, tensors): `tree` with every tensor replaced by a marker,
    and the tensors in walk order."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return _LEAF
        return _rebuild(node, walk)

    return walk(tree), leaves


def unflatten(skeleton, leaves: List[torch.Tensor]):
    """The inverse of `flatten`."""
    it = iter(leaves)

    def walk(node):
        if node is _LEAF:
            return next(it)
        return _rebuild(node, walk)

    return walk(skeleton)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of `tree`, in `flatten`'s order."""
    return _collect(tree, torch.Tensor, [])


def same_skeleton(a, b) -> bool:
    """Equal structure and equal non-tensor values; a generator must be the
    same object."""
    if isinstance(a, torch.Generator) or isinstance(b, torch.Generator):
        return a is b
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (set(a) == set(b)
                and all(same_skeleton(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_skeleton, a, b))
    return a is b or a == b


def generators(tree) -> List[torch.Generator]:
    """Every generator of a tree or skeleton, in walk order, once each."""
    found: List[torch.Generator] = []
    for g in _collect(tree, torch.Generator, []):
        if all(g is not seen for seen in found):
            found.append(g)
    return found
