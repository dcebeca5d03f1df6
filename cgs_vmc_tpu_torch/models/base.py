"""Wavefunction protocol (port of cgs_vmc_tpu/models/base.py).

An ansatz holds static hyperparameters; ``init(generator)`` makes its
parameters (a nested dict of tensors with the JAX key names) and
``apply(params, configs)`` is a function of them returning a LogAmp.
The nested-dict helpers below take the place of jax.tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from cgs_vmc_tpu_torch.ops.logamp import LogAmp

Params = Any  # nested dict of tensors


class Wavefunction:
    """Base class: static hyperparameters + init/apply.

    Subclasses implement:
      init(generator) -> Params            # on the generator's device
      apply(params, configs) -> LogAmp     # configs: [batch, n_sites] ±1
    """

    name: str = 'wavefunction'

    def init(self, generator: torch.Generator) -> Params:
        raise NotImplementedError

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        raise NotImplementedError

    def __call__(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return self.apply(params, configs)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'Wavefunction':
        raise NotImplementedError


# Registry of concrete ansatz classes; populated by models/__init__.py.
WAVEFUNCTION_TYPES: Dict[str, type] = {}


def register(type_name: str):
    def wrap(cls):
        WAVEFUNCTION_TYPES[type_name] = cls
        cls.type_name = type_name
        return cls
    return wrap


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """Applies fn leafwise over nested dicts of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Params) -> List[Any]:
    """Leaves in the order tree_map visits them."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Params, leaves: List[Any]) -> Params:
    """Inverse of tree_leaves onto the structure of `template`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
