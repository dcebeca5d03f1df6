"""Wavefunction protocol (port of cgs_vmc_tpu/models/base.py).

An ansatz holds static hyperparameters; ``init(generator)`` makes its
parameters (a nested dict of tensors with the JAX key names) and
``apply(params, configs)`` is a function of them returning a LogAmp.
Wavefunction algebra (``+``, ``-``, ``*``) combines two ansatzes in the
log domain; a composite's params are the nested ``{'a': ..., 'b': ...}``.
The nested-dict helpers below take the place of jax.tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from cgs_vmc_tpu_torch.ops import logamp
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

    # Wavefunction algebra, in the log domain.

    def __add__(self, other: 'Wavefunction') -> 'Wavefunction':
        return SumOfWavefunctions(self, other)

    def __sub__(self, other: 'Wavefunction') -> 'Wavefunction':
        return SumOfWavefunctions(self, other, sign_b=-1.0)

    def __mul__(self, other) -> 'Wavefunction':
        if isinstance(other, Wavefunction):
            return ProductOfWavefunctions(self, other)
        return ScaledWavefunction(self, float(other))

    __rmul__ = __mul__


class _PairOfWavefunctions(Wavefunction):
    """Two ansatzes with params ``{'a': ..., 'b': ...}``, both made from
    the one generator (a first, then b)."""

    def __init__(self, wf_a: Wavefunction, wf_b: Wavefunction, name: str):
        self.name = name
        self._wf_a = wf_a
        self._wf_b = wf_b

    def init(self, generator: torch.Generator) -> Params:
        return {'a': self._wf_a.init(generator),
                'b': self._wf_b.init(generator)}


class SumOfWavefunctions(_PairOfWavefunctions):
    """psi_a + sign_b * psi_b via cancellation-safe signed logsumexp."""

    def __init__(self, wf_a: Wavefunction, wf_b: Wavefunction,
                 sign_b: float = 1.0, name: str = 'sum_of_wavefunctions'):
        super().__init__(wf_a, wf_b, name)
        self._sign_b = sign_b

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        amp_a = self._wf_a.apply(params['a'], configs)
        amp_b = self._wf_b.apply(params['b'], configs)
        return logamp.add(
            amp_a, LogAmp(self._sign_b * amp_b.sign, amp_b.log))


class ProductOfWavefunctions(_PairOfWavefunctions):
    """psi_a * psi_b: signs multiply, logs add."""

    def __init__(self, wf_a: Wavefunction, wf_b: Wavefunction,
                 name: str = 'product_of_wavefunctions'):
        super().__init__(wf_a, wf_b, name)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        amp_a = self._wf_a.apply(params['a'], configs)
        amp_b = self._wf_b.apply(params['b'], configs)
        return logamp.mul(amp_a, amp_b)


class ScaledWavefunction(Wavefunction):
    """psi * c for a real constant c."""

    def __init__(self, wf: Wavefunction, factor: float,
                 name: str = 'scaled_wavefunction'):
        self.name = name
        self._wf = wf
        self._factor = factor

    def init(self, generator: torch.Generator) -> Params:
        return self._wf.init(generator)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return logamp.scale(self._wf.apply(params, configs), self._factor)


class TransformedWavefunction(Wavefunction):
    """O|psi> wrapped as a wavefunction: `transform(params, configs) ->
    LogAmp` is a closure over the operator, built by `Operator.apply`."""

    def __init__(self, transform: Callable[[Params, torch.Tensor], LogAmp],
                 wf: Wavefunction, name: str = 'transformed_wavefunction'):
        self.name = name
        self._wf = wf
        self._transform = transform

    def init(self, generator: torch.Generator) -> Params:
        return self._wf.init(generator)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return self._transform(params, configs)


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
