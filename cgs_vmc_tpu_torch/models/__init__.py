"""Wavefunction ansatz registry and factory (port of
cgs_vmc_tpu/models/__init__.py:49, the 'rbm' type only)."""

from __future__ import annotations

from cgs_vmc_tpu_torch.models.base import (
    Params,
    Wavefunction,
    WAVEFUNCTION_TYPES,
    register,
)
# Importing the ansatz modules populates WAVEFUNCTION_TYPES.
from cgs_vmc_tpu_torch.models.feedforward import RestrictedBoltzmannNetwork


def build_wavefunction(config) -> Wavefunction:
    """Builds the ansatz requested by ``config.wavefunction_type``.

    Raises:
      NotImplementedError: a type the JAX package has but the port does
        not yet (ROADMAP.md lists the order they are ported in).
    """
    wf_type = config.wavefunction_type
    if getattr(config, 'symmetrize', False):
        raise NotImplementedError(
            'symmetrize=true is not ported yet (slice 2 in ROADMAP.md)')
    if wf_type in WAVEFUNCTION_TYPES:
        return WAVEFUNCTION_TYPES[wf_type].from_config(config)
    raise NotImplementedError(
        f'wavefunction_type {wf_type!r} is not ported yet; the port has '
        f'{sorted(WAVEFUNCTION_TYPES)}. ROADMAP.md lists the modules still '
        'to port, in order.')


__all__ = ['Params', 'Wavefunction', 'WAVEFUNCTION_TYPES', 'register',
           'build_wavefunction', 'RestrictedBoltzmannNetwork']
