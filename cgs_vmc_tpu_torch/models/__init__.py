"""Wavefunction ansatz registry and factory (port of
cgs_vmc_tpu/models/__init__.py:49: the registered single types ported so
far — 'fully_connected', 'rbm', 'conv_1d', 'conv_2d', 'res_net_1d',
'res_net_2d', 'ed_vector' — each wrapped by the symmetry projection when
the config asks for it)."""

from __future__ import annotations

from cgs_vmc_tpu_torch.models.base import (
    Params,
    Wavefunction,
    WAVEFUNCTION_TYPES,
    register,
)
# Importing the ansatz modules populates WAVEFUNCTION_TYPES.
from cgs_vmc_tpu_torch.models.conv import (
    Conv1DNetwork,
    Conv2DNetwork,
    ResNet1D,
    ResNet2D,
)
from cgs_vmc_tpu_torch.models.feedforward import (
    FullyConnectedNetwork,
    RestrictedBoltzmannNetwork,
)
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.models.symmetry import (
    SymmetrizedWavefunction,
    maybe_symmetrize,
)


def build_wavefunction(config) -> Wavefunction:
    """Builds the ansatz requested by ``config.wavefunction_type``.

    Raises:
      NotImplementedError: a type the JAX package has but the port does
        not yet (ROADMAP.md lists the order they are ported in).
    """
    wf_type = config.wavefunction_type
    if wf_type in WAVEFUNCTION_TYPES:
        return maybe_symmetrize(
            WAVEFUNCTION_TYPES[wf_type].from_config(config), config)
    raise NotImplementedError(
        f'wavefunction_type {wf_type!r} is not ported yet; the port has '
        f'{sorted(WAVEFUNCTION_TYPES)}. ROADMAP.md lists the modules still '
        'to port, in order.')


__all__ = ['Params', 'Wavefunction', 'WAVEFUNCTION_TYPES', 'register',
           'build_wavefunction', 'FullyConnectedNetwork',
           'RestrictedBoltzmannNetwork', 'FullVector',
           'Conv1DNetwork', 'Conv2DNetwork', 'ResNet1D', 'ResNet2D',
           'SymmetrizedWavefunction', 'maybe_symmetrize']
