"""Wavefunction ansatz registry and factory (port of
cgs_vmc_tpu/models/__init__.py:49).  The registered single types are
'fully_connected', 'rbm', 'conv_1d', 'conv_2d', 'res_net_1d', 'res_net_2d',
'ed_vector', 'jastrow', 'mps', 'pbdg', 'fully_connected_nnb' and 'gnn';
the composites 'sum', 'diff', 'prod' and 'complex' pair two of them
(``composite_wavefunction_types``, each part with its own output
activation).  Every one is wrapped by the symmetry projection when the
config asks for it.  The autoregressive types ('made', 'pixelcnn',
'transformer') are not ported yet."""

from __future__ import annotations

import dataclasses

from cgs_vmc_tpu_torch.models.base import (
    Params,
    ProductOfWavefunctions,
    ScaledWavefunction,
    SumOfWavefunctions,
    TransformedWavefunction,
    Wavefunction,
    WAVEFUNCTION_TYPES,
    register,
)
# Importing the ansatz modules populates WAVEFUNCTION_TYPES.
from cgs_vmc_tpu_torch.models.complex_phase import (
    ComplexPhaseWavefunction,
    build_complex_wavefunction,
)
from cgs_vmc_tpu_torch.models.conv import (
    Conv1DNetwork,
    Conv2DNetwork,
    ResNet1D,
    ResNet2D,
)
from cgs_vmc_tpu_torch.models.determinant import (
    FullyConnectedNNB,
    ProjectedBDG,
)
from cgs_vmc_tpu_torch.models.feedforward import (
    FullyConnectedNetwork,
    RestrictedBoltzmannNetwork,
)
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.models.graph_conv import GraphConvNetwork
from cgs_vmc_tpu_torch.models.jastrow import JastrowWavefunction
from cgs_vmc_tpu_torch.models.mps import MatrixProductState
from cgs_vmc_tpu_torch.models.symmetry import (
    SymmetrizedWavefunction,
    maybe_symmetrize,
)


COMPOSITE_TYPES = ('sum', 'diff', 'prod', 'complex')


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

    if wf_type == 'complex':
        return maybe_symmetrize(build_complex_wavefunction(config), config)

    if wf_type in COMPOSITE_TYPES:
        type_a, type_b = config.composite_wavefunction_types
        for part in (type_a, type_b):
            if part not in WAVEFUNCTION_TYPES:
                raise _unknown_type(part)
        # Unset activations default to 'exp' (raw log output), as in
        # build_complex_wavefunction.
        act_a, act_b = (a or 'exp' for a in config.composite_output_activations)
        config_a = dataclasses.replace(
            config, wavefunction_type=type_a, output_activation=act_a)
        config_b = dataclasses.replace(
            config, wavefunction_type=type_b, output_activation=act_b)
        wf_a = WAVEFUNCTION_TYPES[type_a].from_config(config_a, name='wf_a')
        wf_b = WAVEFUNCTION_TYPES[type_b].from_config(config_b, name='wf_b')
        if wf_type == 'sum':
            composite = wf_a + wf_b
        elif wf_type == 'diff':
            composite = wf_a - wf_b
        else:
            composite = wf_a * wf_b
        return maybe_symmetrize(composite, config)

    raise _unknown_type(wf_type)


def _unknown_type(wf_type: str) -> NotImplementedError:
    return NotImplementedError(
        f'wavefunction_type {wf_type!r} is not ported yet; the port has '
        f'{sorted(WAVEFUNCTION_TYPES)} + {COMPOSITE_TYPES}. ROADMAP.md lists '
        'the modules still to port, in order.')


__all__ = ['Params', 'Wavefunction', 'WAVEFUNCTION_TYPES', 'register',
           'SumOfWavefunctions', 'ProductOfWavefunctions',
           'ScaledWavefunction', 'TransformedWavefunction',
           'build_wavefunction', 'FullyConnectedNetwork',
           'RestrictedBoltzmannNetwork', 'FullVector',
           'Conv1DNetwork', 'Conv2DNetwork', 'ResNet1D', 'ResNet2D',
           'MatrixProductState', 'ProjectedBDG', 'FullyConnectedNNB',
           'GraphConvNetwork', 'ComplexPhaseWavefunction',
           'JastrowWavefunction',
           'SymmetrizedWavefunction', 'maybe_symmetrize']
