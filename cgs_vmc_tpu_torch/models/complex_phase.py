"""Complex-phase wavefunctions: psi = sign_m * exp(log|psi| + i*phi) (port
of cgs_vmc_tpu/models/complex_phase.py).

The modulus network contributes (sign, log|psi|) exactly as any real
ansatz; the phase network's raw output (its ``.log`` under the 'exp'
activation) is the phase phi, carried in the imaginary part of a complex64
``LogAmp.log``.  Everything downstream takes the complex log as it is:
Metropolis reads ``log.real``, the local energy takes a complex ``exp``,
and the optimizers differentiate the real and imaginary parts as two real
outputs (optim/common.log_amp_phase_pullback), so no complex cotangent
ever enters autograd.
"""

from __future__ import annotations

import dataclasses

import torch

from cgs_vmc_tpu_torch.models.base import (
    Params, Wavefunction, WAVEFUNCTION_TYPES, tree_leaves)
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


class ComplexPhaseWavefunction(Wavefunction):
    """Pairs a modulus ansatz with a phase ansatz.

    The phase network is built with output_activation='exp' so its
    ``apply(...).log`` is the raw network output, used directly as phi
    (radians, unconstrained: exp(i*phi) is periodic by itself).  Params
    are ``{'modulus': ..., 'phase': ...}``.
    """

    def __init__(self, modulus_wf: Wavefunction, phase_wf: Wavefunction,
                 name: str = 'complex_phase'):
        self.name = name
        self._modulus = modulus_wf
        self._phase = phase_wf

    def init(self, generator: torch.Generator) -> Params:
        return {'modulus': self._modulus.init(generator),
                'phase': self._phase.init(generator)}

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        mod = self._modulus.apply(params['modulus'], configs)
        phi = self._phase.apply(params['phase'], configs).log
        return LogAmp(mod.sign, torch.complex(mod.log, phi.to(mod.log.dtype)))


def build_complex_wavefunction(config) -> ComplexPhaseWavefunction:
    """Factory for the composite type 'complex':
    composite_wavefunction_types = (modulus_type, phase_type);
    composite_output_activations[0] applies to the modulus part, the phase
    part is forced to 'exp' (raw log output = phase)."""
    type_m, type_p = config.composite_wavefunction_types
    act_m = config.composite_output_activations[0] or 'exp'
    config_m = dataclasses.replace(
        config, wavefunction_type=type_m, output_activation=act_m)
    config_p = dataclasses.replace(
        config, wavefunction_type=type_p, output_activation='exp')
    modulus = WAVEFUNCTION_TYPES[type_m].from_config(config_m, name='modulus')
    phase = WAVEFUNCTION_TYPES[type_p].from_config(config_p, name='phase')
    return ComplexPhaseWavefunction(modulus, phase)


def is_complex(wf: Wavefunction, params: Params, n_sites: int) -> bool:
    """Whether the ansatz emits complex logs, from one dummy configuration
    (all spins up) on the params' device."""
    leaf = tree_leaves(params)[0]
    dummy = torch.ones((1, n_sites), dtype=torch.float32, device=leaf.device)
    with torch.no_grad():
        return wf.apply(params, dummy).log.is_complex()
