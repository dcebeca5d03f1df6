"""The complex composite: ψ = exp(log|ψ| + i·φ), log|ψ| the log ψ of a
modulus network and φ the raw output of a phase network, each a family
of its own (composite_wavefunction_types = [modulus, phase]).  Its log ψ
is complex; the parameters are real, under 'modulus.' and 'phase.'."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from benchmark.reference import models

Params = Dict[str, torch.Tensor]

COMPLEX_LOG = True


def _part(p: Params, prefix: str) -> Params:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def build(cfg: dict) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    modulus_type, phase_type = cfg['composite_wavefunction_types']
    if (cfg['composite_output_activations'][0] or 'exp') != 'exp':
        raise ValueError("the reference modulus has the 'exp' output only")
    modulus = models.build({**cfg, 'wavefunction_type': modulus_type,
                            'output_activation': 'exp'})
    phase = models.build({**cfg, 'wavefunction_type': phase_type,
                          'output_activation': 'exp'})

    def log_psi(p: Params, s: torch.Tensor) -> torch.Tensor:
        return torch.complex(modulus(_part(p, 'modulus.'), s),
                             phase(_part(p, 'phase.'), s))
    return log_psi
