"""The fully connected network: num_fc_layers × (Dense, then the
nonlinearity), then a Dense to one output, whose value is log ψ ('exp'
output)."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_ACTIVATIONS = {'relu': torch.relu, 'tanh': torch.tanh,
                'selu': F.selu, 'sigmoid': torch.sigmoid}


def build(cfg: dict) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    if cfg['output_activation'] != 'exp':
        raise ValueError("the reference network has the 'exp' output only")
    act = _ACTIVATIONS[cfg['nonlinearity']]
    layers = cfg['num_fc_layers']

    def log_psi(p: Params, s: torch.Tensor) -> torch.Tensor:
        h = s
        for i in range(layers):
            h = act(h @ p[f'dense_{i}.w'] + p[f'dense_{i}.b'])
        return h @ p['out.w'][:, 0] + p['out.b'][0]
    return log_psi
