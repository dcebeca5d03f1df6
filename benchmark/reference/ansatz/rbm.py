"""The RBM: log ψ(s) = s·a + c + Σ_h log cosh((s W + b)_h), with no
feature layers (``num_fc_layers`` 0)."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


def log_cosh(x: torch.Tensor) -> torch.Tensor:
    """log cosh x without overflow: |x| + log(1 + e^{-2|x|}) - log 2."""
    ax = torch.abs(x)
    return ax + torch.log1p(torch.exp(-2.0 * ax)) - math.log(2.0)


def build(cfg: dict) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    if cfg['num_fc_layers'] != 0:
        raise ValueError('the reference RBM has no feature layers')

    def log_psi(p: Params, s: torch.Tensor) -> torch.Tensor:
        theta = s @ p['hidden.w'] + p['hidden.b']
        return (s @ p['onsite.w'][:, 0] + p['onsite.b'][0]
                + log_cosh(theta).sum(-1))
    return log_psi
