"""log ψ of an ansatz family, from its equations: one file a family under
``ansatz/``, named as the configuration's ``wavefunction_type``.

Parameters are a flat dict keyed by the published path of each leaf
(``'hidden.w'``, ``'conv_0.b'``); boards are ``[batch, n_sites]`` float32
of ±1.  Every family's amplitude has no sign of its own (output
activation 'exp'), so log ψ is the whole answer: real where ψ is
positive, log|ψ| + i·phase where the family says ``COMPLEX_LOG = True``
(``complex.py``).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


def _family(cfg: dict) -> ModuleType:
    family = cfg['wavefunction_type']
    try:
        return importlib.import_module(f'benchmark.reference.ansatz.{family}')
    except ModuleNotFoundError as err:
        raise ValueError(f'no reference for {family!r}') from err


def build(cfg: dict) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """log ψ(params, boards) of the configuration's ansatz."""
    return _family(cfg).build(cfg)


def is_complex(cfg: dict) -> bool:
    """Whether the configuration's ansatz has a complex log ψ."""
    return getattr(_family(cfg), 'COMPLEX_LOG', False)


def chunked(log_psi, p: Params, s: torch.Tensor, rows: int) -> torch.Tensor:
    """log_psi over `s` in blocks of `rows` boards."""
    return torch.cat([log_psi(p, s[i:i + rows])
                      for i in range(0, s.shape[0], rows)])
