"""The Heisenberg local energy, E_loc(s) = <s|H|ψ> / <s|ψ>, for
H = Σ_b J_b [J_z S^z_i S^z_j + J_x K_b (S^x_i S^x_j + S^y_i S^y_j)]
(lattice.py gives each bond's J_b and J_b·K_b):

  E_loc(s) = Σ_b J_b J_z/4 · s_i s_j
             + Σ_{b: s_i ≠ s_j} J_b K_b J_x/2 · ψ(s^b) / ψ(s),

with s^b the board with the spins of bond b exchanged and
ψ(s^b) / ψ(s) = exp(log ψ(s^b) − log ψ(s)).  Only the antiparallel bonds
connect, so only they are evaluated.  A complex log ψ (log|ψ| + i·phase)
gives complex ratios and a complex local energy, nothing of it forced to
be real.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference import models


def antiparallel(s: torch.Tensor, bonds: torch.Tensor) -> torch.Tensor:
    """[batch, n_bonds] bool: the bonds whose two spins differ."""
    return s[:, bonds[:, 0]] != s[:, bonds[:, 1]]


def local_energy(log_psi, p: models.Params, s: torch.Tensor,
                 bonds: torch.Tensor, j_x: float, j_z: float, rows: int,
                 couplings: Tuple[torch.Tensor, torch.Tensor]
                 ) -> torch.Tensor:
    """[batch] local energies, complex where log ψ is; ψ evaluated `rows`
    boards at a time.  couplings: ([n_bonds] J_b, [n_bonds] J_b·K_b)
    (lattice.couplings)."""
    bonds = bonds.to(s.device)
    diagonal_j, exchange_j = (c.to(s.device, s.dtype) for c in couplings)
    si, sj = s[:, bonds[:, 0]], s[:, bonds[:, 1]]
    diagonal = 0.25 * j_z * (si * sj * diagonal_j).sum(-1)
    board, bond = antiparallel(s, bonds).nonzero(as_tuple=True)
    exchanged = s[board].clone()
    rows_idx = torch.arange(board.shape[0], device=s.device)
    exchanged[rows_idx, bonds[bond, 0]] *= -1.0
    exchanged[rows_idx, bonds[bond, 1]] *= -1.0
    log_s = models.chunked(log_psi, p, s, rows)
    log_x = models.chunked(log_psi, p, exchanged, rows)
    ratio = torch.exp(log_x - log_s[board])
    off = torch.zeros(diagonal.shape, dtype=ratio.dtype,
                      device=s.device).index_add_(
                          0, board, 0.5 * j_x * exchange_j[bond] * ratio)
    return diagonal + off
