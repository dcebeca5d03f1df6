"""The Heisenberg local energy, E_loc(s) = <s|H|ψ> / <s|ψ>, for
H = Σ_bonds J_z S^z_i S^z_j + J_x (S^x_i S^x_j + S^y_i S^y_j):

  E_loc(s) = Σ_b J_z/4 · s_i s_j + Σ_{b: s_i ≠ s_j} J_x/2 · ψ(s^b) / ψ(s),

with s^b the board with the spins of bond b exchanged.  Only the
antiparallel bonds connect, so only they are evaluated.
"""

from __future__ import annotations

import torch

from benchmark.reference import models


def antiparallel(s: torch.Tensor, bonds: torch.Tensor) -> torch.Tensor:
    """[batch, n_bonds] bool: the bonds whose two spins differ."""
    return s[:, bonds[:, 0]] != s[:, bonds[:, 1]]


def local_energy(log_psi, p: models.Params, s: torch.Tensor,
                 bonds: torch.Tensor, j_x: float, j_z: float,
                 rows: int) -> torch.Tensor:
    """[batch] local energies; ψ evaluated `rows` boards at a time."""
    bonds = bonds.to(s.device)
    si, sj = s[:, bonds[:, 0]], s[:, bonds[:, 1]]
    diagonal = 0.25 * j_z * (si * sj).sum(-1)
    board, bond = antiparallel(s, bonds).nonzero(as_tuple=True)
    exchanged = s[board].clone()
    rows_idx = torch.arange(board.shape[0], device=s.device)
    exchanged[rows_idx, bonds[bond, 0]] *= -1.0
    exchanged[rows_idx, bonds[bond, 1]] *= -1.0
    log_s = models.chunked(log_psi, p, s, rows)
    log_x = models.chunked(log_psi, p, exchanged, rows)
    ratio = torch.exp(log_x - log_s[board])
    off = torch.zeros_like(diagonal).index_add_(0, board,
                                                0.5 * j_x * ratio)
    return diagonal + off
