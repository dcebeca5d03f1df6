"""Bonds and couplings of the Heisenberg models the configurations state:
the periodic chain and the periodic square lattice, site = x * size_y + y
on the square, with nearest-neighbour (J1) bonds and, where
``heisenberg_j2`` is not 0, next-nearest-neighbour (J2) bonds after them.

  H = Σ_b J_b [J_z S^z_i S^z_j + J_x K_b (S^x_i S^x_j + S^y_i S^y_j)],

J_b = 1 on a J1 bond and heisenberg_j2 on a J2 bond; K_b = 1, except
under ``heisenberg_marshall_gauge``, which rotates one sublattice by π
about z: the exchange of a J1 bond (between the sublattices) changes
sign, K_b = −1, and a J2 bond's (within one) does not.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _checked(cfg: dict) -> None:
    """The reference knows the built-in chain and square torus only."""
    if cfg.get('j_file_path'):
        raise ValueError('the reference has no bonds from a j_file_path')
    if cfg.get('lattice_type', '') not in ('', 'auto'):
        raise ValueError(f"no reference lattice {cfg['lattice_type']!r}")
    if cfg.get('twist_phi', 0.0):
        raise ValueError('the reference has no twisted boundaries')
    if cfg.get('hamiltonian_type', 'heisenberg') not in ('', 'heisenberg'):
        raise ValueError('the reference Hamiltonian is Heisenberg only')
    if cfg.get('heisenberg_marshall_gauge') and not cfg.get('heisenberg_j2'):
        raise ValueError('heisenberg_marshall_gauge is for J1-J2 lattices')


def _is_square(cfg: dict) -> bool:
    lx, ly = cfg['size_x'], cfg['size_y']
    return lx > 1 and ly > 1 and lx * ly == cfg['num_sites']


def _next_nearest(cfg: dict) -> list:
    """J2 pairs, each unordered pair once: a plaquette's two diagonals on
    the square torus, (i, i + 2) on the chain."""
    n = cfg['num_sites']
    if _is_square(cfg):
        lx, ly = cfg['size_x'], cfg['size_y']
        candidates = [(x * ly + y, ((x + 1) % lx) * ly + (y + dy) % ly)
                      for x in range(lx) for y in range(ly)
                      for dy in (1, -1)]
    else:
        candidates = [(i, (i + 2) % n) for i in range(n)]
    pairs, seen = [], set()
    for i, j in candidates:
        key = (min(i, j), max(i, j))
        if i != j and key not in seen:
            seen.add(key)
            pairs.append((i, j))
    return pairs


def _pairs(cfg: dict) -> Tuple[list, list]:
    """(J1 pairs, J2 pairs)."""
    _checked(cfg)
    n = cfg['num_sites']
    lx, ly = cfg['size_x'], cfg['size_y']
    if _is_square(cfg):
        nearest = []
        for x in range(lx):
            for y in range(ly):
                here = x * ly + y
                nearest.append((here, ((x + 1) % lx) * ly + y))
                nearest.append((here, x * ly + (y + 1) % ly))
    else:
        nearest = [(i, (i + 1) % n) for i in range(n)]
    return nearest, (_next_nearest(cfg) if cfg.get('heisenberg_j2', 0.0)
                     else [])


def bonds(cfg: dict) -> torch.Tensor:
    """[n_bonds, 2] int64: the square torus when size_x * size_y is the
    number of sites with both sides > 1, else the periodic chain; the J1
    bonds, then the J2 bonds where heisenberg_j2 is not 0."""
    nearest, next_nearest = _pairs(cfg)
    return torch.tensor(nearest + next_nearest, dtype=torch.int64)


def couplings(cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """([n_bonds] J_b, [n_bonds] J_b·K_b) float64, in the order of
    `bonds`: the factors of each bond's diagonal and exchange terms."""
    nearest, next_nearest = _pairs(cfg)
    j2 = float(cfg.get('heisenberg_j2', 0.0))
    j1_exchange = -1.0 if cfg.get('heisenberg_marshall_gauge') else 1.0
    diagonal = [1.0] * len(nearest) + [j2] * len(next_nearest)
    exchange = [j1_exchange] * len(nearest) + [j2] * len(next_nearest)
    return (torch.tensor(diagonal, dtype=torch.float64),
            torch.tensor(exchange, dtype=torch.float64))
