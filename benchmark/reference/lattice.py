"""Nearest-neighbour bonds of the periodic chain and the periodic square
lattice, site = x * size_y + y on the square."""

from __future__ import annotations

import torch


def bonds(cfg: dict) -> torch.Tensor:
    """[n_bonds, 2] int64: the square torus when size_x * size_y is the
    number of sites with both sides > 1, else the periodic chain."""
    n = cfg['num_sites']
    lx, ly = cfg['size_x'], cfg['size_y']
    if lx > 1 and ly > 1 and lx * ly == n:
        pairs = []
        for x in range(lx):
            for y in range(ly):
                here = x * ly + y
                pairs.append((here, ((x + 1) % lx) * ly + y))
                pairs.append((here, x * ly + (y + 1) % ly))
        return torch.tensor(pairs, dtype=torch.int64)
    return torch.tensor([(i, (i + 1) % n) for i in range(n)],
                        dtype=torch.int64)
