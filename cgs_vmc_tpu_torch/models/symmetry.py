"""Symmetry projection of wavefunctions, ψ_sym(R) = mean_g ψ(g·R) (port of
cgs_vmc_tpu/models/symmetry.py).

Projects onto the trivial representation of the square lattice's point
group, optionally times the global spin flip.  In log space the orbit
average is a signed logsumexp over the |G| transformed configurations,
evaluated in one batched forward pass of the wrapped ansatz over
[batch·|G|, n_sites].
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction
from cgs_vmc_tpu_torch.ops import logamp
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


class SymmetrizedWavefunction(Wavefunction):
    """Orbit-averages a wrapped ansatz over site permutations.

    perms: [n_ops, n_sites] int — rows are permutations g with
        (g·R)[i] = R[perms[g, i]].
    spin_flip: also average over the global Z2 spin flip R -> -R (doubles
        the orbit; valid in the Sz = 0 sector).
    """

    def __init__(self, wf: Wavefunction, perms: np.ndarray,
                 spin_flip: bool = False,
                 name: str = 'symmetrized_wavefunction'):
        self.name = name
        self._wf = wf
        perms = np.asarray(perms, np.int64)
        if perms.ndim != 2:
            raise ValueError('perms must be [n_ops, n_sites]')
        self.perms = perms
        self.spin_flip = spin_flip
        self.n_ops = perms.shape[0] * (2 if spin_flip else 1)
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def _device_perms(self, device: torch.device) -> torch.Tensor:
        """The permutation table on `device`, copied there once."""
        if device not in self._tables:
            self._tables[device] = torch.as_tensor(self.perms, device=device)
        return self._tables[device]

    def init(self, generator: torch.Generator) -> Params:
        return self._wf.init(generator)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        batch, n_sites = configs.shape
        orbit = configs[:, self._device_perms(configs.device)]
        if self.spin_flip:
            orbit = torch.cat([orbit, -orbit], dim=1)
        amp = self._wf.apply(params, orbit.reshape(batch * self.n_ops,
                                                   n_sites))
        avg = logamp.sum_terms(amp.sign.reshape(batch, self.n_ops),
                               amp.log.reshape(batch, self.n_ops), axis=-1)
        return LogAmp(avg.sign, avg.log - math.log(float(self.n_ops)))


def square_point_group(size_x: int, size_y: int) -> np.ndarray:
    """Site-permutation table of the square-lattice point group.

    Returns [8, n_sites] for size_x == size_y (C4v: rotations + 4
    reflections), else [4, n_sites] (C2v: identity, 180° rotation, x/y
    mirrors), rows in np.unique order as in the JAX package.  Site
    convention: site = x * size_y + y (the conv ansatz's reshape).
    """
    n = size_x * size_y
    grid = np.arange(n).reshape(size_x, size_y)
    ops = [grid]
    if size_x == size_y:
        r90 = np.rot90(grid)
        ops += [r90, np.rot90(r90), np.rot90(np.rot90(r90))]
        ops += [grid.T, np.fliplr(grid), np.flipud(grid),
                np.fliplr(np.flipud(grid)).T]
    else:
        ops += [grid[::-1, ::-1], grid[::-1, :], grid[:, ::-1]]
    perms = np.stack([op.reshape(n) for op in ops])
    # Deduplicate (e.g. 1xL degenerate cases).
    return np.unique(perms, axis=0).astype(np.int32)


def maybe_symmetrize(wf: Wavefunction, config) -> Wavefunction:
    """Wraps `wf` per config.symmetrize_* flags (square lattices only)."""
    if not getattr(config, 'symmetrize', False):
        return wf
    if config.size_x <= 1 or config.size_y <= 1:
        raise ValueError('symmetrize requires a 2-D lattice '
                         '(size_x, size_y > 1)')
    perms = square_point_group(config.size_x, config.size_y)
    return SymmetrizedWavefunction(
        wf, perms, spin_flip=getattr(config, 'symmetrize_spin_flip', True))
