"""Transverse-field Ising model, the second Hamiltonian family (port of
cgs_vmc_tpu/ops/ising.py).

Pauli convention (sigma = 2S), the standard TFIM form:

    H = - J sum_{(i,j) in bonds} sigma^z_i sigma^z_j
        - h sum_i sigma^x_i

so for spin values s = ±1:
    diagonal(R)        = -J sum_b c_b s_i s_j
    <R^(i)|H|psi>-term = -h psi(R^(i)),  R^(i) = R with spin i flipped.

The model does not conserve Sz: it is sampled over the full 2^N space with
the single-spin-flip move (sampler/metropolis.py, ``mc_move_type='flip'``).
For J > 0 and h > 0 every off-diagonal element is -h < 0, so the ground
state is positive in this basis and any positive ansatz represents it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch.ops.heisenberg import LocalOperator


class TransverseFieldIsingHamiltonian(LocalOperator):
    """H = -J sum_bonds sigma^z sigma^z - h sum_i sigma^x (Pauli convention).

    Args:
      bonds: [n_bonds, 2] int site pairs for the ZZ coupling.
      h_x: transverse field strength h.
      j_zz: ZZ coupling J (J > 0 ferromagnetic).
      sample_chunk: see LocalOperator (fan-out here is batch × n_sites).
      couplings: optional [n_bonds] per-bond factor multiplying J.
    """

    def __init__(self, bonds: np.ndarray, h_x: float = 1.0,
                 j_zz: float = 1.0, sample_chunk: int = 0,
                 couplings: Optional[np.ndarray] = None):
        bonds = np.asarray(bonds, dtype=np.int64)
        if bonds.ndim != 2 or bonds.shape[1] != 2:
            raise ValueError(f'bonds must be [n_bonds, 2], got {bonds.shape}')
        self.bonds = bonds
        self.n_bonds = bonds.shape[0]
        self.h_x = float(h_x)
        self.j_zz = float(j_zz)
        self.sample_chunk = int(sample_chunk)
        if couplings is not None:
            couplings = np.asarray(couplings, np.float32).reshape(-1)
            if couplings.shape[0] != self.n_bonds:
                raise ValueError(
                    f'couplings must be [n_bonds={self.n_bonds}], '
                    f'got {couplings.shape}')
        self.couplings = couplings
        self._tables: Dict[torch.device, tuple] = {}

    def _device_tables(self, device: torch.device) -> tuple:
        """(site_i, site_j, couplings) as tensors on `device`, copied
        there once."""
        if device not in self._tables:
            def put(arr):
                return None if arr is None else torch.as_tensor(
                    arr, device=device)
            self._tables[device] = (put(self.bonds[:, 0]),
                                    put(self.bonds[:, 1]),
                                    put(self.couplings))
        return self._tables[device]

    def diagonal(self, configs: torch.Tensor) -> torch.Tensor:
        """-J sum_b c_b s_i s_j, [batch]."""
        site_i, site_j, couplings = self._device_tables(configs.device)
        terms = configs[:, site_i] * configs[:, site_j]
        if couplings is not None:
            terms = terms * couplings
        return -self.j_zz * torch.sum(terms, dim=-1)

    def connected(self, configs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All single-spin-flip configurations, each with weight -h.

        Returns:
          flipped: [batch, n_sites, n_sites] — configs with site k flipped.
          weights: [batch, n_sites] — constant -h.
        """
        batch, n_sites = configs.shape
        sign_flip = 1.0 - 2.0 * torch.eye(n_sites, dtype=configs.dtype,
                                          device=configs.device)
        flipped = configs[:, None, :] * sign_flip[None]
        weights = torch.full((batch, n_sites), -self.h_x,
                             dtype=configs.dtype, device=configs.device)
        return flipped, weights
