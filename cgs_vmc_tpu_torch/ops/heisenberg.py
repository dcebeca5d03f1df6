"""Heisenberg operators with batched connected-configuration evaluation
(port of cgs_vmc_tpu/ops/heisenberg.py).

All spin-exchanged configurations are built as one
[batch, n_bonds, n_sites] tensor and their log-amplitudes come from a single
forward pass over [batch * n_bonds, n_sites].  Conventions:
  diagonal  <R|Sz_i Sz_j|R>               = 0.25 * j_z * s_i * s_j
  off-diag  <R|Sx_i Sx_j + Sy_i Sy_j|psi> = 0.5 * j_x * [s_i != s_j] * psi(R_ij)
so E_loc(R) = Σ_b 0.25 j_z s_i s_j + 0.5 j_x mask_b psi(R_b)/psi(R), with the
ratio taken as sign_b * sign * exp(log_b - log).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


class Operator:
    """Quantum operator protocol: local_value(wf, params, configs, amp)
    returns E_loc(R) = <R|O|psi>/<R|psi>, [batch]."""

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        raise NotImplementedError


class LocalOperator(Operator):
    """<R|O|psi> = diag(R)·psi(R) + Σ_k w_k(R)·psi(R_k).

    Subclasses supply ``diagonal(configs) -> [batch]`` and
    ``connected(configs) -> (configs_k [batch, K, n_sites], weights
    [batch, K])``.  sample_chunk > 0 evaluates the fused connected forward
    pass that many samples at a time, bounding the batch × K fan-out.
    """

    sample_chunk: int = 0

    def diagonal(self, configs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def connected(self, configs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _offdiag_ratio_sum(self, wf: Wavefunction, params: Params,
                           configs: torch.Tensor, amp: LogAmp
                           ) -> torch.Tensor:
        """Σ_k w_k psi(R_k)/psi(R) in one fused forward pass, [batch]."""
        batch, n_sites = configs.shape
        flipped, weights = self.connected(configs)
        n_conn = flipped.shape[1]
        amp_f = wf.apply(params, flipped.reshape(batch * n_conn, n_sites))
        log_f = amp_f.log.reshape(batch, n_conn)
        sign_f = amp_f.sign.reshape(batch, n_conn)
        ratios = (sign_f * amp.sign[:, None]
                  * torch.exp(log_f - amp.log[:, None]))
        return torch.sum(weights * ratios, dim=-1)

    def _local_value(self, wf, params, configs, amp):
        if amp is None:
            amp = wf.apply(params, configs)
        return self.diagonal(configs) + self._offdiag_ratio_sum(
            wf, params, configs, amp)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        chunk = self.sample_chunk
        if not chunk or configs.shape[0] <= chunk:
            return self._local_value(wf, params, configs, amp)
        out = []
        for start in range(0, configs.shape[0], chunk):
            part = slice(start, start + chunk)
            amp_part = (None if amp is None
                        else LogAmp(amp.sign[part], amp.log[part]))
            out.append(self._local_value(wf, params, configs[part],
                                         amp_part))
        return torch.cat(out)


class HeisenbergHamiltonian(LocalOperator):
    """H = Σ_{(i,j) in bonds} J_z Sz_i Sz_j + J_x (Sx_i Sx_j + Sy_i Sy_j)."""

    def __init__(self, bonds: np.ndarray, j_x: float = 1.0, j_z: float = 1.0,
                 sample_chunk: int = 0,
                 couplings: Optional[np.ndarray] = None,
                 offdiag_couplings: Optional[np.ndarray] = None,
                 twist_phases: Optional[np.ndarray] = None):
        """couplings: optional [n_bonds] per-bond factor on both the
        diagonal and off-diagonal elements.  offdiag_couplings: optional
        [n_bonds] factor that replaces ``couplings`` in the off-diagonal
        terms only (e.g. the Marshall-gauged J1-J2 model)."""
        if twist_phases is not None:
            # Twisted boundaries make the connected weights, and so the
            # local values, complex (JAX heisenberg.py:205-213, 250-255).
            raise NotImplementedError(
                'twist_phases is not ported yet (complex local values; '
                'see ROADMAP.md)')
        bonds = np.asarray(bonds, dtype=np.int64)
        if bonds.ndim != 2 or bonds.shape[1] != 2:
            raise ValueError(f'bonds must be [n_bonds, 2], got {bonds.shape}')
        self.bonds = bonds
        self.n_bonds = bonds.shape[0]
        self.j_x = float(j_x)
        self.j_z = float(j_z)
        self.sample_chunk = int(sample_chunk)

        def _check(arr, name):
            if arr is None:
                return None
            arr = np.asarray(arr, np.float32).reshape(-1)
            if arr.shape[0] != self.n_bonds:
                raise ValueError(f'{name} must be [n_bonds={self.n_bonds}], '
                                 f'got {arr.shape}')
            return arr

        self.couplings = _check(couplings, 'couplings')
        self.offdiag_couplings = _check(offdiag_couplings,
                                        'offdiag_couplings')
        self._tables: Dict[torch.device, tuple] = {}

    def _device_tables(self, device: torch.device) -> tuple:
        """(site_i, site_j, couplings, offdiag) as tensors on `device`,
        copied there once."""
        if device not in self._tables:
            def put(arr):
                return None if arr is None else torch.as_tensor(
                    arr, device=device)
            offdiag = (self.offdiag_couplings
                       if self.offdiag_couplings is not None
                       else self.couplings)
            self._tables[device] = (put(self.bonds[:, 0]),
                                    put(self.bonds[:, 1]),
                                    put(self.couplings), put(offdiag))
        return self._tables[device]

    def diagonal(self, configs: torch.Tensor) -> torch.Tensor:
        """Sum of Sz Sz matrix elements, [batch]."""
        site_i, site_j, couplings, _ = self._device_tables(configs.device)
        terms = configs[:, site_i] * configs[:, site_j]
        if couplings is not None:
            terms = terms * couplings
        return 0.25 * self.j_z * torch.sum(terms, dim=-1)

    def connected(self, configs: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All spin-exchanged configurations and their matrix elements.

        Returns:
          flipped: [batch, n_bonds, n_sites] — configs with bond b's spins
              exchanged (identical to configs where the bond is parallel).
          weights: [batch, n_bonds] — 0.5*j_x where antiparallel, else 0.
        """
        site_i, site_j, _, offdiag = self._device_tables(configs.device)
        s_i = configs[:, site_i]                  # [batch, n_bonds]
        s_j = configs[:, site_j]
        bond = torch.arange(self.n_bonds, device=configs.device)
        flipped = configs[:, None, :].repeat(1, self.n_bonds, 1)
        flipped[:, bond, site_i] = s_j
        flipped[:, bond, site_j] = s_i
        weights = 0.5 * self.j_x * (s_i * s_j < 0).to(configs.dtype)
        if offdiag is not None:
            weights = weights * offdiag
        return flipped, weights
