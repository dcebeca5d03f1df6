"""Heisenberg operators with batched connected-configuration evaluation
(port of cgs_vmc_tpu/ops/heisenberg.py).

All spin-exchanged configurations are built as one
[batch, n_bonds, n_sites] tensor and their log-amplitudes come from a single
forward pass over [batch * n_bonds, n_sites].  Conventions:
  diagonal  <R|Sz_i Sz_j|R>               = 0.25 * j_z * s_i * s_j
  off-diag  <R|Sx_i Sx_j + Sy_i Sy_j|psi> = 0.5 * j_x * [s_i != s_j] * psi(R_ij)
so E_loc(R) = Σ_b 0.25 j_z s_i s_j + 0.5 j_x mask_b psi(R_b)/psi(R), with the
ratio taken as sign_b * sign * exp(log_b - log).  With a complex log (a
complex-phase ansatz) or complex weights (twisted boundaries) the ratios,
and so the local values, are complex64.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import (
    Params, TransformedWavefunction, Wavefunction)
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


def _scaled(amp: LogAmp, factor: torch.Tensor) -> LogAmp:
    """psi * factor per sample; torch.sgn is z/|z| for a complex factor
    (a unit phase carried in ``sign``) and the real sign otherwise."""
    return LogAmp(amp.sign * torch.sgn(factor),
                  amp.log + torch.log(torch.abs(factor)))


class Operator:
    """Quantum operator protocol, log-domain.

    local_value: E_loc(R) = <R|O|psi>/<R|psi>            -> [batch]
    apply_in_place: <R|O|psi> as a LogAmp                 -> LogAmp
    apply: O|psi> wrapped as a Wavefunction.
    """

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        raise NotImplementedError

    def apply_in_place(self, wf: Wavefunction, params: Params,
                       configs: torch.Tensor, amp: Optional[LogAmp] = None
                       ) -> LogAmp:
        raise NotImplementedError

    def apply(self, wf: Wavefunction) -> Wavefunction:
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

    def apply_in_place(self, wf: Wavefunction, params: Params,
                       configs: torch.Tensor, amp: Optional[LogAmp] = None
                       ) -> LogAmp:
        """<R|O|psi> = psi(R) * O_loc(R) as a LogAmp."""
        if amp is None:
            amp = wf.apply(params, configs)
        return _scaled(amp, self.local_value(wf, params, configs, amp))

    def apply(self, wf: Wavefunction) -> Wavefunction:
        def transform(params: Params, configs: torch.Tensor) -> LogAmp:
            return self.apply_in_place(wf, params, configs)
        return TransformedWavefunction(transform, wf, name='o_applied')


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
        terms only (e.g. the Marshall-gauged J1-J2 model).  twist_phases:
        optional [n_bonds] gauge phases delta_b = theta_i - theta_j of
        twisted boundary conditions (lattice.twist_phases): the exchange
        term becomes J_x/2 (e^{i delta_b} S+_i S-_j + h.c.), so the
        connected weight picks up exp(i delta_b (s_i - s_j)/2) and the
        local values are complex.  The curvature of E(phi) at phi = 0 gives
        the spin stiffness."""
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
        self.twist_phases = _check(twist_phases, 'twist_phases')
        self._tables: Dict[torch.device, tuple] = {}

    def _device_tables(self, device: torch.device) -> tuple:
        """(site_i, site_j, couplings, offdiag, twist) as tensors on
        `device`, copied there once."""
        if device not in self._tables:
            def put(arr):
                return None if arr is None else torch.as_tensor(
                    arr, device=device)
            offdiag = (self.offdiag_couplings
                       if self.offdiag_couplings is not None
                       else self.couplings)
            self._tables[device] = (put(self.bonds[:, 0]),
                                    put(self.bonds[:, 1]),
                                    put(self.couplings), put(offdiag),
                                    put(self.twist_phases))
        return self._tables[device]

    def diagonal(self, configs: torch.Tensor) -> torch.Tensor:
        """Sum of Sz Sz matrix elements, [batch]."""
        site_i, site_j, couplings, _, _ = self._device_tables(configs.device)
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
          weights: [batch, n_bonds] — 0.5*j_x where antiparallel, else 0;
              complex64 under twisted boundaries.
        """
        site_i, site_j, _, offdiag, twist = self._device_tables(
            configs.device)
        s_i = configs[:, site_i]                  # [batch, n_bonds]
        s_j = configs[:, site_j]
        bond = torch.arange(self.n_bonds, device=configs.device)
        flipped = configs[:, None, :].repeat(1, self.n_bonds, 1)
        flipped[:, bond, site_i] = s_j
        flipped[:, bond, site_j] = s_i
        weights = 0.5 * self.j_x * (s_i * s_j < 0).to(configs.dtype)
        if offdiag is not None:
            weights = weights * offdiag
        if twist is not None:
            # <R|H|R_b> for antiparallel (s_i, s_j): the S+_i S-_j term
            # connects when s_i = +1 (it raises i in R_b), giving
            # e^{+i delta_b}; the conjugate term when s_i = -1.
            weights = weights * torch.exp(
                torch.complex(torch.zeros_like(weights),
                              0.5 * twist * (s_i - s_j)))
        return flipped, weights


class HeisenbergBond(HeisenbergHamiltonian):
    """A single S_i . S_j bond."""

    def __init__(self, bond: Tuple[int, int], j_x: float = 1.0,
                 j_z: float = 1.0):
        super().__init__(np.asarray([bond], dtype=np.int64), j_x, j_z)


def ite_target(hamiltonian: HeisenbergHamiltonian, wf: Wavefunction,
               beta: float) -> Wavefunction:
    """(1 - beta*H)|psi> as a wavefunction, the imaginary-time supervisor
    target."""
    def transform(params: Params, configs: torch.Tensor) -> LogAmp:
        amp = wf.apply(params, configs)
        e_loc = hamiltonian.local_value(wf, params, configs, amp)
        return _scaled(amp, 1.0 - beta * e_loc)
    return TransformedWavefunction(transform, wf, name='ite_target')
