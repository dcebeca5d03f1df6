"""Observables beyond the Hamiltonian (port of
cgs_vmc_tpu/ops/observables.py).

The standard measurement set for spin systems, each an `Operator`, so
`evaluate_operator` measures it with the same sampling machinery:
longitudinal and transverse correlators at a set of site pairs, the
momentum-resolved structure factor S(q), the squared staggered
magnetization and the SU(2) Casimir S_tot².  The diagonal ones read only
the configurations; the off-diagonal ones are Heisenberg operators (the
fused connected-configuration pass of ops/heisenberg.py) on their pair
sets.  Per-site tables live on the device, copied there once.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian, Operator
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


class SiteTables:
    """Per-site host arrays, copied to each device once, on first use."""

    def __init__(self, *arrays: np.ndarray):
        self._host = tuple(np.asarray(a) for a in arrays)
        self._on: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        if device not in self._on:
            self._on[device] = tuple(torch.as_tensor(a, device=device)
                                     for a in self._host)
        return self._on[device]


class SzSzCorrelation(Operator):
    """C = (1/|pairs|) Σ_(i,j) Sᶻᵢ Sᶻⱼ — diagonal in the computational
    basis, so the local value needs no extra wavefunction evaluations."""

    def __init__(self, pairs: Sequence[Tuple[int, int]]):
        pairs = np.asarray(pairs, dtype=np.int64)
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f'pairs must be [n_pairs, 2], got {pairs.shape}')
        self.pairs = pairs
        self._tables = SiteTables(pairs[:, 0], pairs[:, 1])

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        del wf, params, amp  # diagonal observable
        site_i, site_j = self._tables.on(configs.device)
        return 0.25 * torch.mean(configs[:, site_i] * configs[:, site_j],
                                 dim=-1)


class SpinStructureFactor(Operator):
    """Momentum-resolved longitudinal structure factor

        S(q) = (1/N) ⟨ |Σᵢ e^{i q·rᵢ} Sᶻᵢ|² ⟩

    — diagonal in the computational basis.  At the AFM ordering vector
    (q = π on a chain, (π, π) on the square lattice) it is N times the
    squared staggered magnetization, configuration by configuration.
    """

    def __init__(self, q: Sequence[float], positions: np.ndarray):
        """q: momentum vector [dim]; positions: site coordinates [N, dim]."""
        q = np.asarray(q, np.float64).reshape(-1)
        positions = np.asarray(positions, np.float64)
        if positions.ndim != 2 or positions.shape[1] != q.shape[0]:
            raise ValueError(
                f'positions must be [n_sites, {q.shape[0]}], '
                f'got {positions.shape}')
        phase = positions @ q                       # q·rᵢ, [n_sites]
        self.cos_qr = np.cos(phase).astype(np.float32)
        self.sin_qr = np.sin(phase).astype(np.float32)
        self._tables = SiteTables(self.cos_qr, self.sin_qr)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        del wf, params, amp  # diagonal observable
        cos_qr, sin_qr = self._tables.on(configs.device)
        sz = 0.5 * configs
        re = torch.sum(sz * cos_qr, dim=-1)
        im = torch.sum(sz * sin_qr, dim=-1)
        return (re ** 2 + im ** 2) / configs.shape[-1]


class TransverseCorrelation(Operator):
    """C⊥ = (1/|pairs|) Σ_(i,j) ⟨SˣᵢSˣⱼ + SʸᵢSʸⱼ⟩ — the off-diagonal
    correlator: ½(S⁺ᵢS⁻ⱼ + S⁻ᵢS⁺ⱼ) exchanges antiparallel spins, so the
    local value is the Heisenberg exchange term (j_x = 1, j_z = 0) on the
    pair set, divided by the number of pairs.  For the isotropic
    Heisenberg ground state ⟨C⊥⟩ = 2⟨SᶻSᶻ⟩ by SU(2) symmetry."""

    def __init__(self, pairs: Sequence[Tuple[int, int]],
                 sample_chunk: int = 0,
                 pair_signs: Optional[np.ndarray] = None):
        """pair_signs: optional ±1 weight per pair — e.g. the Marshall
        sublattice product ε_i·ε_j, which turns the correlator measured in
        a gauge-rotated state (trained with jx < 0) into the physical one
        (the gauge U = Π_B σᶻ flips Sx, Sy on sublattice B).  Applied as
        per-bond couplings of the exchange pass, so it is exact when the
        signs differ across pairs."""
        pairs = np.asarray(pairs, dtype=np.int32)
        couplings = None
        if pair_signs is not None:
            couplings = np.asarray(pair_signs, np.float64).reshape(-1)
            if couplings.shape[0] != pairs.shape[0]:
                raise ValueError(
                    f'pair_signs must have one entry per pair: '
                    f'{couplings.shape[0]} vs {pairs.shape[0]}')
        self._exchange = HeisenbergHamiltonian(
            pairs, j_x=1.0, j_z=0.0, sample_chunk=sample_chunk,
            couplings=couplings)
        self.n_pairs = pairs.shape[0]

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        return self._exchange.local_value(wf, params, configs,
                                          amp) / self.n_pairs


class TotalSpinSquared(Operator):
    """S_tot² = Σ_ij Sᵢ·Sⱼ = 3N/4 + 2 Σ_{i<j} Sᵢ·Sⱼ — the SU(2) Casimir;
    0 for a singlet.  A Heisenberg operator on the complete graph
    (K = N(N−1)/2 connected configurations; pass sample_chunk for large N).

    S² does not commute with the Marshall rotation, so a state trained
    with heisenberg_jx = -1 is measured with the exchange terms corrected
    per pair: pass the ±1 site mask as `sublattice` and cross-sublattice
    pairs flip their exchange sign.
    """

    def __init__(self, n_sites: int, sample_chunk: int = 0,
                 sublattice: Optional[np.ndarray] = None):
        pairs = np.asarray(
            [(i, j) for i in range(n_sites) for j in range(i + 1, n_sites)],
            np.int32)
        offdiag = None
        if sublattice is not None:
            sub = np.asarray(sublattice, np.float32).reshape(-1)
            offdiag = sub[pairs[:, 0]] * sub[pairs[:, 1]]
        self.n_sites = n_sites
        self._heis = HeisenbergHamiltonian(
            pairs, 1.0, 1.0, sample_chunk=sample_chunk,
            offdiag_couplings=offdiag)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        pair_sum = self._heis.local_value(wf, params, configs, amp)
        return 0.75 * self.n_sites + 2.0 * pair_sum


def chain_positions(n_sites: int) -> np.ndarray:
    """1-D chain site coordinates [N, 1] (unit spacing)."""
    return np.arange(n_sites, dtype=np.float64)[:, None]


def square_positions(size_x: int, size_y: int) -> np.ndarray:
    """Square-lattice site coordinates [N, 2], row-major (x slow, y fast):
    site index = x * size_y + y."""
    xs, ys = np.meshgrid(np.arange(size_x), np.arange(size_y), indexing='ij')
    return np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float64)


class StaggeredMagnetizationSquared(Operator):
    """(Σᵢ εᵢ Sᶻᵢ / N)² with εᵢ the ±1 sublattice sign — the standard AFM
    order parameter (diagonal)."""

    def __init__(self, sublattice: np.ndarray):
        self.sublattice = np.asarray(sublattice, np.float32)
        self._tables = SiteTables(self.sublattice)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        del wf, params, amp
        (sublattice,) = self._tables.on(configs.device)
        stag = torch.sum(configs * sublattice * 0.5,
                         dim=-1) / configs.shape[-1]
        return stag ** 2
