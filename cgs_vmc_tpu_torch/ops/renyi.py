"""Rényi-2 entanglement entropy by the swap-operator estimator (port of
cgs_vmc_tpu/ops/renyi.py).

For a spatial region A,

    S2(A) = -log <SWAP_A>,
    <SWAP_A> = E_{x,y ~ |psi|^2} [ psi(y_A, x_B) psi(x_A, y_B)
                                   / (psi(x) psi(y)) ],

estimated over two independent replicas of the Markov chains (Hastings et
al., PRL 104, 157201 (2010)).  The amplitude ratio is taken in log space
from one forward pass over both replicas and both swapped pairs.

Sector note: the chains sample a fixed total-Sz sector, and a swap can move
spin weight between A and B, giving configurations where the true state
has amplitude zero.  Those terms are zeroed explicitly (`sz_ok`) rather
than trusting the ansatz to vanish off-sector, and their swapped
configurations are never evaluated.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction


def region_mask(num_sites: int, region: Sequence[int]) -> np.ndarray:
    mask = np.zeros(num_sites, dtype=bool)
    mask[np.asarray(region, dtype=np.int64)] = True
    return mask


@torch.no_grad()
def swap_values(wf: Wavefunction, params: Params,
                configs_x: torch.Tensor, configs_y: torch.Tensor,
                mask) -> torch.Tensor:
    """Per-pair swap estimator values, [batch] (real)."""
    mask = torch.as_tensor(mask, device=configs_x.device)
    # Swaps that change the region's total Sz leave the sampled sector:
    # the physical amplitude there is exactly zero.  Those pairs are not
    # swapped at all (an ansatz defined on the sector only, such as
    # ed_vector, cannot evaluate them) and their values are zeroed below.
    sz_ok = torch.sum(torch.where(mask, configs_x - configs_y, 0.0),
                      dim=-1) == 0
    swap = mask & sz_ok[:, None]
    swapped_x = torch.where(swap, configs_y, configs_x)  # (y_A, x_B)
    swapped_y = torch.where(swap, configs_x, configs_y)  # (x_A, y_B)

    batch = configs_x.shape[0]
    amps = wf.apply(params, torch.cat(
        [configs_x, configs_y, swapped_x, swapped_y], dim=0))
    log = amps.log.reshape(4, batch)
    sign = amps.sign.reshape(4, batch)
    log_ratio = log[2] + log[3] - log[0] - log[1]
    value = sign[0] * sign[1] * sign[2] * sign[3] * torch.exp(log_ratio)
    if value.is_complex():
        # <SWAP> of a (generally complex) state is real and positive;
        # per-sample imaginary parts are estimator noise.
        value = value.real
    return torch.where(sz_ok, value, torch.zeros_like(value))


def evaluate_renyi2(wf: Wavefunction, params: Params,
                    region: Sequence[int], config, device,
                    seed: Optional[int] = None) -> Tuple[float, float]:
    """MC estimate of (S2, its error propagated from <SWAP>'s).

    Two replica samplers on `device` with independent generators (seeded
    `seed` and `seed + 1`, default config.seed), each equilibrated, then
    `num_evaluation_samples` batch means of the swap value, decorrelated by
    num_monte_carlo_sweeps between them.
    """
    from cgs_vmc_tpu_torch.evaluate import binned_error
    from cgs_vmc_tpu_torch.optim.common import make_sweeps_fn
    from cgs_vmc_tpu_torch.sampler import metropolis

    seed = config.seed if seed is None else seed
    mask = torch.as_tensor(region_mask(config.num_sites, region),
                           device=torch.device(device))
    sweeps_fn = make_sweeps_fn(wf, config)
    replicas = [metropolis.init_sampler_for(s, wf, params, config, device)
                for s in (seed, seed + 1)]
    with torch.no_grad():
        replicas = [sweeps_fn(params, s, config.num_equilibration_sweeps)
                    for s in replicas]
        values = []
        for _ in range(config.num_evaluation_samples):
            values.append(torch.mean(swap_values(
                wf, params, replicas[0].configs, replicas[1].configs, mask)))
            replicas = [sweeps_fn(params, s, config.num_monte_carlo_sweeps)
                        for s in replicas]
    values = torch.stack(values).cpu().numpy()
    swap_mean, swap_err = binned_error(values)
    s2 = -float(np.log(max(swap_mean, 1e-300)))
    # Error propagation: d(-log m) = dm / m.
    return s2, float(swap_err / max(swap_mean, 1e-300))


def exact_renyi2(vector: np.ndarray, states: np.ndarray,
                 region: Sequence[int]) -> float:
    """ED oracle: S2 = -log tr(rho_A^2) from a sector vector given in
    `states` (enumerate_sz_basis) order."""
    region = np.asarray(region, dtype=np.int64)
    n_sites = states.shape[1]
    rest = np.setdiff1d(np.arange(n_sites), region)

    def bits(cols):
        # spin +1 -> bit 1, spin -1 -> bit 0 packed over given columns.
        sub = (states[:, cols] > 0).astype(np.int64)
        return sub @ (1 << np.arange(len(cols))[::-1])

    idx_a, idx_b = bits(region), bits(rest)
    psi = np.zeros((2 ** len(region), 2 ** len(rest)), dtype=np.complex128)
    psi[idx_a, idx_b] = vector
    psi /= np.linalg.norm(psi)
    rho_a = psi @ psi.conj().T
    return -float(np.log(np.real(np.trace(rho_a @ rho_a))))
