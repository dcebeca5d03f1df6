"""Operator evaluation (port of cgs_vmc_tpu/evaluate.py).

Monte Carlo: equilibrate, then alternate (record the batch-mean local value
/ decorrelate); the error bar is a binning analysis over the recorded
samples.  With ``config.num_devices`` > 1 the chains shard over the ranks
of a process group (parallel/mesh.py, launched by ``torchrun``): each
recorded sample is the pmean over the ranks of that rank's batch mean, the
acceptance rate is pmean'd, and the binned error comes from the pmean'd
series, as the JAX package's evaluation farm does it.

Exact, over the whole fixed-Sz basis: the amplitude vector
(`evaluate_vector`, the reference's ``wavefunction_epoch_{n}.txt``), the
|ψ|²-weighted expectation (`exact_expectation`) and the fidelity with a
reference vector (`overlap_with_vector`).  These run on the device the
params live on, in chunks.  ``config.split_eval`` is accepted and changes
nothing: in the JAX package it only splits the evaluation into separately
compiled programs, with the same estimator, and this evaluator is a loop of
separate calls already.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from cgs_vmc_tpu_torch import basis as basis_lib
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, tree_leaves
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.optim.common import make_sweeps_fn, pmean
from cgs_vmc_tpu_torch.parallel import mesh
from cgs_vmc_tpu_torch.sampler import metropolis, registry
from cgs_vmc_tpu_torch.utils.device import resolve_device


class EvalResult(NamedTuple):
    mean: float
    error: float           # standard error of the mean (binned)
    values: np.ndarray     # per-sample batch means [num_samples]
    acceptance_rate: float


def evaluate_operator(
    wf: Wavefunction,
    params: Params,
    operator: Operator,
    config,
    device,
    seed: Optional[int] = None,
    state: Optional[metropolis.SamplerState] = None,
    sweeps_fn=None,
) -> EvalResult:
    """MC expectation <O> = mean(O_loc) with binned error bars.

    Chains start from `state` (this rank's share, under a process group)
    or, if None, from a fresh sampler on `device` seeded with `seed`
    (default config.seed) for config.batch_size chains in all, sharded
    over the ranks.  `sweeps_fn(params, state, num_sweeps)` replaces the
    registry's choice of sampler, e.g. to drive the streamed RBM kernel
    instead of the in-kernel-RNG one.  Every rank returns the same result.
    """
    device = resolve_device(device)
    group = mesh.chains_group(getattr(config, 'num_devices', 1))
    if state is None:
        state = mesh.shard_sampler(metropolis.init_sampler_for(
            config.seed if seed is None else seed, wf, params, config,
            device), group)
    registry.check_state(wf, config, state)
    state = metropolis.refresh_amplitudes(wf, params, state)
    sweeps_fn = sweeps_fn or make_sweeps_fn(wf, config)

    with torch.no_grad():
        state = metropolis.reset_stats(state)
        state = sweeps_fn(params, state, config.num_equilibration_sweeps)
        values = []
        for _ in range(config.num_evaluation_samples):
            values.append(torch.mean(
                operator.local_value(wf, params, state.configs)).real)
            state = sweeps_fn(params, state, config.num_monte_carlo_sweeps)
        values, acc = pmean((torch.stack(values),
                             metropolis.acceptance_rate(state)), group)
    values = values.cpu().numpy()
    mean, err = binned_error(values)
    return EvalResult(mean=float(mean), error=float(err), values=values,
                      acceptance_rate=float(acc))


def binned_error(values: np.ndarray, min_bins: int = 16
                 ) -> tuple[float, float]:
    """Mean and autocorrelation-robust standard error via binning analysis:
    double the bin size until the binned SEM plateaus (take its max)."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    mean = values.mean()
    if n < 2:
        return mean, float('nan')
    best = values.std(ddof=1) / np.sqrt(n)
    size = 2
    while n // size >= min_bins:
        nb = n // size
        binned = values[:nb * size].reshape(nb, size).mean(axis=1)
        best = max(best, binned.std(ddof=1) / np.sqrt(nb))
        size *= 2
    return mean, best


def evaluate_vector(
    wf: Wavefunction,
    params: Params,
    config,
    basis_array: Optional[np.ndarray] = None,
    output_path: Optional[str] = None,
    epoch_num: int = 0,
) -> np.ndarray:
    """ψ on every basis configuration, in chunks of config.batch_size on
    the params' device; normalized to a unit maximum magnitude (the global
    scale means nothing).  Writes the reference's ``(re,im)`` lines to
    `output_path`, by default ``wavefunction_epoch_{epoch_num}.txt`` in
    config.checkpoint_dir when that is set."""
    if basis_array is None:
        basis_array = basis_lib.config_basis(config)
    device = tree_leaves(params)[0].device
    configs = torch.as_tensor(np.asarray(basis_array, np.float32),
                              device=device)
    batch = max(config.batch_size, 1)
    signs, logs = [], []
    with torch.no_grad():
        for start in range(0, configs.shape[0], batch):
            amp = wf.apply(params, configs[start:start + batch])
            signs.append(amp.sign)
            logs.append(amp.log)
    sign = torch.cat(signs).cpu().numpy()
    log = torch.cat(logs).cpu().numpy()
    psi = sign * np.exp(log - np.real(log).max())

    if output_path is None and config.checkpoint_dir:
        output_path = os.path.join(config.checkpoint_dir,
                                   f'wavefunction_epoch_{epoch_num}.txt')
    if output_path:
        with open(output_path, 'w') as f:
            for value in psi:
                f.write(f'({np.real(value)},{np.imag(value)})\n')
    return psi


def exact_expectation(
    wf: Wavefunction,
    params: Params,
    operator: Operator,
    num_sites: int,
    n_down: Optional[int] = None,
    batch: int = 4096,
) -> float:
    """⟨O⟩ over the whole fixed-Sz basis, no Monte Carlo:
    Σ_R |ψ(R)|² O_loc(R) / Σ_R |ψ(R)|², the local values `batch`
    configurations at a time on the params' device."""
    states = basis_lib.enumerate_sz_basis(num_sites, n_down)
    device = tree_leaves(params)[0].device
    logs, values = [], []
    with torch.no_grad():
        for start in range(0, states.shape[0], batch):
            chunk = torch.as_tensor(states[start:start + batch],
                                    device=device)
            amp = wf.apply(params, chunk)
            logs.append(amp.log.real)
            values.append(operator.local_value(wf, params, chunk, amp))
    logs = torch.cat(logs).cpu().numpy().astype(np.float64)
    values = torch.cat(values).cpu().numpy()
    weights = np.exp(2.0 * (logs - logs.max()))
    weights /= weights.sum()
    return float(np.real(np.sum(weights * values)))


def overlap_with_vector(psi: np.ndarray, reference_vector: np.ndarray
                        ) -> float:
    """|⟨ψ|φ⟩| / (|ψ||φ|), the fidelity with a reference (e.g. ED) vector."""
    psi = np.asarray(psi)
    phi = np.asarray(reference_vector)
    return float(abs(np.vdot(psi, phi))
                 / (np.linalg.norm(psi) * np.linalg.norm(phi)))
