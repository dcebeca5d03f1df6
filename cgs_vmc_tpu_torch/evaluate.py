"""Monte Carlo operator evaluation (port of cgs_vmc_tpu/evaluate.py:37-118
and :161-177, single device).

Equilibrate, then alternate (record the batch-mean local value /
decorrelate); the error bar is a binning analysis over the recorded
samples.  The JAX package's split_eval mode works around a TPU transport
and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.optim.common import make_sweeps_fn
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

    Chains start from `state` or, if None, from a fresh sampler on `device`
    seeded with `seed` (default config.seed).  `sweeps_fn(params, state,
    num_sweeps)` replaces the registry's choice of sampler, e.g. to drive
    the streamed RBM kernel instead of the in-kernel-RNG one.
    """
    device = resolve_device(device)
    if getattr(config, 'split_eval', False):
        raise NotImplementedError(
            'split_eval is a TPU-transport workaround and is not ported')
    if getattr(config, 'num_devices', 1) > 1:
        raise NotImplementedError('multi-device evaluation is not ported '
                                  'yet (ROADMAP.md)')
    if state is None:
        state = metropolis.init_sampler_for(
            config.seed if seed is None else seed, wf, params, config,
            device)
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
        acc = metropolis.acceptance_rate(state)
    values = torch.stack(values).cpu().numpy()
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
