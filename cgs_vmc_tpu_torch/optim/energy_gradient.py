"""Variance-reduced VMC energy-gradient optimizer (port of
cgs_vmc_tpu/optim/energy_gradient.py):

  ∇E = ⟨E_loc ∇logψ⟩ − ⟨E_loc⟩⟨∇logψ⟩

with moments accumulated over ``num_batches_per_epoch`` decorrelated
batches and one parameter update per epoch.  The gradient is autograd
through the ansatz; the sweeps between batches are whatever the sampler
registry picks (the fused kernels for a pure RBM).  A complex log takes
the split-real moments ⟨E_r O_r⟩c + ⟨E_i O_i⟩c with O = ∂log|ψ| + i·∂phase
and reports the variance ⟨|E|²⟩ − |⟨E⟩|².
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cgs_vmc_tpu_torch.models.base import Wavefunction, tree_map
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.optim import common
from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.sampler import metropolis


class EnergyGradientOptimizer:
    """Ground-state optimizer 'EnergyGradient'."""

    name = 'EnergyGradient'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config):
        self.wf = wf
        self.hamiltonian = hamiltonian
        self.config = config
        self.sgd = common.make_sgd_optimizer(config)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def init_state(self, seed: int, device,
                   n_local_chains: Optional[int] = None) -> TrainState:
        """See common.init_train_state."""
        return common.init_train_state(self.wf, self.sgd, self.config, seed,
                                       device, n_local_chains)

    def epoch(self, state: TrainState
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimization epoch: equilibrate; per batch accumulate the
        moments, then decorrelate; one parameter update from the epoch-mean
        moments.  Metrics are device scalars (no host sync here)."""
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        params = state.params

        sampler = metropolis.reset_stats(state.sampler)
        # Params changed since last epoch's sweeps wrote the amplitude cache.
        sampler = metropolis.refresh_amplitudes(wf, params, sampler)
        sampler = self.sweeps(params, sampler, cfg.num_equilibration_sweeps)

        n_batches = cfg.num_batches_per_epoch
        device = sampler.configs.device
        # A complex-log ansatz takes the second of the two moment pipelines.
        is_complex = sampler.log_amp.is_complex()
        g_plain = tree_map(torch.zeros_like, params)     # ⟨O⟩ (⟨O_re⟩)
        g_imag = tree_map(torch.zeros_like, params)      # ⟨O_im⟩
        g_scaled = tree_map(torch.zeros_like, params)
        e_mean = torch.zeros((), device=device, dtype=(
            torch.complex64 if is_complex else torch.float32))
        e2_mean = torch.zeros((), device=device)
        for _ in range(n_batches):
            configs = sampler.configs
            inv = 1.0 / (configs.shape[0] * n_batches)
            if is_complex:
                amp, pullback = common.log_amp_phase_pullback(wf, params,
                                                              configs)
                with torch.no_grad():
                    e_loc = ham.local_value(wf, params, configs, amp)
                ones = torch.full((configs.shape[0],), inv, device=device)
                zeros = torch.zeros_like(ones)
                g_plain = tree_map(torch.add, g_plain, pullback(ones, zeros))
                g_imag = tree_map(torch.add, g_imag, pullback(zeros, ones))
                g_scaled = tree_map(
                    torch.add, g_scaled,
                    pullback(e_loc.real * inv, e_loc.imag * inv))
            else:
                amp, pullback = common.log_derivative_pullback(wf, params,
                                                               configs)
                with torch.no_grad():
                    e_loc = ham.local_value(wf, params, configs, amp)
                g_plain = tree_map(torch.add, g_plain,
                                   pullback(torch.full_like(amp.log, inv)))
                g_scaled = tree_map(torch.add, g_scaled,
                                    pullback(e_loc * inv))
            e_mean = e_mean + torch.sum(e_loc) * inv
            e2_mean = e2_mean + torch.sum(torch.abs(e_loc) ** 2) * inv
            sampler = self.sweeps(params, sampler, cfg.num_monte_carlo_sweeps)

        grads = common.tree_weighted_diff(g_scaled, g_plain, e_mean.real)
        if is_complex:
            grads = common.tree_weighted_diff(grads, g_imag, e_mean.imag)
        new_params, opt_state = self.sgd.update(grads, state.opt_state,
                                                params, state.epoch)
        metrics = {
            'energy': e_mean.real,
            'energy_variance': e2_mean - torch.abs(e_mean) ** 2,
            'acceptance_rate': metropolis.acceptance_rate(sampler),
            'grad_norm': common.grad_global_norm(grads),
        }
        return TrainState(params=new_params, opt_state=opt_state,
                          sampler=sampler, epoch=state.epoch + 1,
                          extra=state.extra), metrics
