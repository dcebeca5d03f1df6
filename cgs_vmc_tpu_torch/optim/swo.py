"""Supervised Wavefunction Optimization (port of
cgs_vmc_tpu/optim/swo.py; arXiv:1808.05232): the two imaginary-time
ground-state optimizers and the four supervised ones.

The supervisor is a second parameter tree: ITSWO's ω, a copy of the params
taken at the start of each epoch and held in ``state.extra['omega']``, or
the fixed target of distillation in ``state.extra['target']``.  Every
optimizer here updates the params once a batch, so each batch refreshes the
sampler's amplitude cache before its sweeps; the learning rate is keyed on
the epoch, while adam's count advances once an update.

Stop-gradient is ``.detach()`` and the gradient is autograd through leaves
that require grad, as in common.log_derivative_pullback:
 * ψ/stop(ψ) = exp(log − log.detach()) is 1 with gradient ∇logψ;
 * ITSWO's normalization N = sqrt(1 − 2β⟨E⟩ + β²⟨E²⟩) is tracked by an EMA
   (tf.train.ExponentialMovingAverage with num_updates), and the loss of an
   epoch divides by the previous epoch's value;
 * the √2ⁿ scale of the distillation targets is added in log space.
The raw-L2 losses (SWO, DualSamplingSWO, BasisIterSWO) depend on the
target's scale and are well posed for a normalized target (a FullVector of
a unit ED vector); the log-overlap ones are invariant to it.

Complex logs: the L2 losses are mean |z|², whose gradient with respect to
the real parameters 2·Re[z*·∂z] is what autograd gives for a real loss of
real leaves (the only place a complex intermediate is backpropagated
through); the log-overlap gradient takes the split-real pullback
(common.log_amp_phase_pullback); 1/ψ enters every ratio as conj(sign)·
exp(−log), a no-op for real ±1 signs.

Under a chains group (parallel/mesh.py; ``group=None`` is one process)
every batch's gradient and loss, the ITSWO energy moments, the overlap
moments and the acceptance rate are pmean'd over the ranks, as the JAX
package's ``common.pmean`` sites; BasisIterSWO's ranks read disjoint
slices of one shared permutation.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch import basis as basis_lib
from cgs_vmc_tpu_torch.models.base import (
    Params, Wavefunction, tree_leaves, tree_map, tree_unflatten)
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.ops.logamp import LogAmp
from cgs_vmc_tpu_torch.optim import common
from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.sampler import metropolis

Metrics = Dict[str, torch.Tensor]


def _ema_update(shadow: torch.Tensor, value: torch.Tensor,
                num_updates: torch.Tensor, decay: float = 0.999
                ) -> torch.Tensor:
    """tf.train.ExponentialMovingAverage with num_updates: the effective
    decay is min(decay, (1 + n) / (10 + n))."""
    d = torch.clamp((1.0 + num_updates) / (10.0 + num_updates), max=decay)
    return shadow * d + value * (1.0 - d)


def _normalized_psi(log: torch.Tensor) -> torch.Tensor:
    """ψ / stop(ψ): value 1, gradient ∇logψ (the sign cancels); with a
    complex log the gradient is O = ∂log|ψ| + i·∂phase."""
    return torch.exp(log - log.detach())


def _residual_l2(z: torch.Tensor) -> torch.Tensor:
    """mean |z|²: mean z² for real residuals, the modulus-squared loss for
    complex ones."""
    return torch.mean((z * torch.conj(z)).real)


def _ratio(num: LogAmp, den: LogAmp, factor=1.0) -> torch.Tensor:
    """factor · ψ_num/ψ_den, detached: 1/ψ_den is conj(sign)/exp(log)."""
    return (num.sign * torch.conj(den.sign) * factor
            * torch.exp(num.log - den.log)).detach()


def _copy(params: Params) -> Params:
    """A detached copy that no later operation on `params` can alias."""
    return tree_map(lambda x: x.detach().clone(), params)


def _to(tree: Params, device: torch.device) -> Params:
    return tree_map(lambda x: x.detach().to(device), tree)


def _loss_and_grads(wf: Wavefunction, params: Params, configs: torch.Tensor,
                    loss_fn) -> Tuple[torch.Tensor, Params]:
    """(loss, grads) of loss_fn(amp) for the student's LogAmp on `configs`;
    whatever loss_fn detaches is held constant."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    amp = wf.apply(tree_unflatten(params, leaves), configs)
    loss = loss_fn(amp)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def _log_overlap_grads(wf: Wavefunction, params: Params,
                       configs: torch.Tensor, ratio_of, group=None
                       ) -> Tuple[Params, torch.Tensor]:
    """Half-scale log-overlap gradient, real or complex log:
      real:    ⟨O⟩ − ⟨r·O⟩/⟨r⟩
      complex: ⟨O_re⟩ − Re[⟨r·O*⟩/⟨r⟩]   (O = ∂log|ψ| + i·∂phase),
    which is the real formula when the imaginary parts vanish.
    r = ratio_of(the student's LogAmp on `configs`); every mean is
    pmean'd over `group`.  Returns (grads, ⟨r⟩)."""
    amp, pullback = common.log_amp_phase_pullback(wf, params, configs)
    ratio = ratio_of(amp)
    m = ratio.shape[0]
    ones = torch.full((m,), 1.0 / m, device=configs.device)
    zeros = torch.zeros_like(ones)
    if ratio.is_complex():
        mean_ratio = common.pmean(torch.mean(ratio), group)
        # Re[Σ w·O*] = Σ [Re(w)·O_re + Im(w)·O_im].
        w = ratio / (m * mean_ratio)
        g_plain, g_corr = common.pmean(
            (pullback(ones, zeros), pullback(w.real, w.imag)), group)
        return tree_map(torch.sub, g_plain, g_corr), mean_ratio
    g_plain, g_ratio, mean_ratio = common.pmean(
        (pullback(ones, zeros), pullback(ratio / m, zeros),
         torch.mean(ratio)), group)
    grads = tree_map(lambda a, b: a - b / mean_ratio, g_plain, g_ratio)
    return grads, mean_ratio


class _SWOBase:
    """The SGD optimizer and the registry-resolved sweeps of the student."""

    def __init__(self, wf: Wavefunction, config):
        self.wf = wf
        self.config = config
        self.sgd = common.make_sgd_optimizer(config)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def _batch_configs(self, params: Params,
                       sampler: metropolis.SamplerState
                       ) -> metropolis.SamplerState:
        """The next batch: the params changed since the cache was written,
        so refresh it, then decorrelate."""
        sampler = metropolis.refresh_amplitudes(self.wf, params, sampler)
        return self.sweeps(params, sampler, self.config.num_monte_carlo_sweeps)


# ======================================================================
# Ground state by imaginary time: the target is (1 − βH)|ψ_ω⟩.
# ======================================================================

class _ImaginaryTimeSWO(_SWOBase):

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config):
        super().__init__(wf, config)
        self.hamiltonian = hamiltonian

    def _start_epoch(self, state: TrainState):
        """(equilibrated sampler, ω = a copy of the params)."""
        sampler = metropolis.reset_stats(state.sampler)
        sampler = metropolis.refresh_amplitudes(self.wf, state.params,
                                                sampler)
        sampler = self.sweeps(state.params, sampler,
                              self.config.num_equilibration_sweeps)
        return sampler, _copy(state.params)

    @torch.no_grad()
    def _supervisor(self, omega: Params, configs: torch.Tensor):
        """(ψ_ω's LogAmp, its local energies) on `configs`."""
        amp_omega = self.wf.apply(omega, configs)
        e_loc = self.hamiltonian.local_value(self.wf, omega, configs,
                                             amp_omega)
        return amp_omega, e_loc


class LogOverlapImaginaryTimeSWO(_ImaginaryTimeSWO):
    """'LogOverlapITSWO': ∇L = ⟨∇logψ⟩ − ⟨r·∇logψ⟩/⟨r⟩ with
    r = (ψ_ω − βHψ_ω)/ψ; no normalization to track."""

    name = 'LogOverlapITSWO'

    def init_state(self, seed: int, device,
                   n_local_chains: Optional[int] = None) -> TrainState:
        state = common.init_train_state(self.wf, self.sgd, self.config, seed,
                                        device, n_local_chains)
        return state._replace(extra={'omega': _copy(state.params)})

    def epoch(self, state: TrainState, group=None
              ) -> Tuple[TrainState, Metrics]:
        cfg = self.config
        beta = cfg.time_evolution_beta
        sampler, omega = self._start_epoch(state)
        params, opt_state = state.params, state.opt_state
        e_sum = torch.zeros((), device=sampler.configs.device)
        for _ in range(cfg.num_batches_per_epoch):
            sampler = self._batch_configs(params, sampler)
            configs = sampler.configs
            amp_omega, e_loc = self._supervisor(omega, configs)
            # r = (ψ_ω − βHψ_ω)/ψ, all on the supervisor's side.
            grads, _ = _log_overlap_grads(
                self.wf, params, configs,
                lambda amp: _ratio(amp_omega, amp, 1.0 - beta * e_loc),
                group)
            params, opt_state = self.sgd.update(grads, opt_state, params,
                                                state.epoch)
            e_sum = e_sum + common.pmean(torch.mean(e_loc).real, group)
        metrics = {'energy': e_sum / cfg.num_batches_per_epoch,
                   'acceptance_rate': common.pmean(
                       metropolis.acceptance_rate(sampler), group)}
        return TrainState(params, opt_state, sampler, state.epoch + 1,
                          {'omega': omega}), metrics


class ImaginaryTimeSWO(_ImaginaryTimeSWO):
    """'ITSWO', the default ground-state optimizer:
      loss = ⟨(ψ − (ψ_ω − βHψ_ω)/N)² / stop(ψ)²⟩,
    N the previous epoch's EMA of sqrt(1 − 2β⟨E⟩ + β²⟨E²⟩)."""

    name = 'ITSWO'

    def init_state(self, seed: int, device,
                   n_local_chains: Optional[int] = None) -> TrainState:
        state = common.init_train_state(self.wf, self.sgd, self.config, seed,
                                        device, n_local_chains)
        device = state.sampler.configs.device
        ones = torch.ones((), device=device)
        zeros = torch.zeros((), device=device)
        return state._replace(extra={
            'omega': _copy(state.params),
            'ite_normalization': ones,
            'ema_norm': ones.clone(),
            'ema_energy': zeros,
            'ema_count': zeros.clone(),
        })

    def epoch(self, state: TrainState, group=None
              ) -> Tuple[TrainState, Metrics]:
        cfg = self.config
        beta = cfg.time_evolution_beta
        sampler, omega = self._start_epoch(state)
        norm_var = state.extra['ite_normalization']
        params, opt_state = state.params, state.opt_state
        ema_norm, ema_energy, ema_count = (
            state.extra[k] for k in ('ema_norm', 'ema_energy', 'ema_count'))
        losses = []
        for _ in range(cfg.num_batches_per_epoch):
            sampler = self._batch_configs(params, sampler)
            configs = sampler.configs
            amp_omega, e_loc = self._supervisor(omega, configs)
            # N² = 1 − 2β⟨H⟩ + β²⟨H²⟩ with ⟨H⟩ = E[Re E_loc] and ⟨H²⟩ =
            # E[|E_loc|²] (H is Hermitian).
            e_mean, e2_mean = common.pmean(
                (torch.mean(e_loc.real), torch.mean(torch.abs(e_loc) ** 2)),
                group)
            ite_norm = torch.sqrt(1.0 - 2.0 * beta * e_mean
                                  + beta ** 2 * e2_mean)

            def loss_fn(amp):
                target = _ratio(amp_omega, amp,
                                1.0 - beta * e_loc) / norm_var
                return _residual_l2(_normalized_psi(amp.log) - target)

            loss, grads = common.pmean(
                _loss_and_grads(self.wf, params, configs, loss_fn), group)
            params, opt_state = self.sgd.update(grads, opt_state, params,
                                                state.epoch)
            ema_norm = _ema_update(ema_norm, ite_norm, ema_count)
            ema_energy = _ema_update(ema_energy, e_mean, ema_count)
            ema_count = ema_count + 1.0
            losses.append(loss)
        extra = {
            'omega': omega,
            # The normalization the next epoch divides by.
            'ite_normalization': ema_norm,
            'ema_norm': ema_norm,
            'ema_energy': ema_energy,
            'ema_count': ema_count,
        }
        metrics = {'energy': ema_energy,
                   'loss': torch.mean(torch.stack(losses)),
                   'acceptance_rate': common.pmean(
                       metropolis.acceptance_rate(sampler), group)}
        return TrainState(params, opt_state, sampler, state.epoch + 1,
                          extra), metrics


# ======================================================================
# Distillation toward a fixed target wavefunction.
# ======================================================================

class SupervisedWavefunctionOptimizer(_SWOBase):
    """'SWO': |ψ|²-sampled L2 fit, loss = ⟨(ψ − ψ_t·√2ⁿ)² / stop(ψ)²⟩."""

    name = 'SWO'

    def __init__(self, wf: Wavefunction, target_wf: Wavefunction, config):
        super().__init__(wf, config)
        self.target_wf = target_wf

    def init_state(self, seed: int, device, target_params: Params,
                   n_local_chains: Optional[int] = None) -> TrainState:
        """The student as common.init_train_state; the target's params
        moved to the same device."""
        state = common.init_train_state(self.wf, self.sgd, self.config, seed,
                                        device, n_local_chains)
        return state._replace(extra={'target': _to(
            target_params, state.sampler.configs.device)})

    def _half_log2n(self) -> float:
        return 0.5 * self.config.num_sites * math.log(2.0)

    @torch.no_grad()
    def _target_amp(self, state: TrainState, configs: torch.Tensor):
        return self.target_wf.apply(state.extra['target'], configs)

    def _raw_l2_update(self, params: Params, opt_state, epoch: int,
                       configs: torch.Tensor, amp_t, group=None):
        """One update of the raw-L2 fit ⟨(ψ − ψ_t·√2ⁿ)²⟩ on `configs`, for
        DualSamplingSWO and BasisIterSWO, the gradient and loss pmean'd
        over `group`; returns (params, opt_state, loss)."""
        psi_target = amp_t.sign * torch.exp(amp_t.log + self._half_log2n())

        def loss_fn(amp):
            return _residual_l2(amp.sign * torch.exp(amp.log) - psi_target)

        loss, grads = common.pmean(
            _loss_and_grads(self.wf, params, configs, loss_fn), group)
        params, opt_state = self.sgd.update(grads, opt_state, params, epoch)
        return params, opt_state, loss

    def epoch(self, state: TrainState, group=None
              ) -> Tuple[TrainState, Metrics]:
        half_log2n = self._half_log2n()
        sampler = metropolis.reset_stats(state.sampler)
        params, opt_state = state.params, state.opt_state
        losses = []
        for _ in range(self.config.num_batches_per_epoch):
            sampler = self._batch_configs(params, sampler)
            configs = sampler.configs
            amp_t = self._target_amp(state, configs)

            def loss_fn(amp):
                # ψ_t√2ⁿ / stop(ψ), in log space.
                target = _ratio(LogAmp(amp_t.sign, amp_t.log + half_log2n),
                                amp)
                return _residual_l2(_normalized_psi(amp.log) - target)

            loss, grads = common.pmean(
                _loss_and_grads(self.wf, params, configs, loss_fn), group)
            params, opt_state = self.sgd.update(grads, opt_state, params,
                                                state.epoch)
            losses.append(loss)
        metrics = {'loss': torch.mean(torch.stack(losses)),
                   'acceptance_rate': common.pmean(
                       metropolis.acceptance_rate(sampler), group)}
        return TrainState(params, opt_state, sampler, state.epoch + 1,
                          state.extra), metrics


class LogOverlapSWO(SupervisedWavefunctionOptimizer):
    """'LogOverlapSWO': ∇L = ⟨∇logψ⟩ − ⟨r·∇logψ⟩/⟨r⟩, r = ψ_t/ψ; invariant
    to the target's scale.  Reports the batches' mean |⟨r⟩|."""

    name = 'LogOverlapSWO'

    def epoch(self, state: TrainState, group=None
              ) -> Tuple[TrainState, Metrics]:
        sampler = metropolis.reset_stats(state.sampler)
        params, opt_state = state.params, state.opt_state
        ratios = []
        for _ in range(self.config.num_batches_per_epoch):
            sampler = self._batch_configs(params, sampler)
            configs = sampler.configs
            amp_t = self._target_amp(state, configs)
            grads, mean_ratio = _log_overlap_grads(
                self.wf, params, configs, lambda amp: _ratio(amp_t, amp),
                group)
            params, opt_state = self.sgd.update(grads, opt_state, params,
                                                state.epoch)
            ratios.append(torch.abs(mean_ratio))
        metrics = {'mean_ratio': torch.mean(torch.stack(ratios)),
                   'acceptance_rate': common.pmean(
                       metropolis.acceptance_rate(sampler), group)}
        return TrainState(params, opt_state, sampler, state.epoch + 1,
                          state.extra), metrics


class DualSamplingSWO(SupervisedWavefunctionOptimizer):
    """'DualSamplingSWO': the raw-L2 fit on half the chains sampling |ψ|²
    and half sampling |ψ_t|² (the sampling bias is not corrected, as in the
    reference).  The target's chains have their own registry-resolved
    sweeps and their own generator, both checkpointed."""

    name = 'DualSamplingSWO'

    def __init__(self, wf: Wavefunction, target_wf: Wavefunction, config):
        super().__init__(wf, target_wf, config)
        self.target_sweeps = common.make_sweeps_fn(target_wf, config)

    def init_state(self, seed: int, device, target_params: Params,
                   n_local_chains: Optional[int] = None) -> TrainState:
        """Student chains seeded with seed + 1, the target's with seed + 2,
        (n_local_chains or batch_size) // 2 of each."""
        half = (n_local_chains or self.config.batch_size) // 2
        state = super().init_state(seed, device, target_params, half)
        target_params = state.extra['target']
        target_sampler = metropolis.init_sampler_for(
            seed + 2, self.target_wf, target_params, self.config,
            state.sampler.configs.device, half)
        return state._replace(extra={'target': target_params,
                                     'target_sampler': target_sampler})

    def epoch(self, state: TrainState, group=None
              ) -> Tuple[TrainState, Metrics]:
        cfg = self.config
        target_params = state.extra['target']
        sampler = metropolis.reset_stats(state.sampler)
        t_sampler = metropolis.reset_stats(state.extra['target_sampler'])
        params, opt_state = state.params, state.opt_state
        losses = []
        for _ in range(cfg.num_batches_per_epoch):
            sampler = self._batch_configs(params, sampler)
            t_sampler = self.target_sweeps(target_params, t_sampler,
                                           cfg.num_monte_carlo_sweeps)
            configs = torch.cat([sampler.configs, t_sampler.configs])
            params, opt_state, loss = self._raw_l2_update(
                params, opt_state, state.epoch, configs,
                self._target_amp(state, configs), group)
            losses.append(loss)
        metrics = {'loss': torch.mean(torch.stack(losses)),
                   'acceptance_rate': common.pmean(
                       metropolis.acceptance_rate(sampler), group)}
        extra = dict(state.extra, target_sampler=t_sampler)
        return TrainState(params, opt_state, sampler, state.epoch + 1,
                          extra), metrics


class BasisIterationSWO(SupervisedWavefunctionOptimizer):
    """'BasisIterSWO': the raw-L2 fit over shuffled minibatches of the full
    fixed-Sz basis, no Monte Carlo.  A CPU generator in
    ``state.extra['data_generator']`` (checkpointed) draws one permutation
    of the basis an epoch; the state keeps a 256-chain sampler that this
    optimizer never reads, so that every TrainState has one.  Under a
    chains group the generator is replicated (seeded the same on every
    rank), and rank r reads rows r·n .. (r+1)·n − 1 of the shared
    permutation (n = batches · batch_size, wrapping around the basis), so
    the ranks add samples instead of repeating them."""

    name = 'BasisIterSWO'
    _DUMMY_CHAINS = 256

    def __init__(self, wf: Wavefunction, target_wf: Wavefunction, config,
                 basis_array: Optional[np.ndarray] = None):
        super().__init__(wf, target_wf, config)
        if basis_array is None:
            basis_array = basis_lib.config_basis(config)
        self.basis = np.asarray(basis_array, np.float32)
        self._device_basis: Dict[torch.device, torch.Tensor] = {}

    def init_state(self, seed: int, device, target_params: Params,
                   n_local_chains: Optional[int] = None) -> TrainState:
        """Student as common.init_train_state (the dummy chains seeded with
        seed + 1); the data generator seeded with seed + 2, so the seed
        changes the order the basis is visited in."""
        del n_local_chains  # no Monte Carlo chains in this optimizer
        state = super().init_state(seed, device, target_params,
                                   self._DUMMY_CHAINS)
        return state._replace(extra={
            'target': state.extra['target'],
            'data_generator': torch.Generator().manual_seed(seed + 2)})

    def _epoch_indices(self, generator: torch.Generator,
                       rank: int = 0) -> torch.Tensor:
        """The epoch's basis-row index stream [batches · batch_size] of
        `rank`: a fresh permutation, consumed in order from offset
        rank · batches · batch_size and tiled when the epoch needs more rows
        than the basis has (no repeat inside a pass)."""
        cfg = self.config
        n_rows = cfg.num_batches_per_epoch * cfg.batch_size
        dim = self.basis.shape[0]
        perm = torch.randperm(dim, generator=generator)
        return perm[(torch.arange(n_rows) + rank * n_rows) % dim]

    def _basis_on(self, device: torch.device) -> torch.Tensor:
        if device not in self._device_basis:
            self._device_basis[device] = torch.as_tensor(self.basis,
                                                         device=device)
        return self._device_basis[device]

    def host_inputs(self, state: TrainState, group=None) -> torch.Tensor:
        """The epoch's basis-row indices, drawn on the host from the data
        generator: a CUDA graph of the epoch (utils/cuda_graph.py) takes
        them as its input, drawn anew before each replay."""
        return self._epoch_indices(state.extra['data_generator'],
                                   common.group_rank(group))

    def epoch(self, state: TrainState, group=None,
              inputs: Optional[torch.Tensor] = None
              ) -> Tuple[TrainState, Metrics]:
        """One epoch; `inputs` are `host_inputs`' indices, drawn here when
        not given."""
        cfg = self.config
        device = state.sampler.configs.device
        basis = self._basis_on(device)
        if inputs is None:
            inputs = self.host_inputs(state, group)
        idx = inputs.to(device)
        params, opt_state = state.params, state.opt_state
        losses = []
        for batch_idx in idx.reshape(cfg.num_batches_per_epoch,
                                     cfg.batch_size):
            configs = basis[batch_idx]
            params, opt_state, loss = self._raw_l2_update(
                params, opt_state, state.epoch, configs,
                self._target_amp(state, configs), group)
            losses.append(loss)
        metrics = {'loss': torch.mean(torch.stack(losses))}
        return TrainState(params, opt_state, state.sampler, state.epoch + 1,
                          state.extra), metrics
