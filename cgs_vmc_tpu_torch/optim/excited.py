"""Excited-state VMC by penalty orthogonalization (port of
cgs_vmc_tpu/optim/excited.py).

Minimizes

    L(theta) = <H>_psi + lambda * Σ_k F_k,
    F_k = |<psi_k|psi>|² / (<psi_k|psi_k> <psi|psi>)

over a variational state psi orthogonalized against frozen lower states
psi_k (typically the trained ground state), so the minimizer is the lowest
state orthogonal to span{psi_k}.  For lambda > E_k_max − E_0 the penalized
minimum is the first state outside the spanned set, with L = E_excited.

Estimators (all normalization-free).  With samples X ~ |psi|² and
Y_k ~ |psi_k|², and ratios r_k = psi_k(X)/psi(X), s_k = psi(Y_k)/psi_k(Y_k):

    F_k     = <r_k>_X * <s_k>_Y           (A_k * B_k)
    dF_k    = 2 Re[ conj(A_k) * <s_k O>_Y − F_k * <O_r>_X ]

with O = d(log psi)/d(theta) (O_r its real part, d log|psi|).  The product
form avoids dividing by small overlaps: the gradient of F (not log F)
vanishes smoothly as the states decouple.  Moments accumulate over
`num_batches_per_epoch` decorrelated batches, as in the energy-gradient
optimizer.  The frozen chains live in ``TrainState.extra['lower_samplers']``
(checkpointed with the rest of the state): they equilibrate once, in
`init_state`, and advance num_monte_carlo_sweeps a batch.  Under a chains
group (parallel/mesh.py) each rank holds its own share of both chain sets
(``extra['lower_samplers']`` is a list of this rank's sampler states), and
the moments — the overlap moments A_k, B_k included — are pmean'd.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, tree_map
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.optim import common
from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
from cgs_vmc_tpu_torch.sampler import metropolis


def load_frozen_states(config) -> List[Tuple[Wavefunction, Params]]:
    """Resolves ``config.orthogonal_to`` paths into frozen (wf, params) on
    the host (the optimizers move them to the run's device).

    Each entry is either a run directory (its own config.json defines the
    architecture; params from its latest checkpoint — the params-only
    restore `eval` uses on any run directory) or a params-only
    ``.msgpack`` artifact (architecture from the current config, which must
    therefore match the artifact's ansatz).
    """
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib

    out: List[Tuple[Wavefunction, Params]] = []
    for path in config.orthogonal_to:
        if os.path.isdir(path):
            sub = Config.load(os.path.join(path, 'config.json'))
            wf_k = models.build_wavefunction(sub)
            latest = ckpt_lib.latest_checkpoint(path)
            if latest is None:
                raise FileNotFoundError(f'No checkpoint in {path!r}')
            params = ckpt_lib.restore_params_from_checkpoint(latest, 'cpu')
        else:
            wf_k = models.build_wavefunction(config)
            params = ckpt_lib.restore_params_only(
                path, wf_k.init(torch.Generator().manual_seed(config.seed)))
        out.append((wf_k, params))
    return out


class _FrozenStates:
    """The frozen lower states of both excited-state optimizers: their
    resolution from the config, the penalty check, and their chains.  The
    error messages are the JAX package's, which words them per optimizer
    (`_penalty_hint`, `_complex_hint`)."""

    _penalty_hint = ''
    _complex_hint = ''

    def _init_lower(self, config, lower_states):
        if lower_states is None:
            if not getattr(config, 'orthogonal_to', ()):
                raise ValueError(
                    f'{self.name} needs frozen lower states: set '
                    'config.orthogonal_to (run dirs or params artifacts) '
                    'or pass lower_states=[(wf, params), ...]')
            lower_states = load_frozen_states(config)
        self.lower_wfs = [wf_k for wf_k, _ in lower_states]
        self.lower_params = [p_k for _, p_k in lower_states]
        self.penalty = float(getattr(config, 'orthogonality_penalty', 10.0))
        if self.penalty <= 0.0:
            raise ValueError(f'orthogonality_penalty must be > 0 (got '
                             f'{self.penalty}){self._penalty_hint}')
        self.lower_sweeps = [common.make_sweeps_fn(wf_k, config)
                             for wf_k in self.lower_wfs]

    def _lower_samplers(self, seed: int, device,
                        n_local_chains: Optional[int]) -> list:
        """Moves the frozen params to `device` and starts one equilibrated
        chain set per frozen state (generators seeded seed + 2 + k)."""
        cfg = self.config
        self.lower_params = [tree_map(lambda x: x.to(device), p_k)
                             for p_k in self.lower_params]
        samplers = []
        for k, (wf_k, p_k) in enumerate(zip(self.lower_wfs,
                                            self.lower_params)):
            smp = metropolis.init_sampler_for(seed + 2 + k, wf_k, p_k, cfg,
                                              device, n_local_chains)
            samplers.append(self.lower_sweeps[k](
                p_k, smp, cfg.num_equilibration_sweeps))
        return samplers

    def _check_complex(self, is_complex: bool, lowers) -> None:
        if not is_complex and any(s.log_amp.is_complex() for s in lowers):
            raise NotImplementedError(
                'complex frozen lower states require a complex-log '
                f'variational ansatz{self._complex_hint}')


class PenaltyExcitedOptimizer(_FrozenStates):
    """Ground-state optimizer 'ExcitedPenalty'.

    Constructed like every ground-state optimizer, (wf, hamiltonian,
    config), the frozen lower states resolved from
    ``config.orthogonal_to``; tests and in-process callers may pass
    ``lower_states=[(wf_k, params_k), ...]`` directly.
    """

    name = 'ExcitedPenalty'
    _penalty_hint = ('; it must exceed the target gap for the penalized '
                     'minimum to be the excited state')
    _complex_hint = (' (the overlap moments would silently drop their '
                     'imaginary parts under a real-log psi)')

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config,
                 lower_states: Optional[
                     Sequence[Tuple[Wavefunction, Params]]] = None):
        self.wf = wf
        self.hamiltonian = hamiltonian
        self.config = config
        self._init_lower(config, lower_states)
        self.sgd = common.make_sgd_optimizer(config)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def init_state(self, seed: int, device,
                   n_local_chains: Optional[int] = None) -> TrainState:
        """common.init_train_state, plus the frozen chains."""
        return common.init_train_state(
            self.wf, self.sgd, self.config, seed, device, n_local_chains,
            extra={'lower_samplers': self._lower_samplers(
                seed, device, n_local_chains)})

    def epoch(self, state: TrainState, group=None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One epoch: per batch the energy moments over psi's chains and
        the overlap moments over psi's and each frozen chain set; one
        update from the epoch means, pmean'd over `group`.  Metrics are
        device scalars."""
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        params = state.params
        n_lower = len(self.lower_wfs)

        sampler = metropolis.reset_stats(state.sampler)
        is_complex = sampler.log_amp.is_complex()
        sampler = metropolis.refresh_amplitudes(wf, params, sampler)
        sampler = self.sweeps(params, sampler, cfg.num_equilibration_sweeps)
        lowers = [metropolis.reset_stats(s)
                  for s in state.extra['lower_samplers']]
        self._check_complex(is_complex, lowers)
        pullback_of = (common.log_amp_phase_pullback if is_complex
                       else common.log_derivative_pullback)

        n_batches = cfg.num_batches_per_epoch
        device = sampler.configs.device
        cdtype = torch.complex64 if is_complex else torch.float32

        def zeros():
            return tree_map(torch.zeros_like, params)

        def add(a, b):
            return tree_map(torch.add, a, b)

        g_plain, g_oi, g_scaled = zeros(), zeros(), zeros()
        g_s_re = [zeros() for _ in range(n_lower)]
        g_s_im = [zeros() for _ in range(n_lower)]
        e_mean = torch.zeros((), dtype=cdtype, device=device)
        e2_mean = torch.zeros((), device=device)
        a_list = [torch.zeros((), dtype=cdtype, device=device)
                  for _ in range(n_lower)]
        b_list = [torch.zeros((), dtype=cdtype, device=device)
                  for _ in range(n_lower)]
        for _ in range(n_batches):
            configs = sampler.configs
            inv = 1.0 / (configs.shape[0] * n_batches)
            amp, pullback = pullback_of(wf, params, configs)
            with torch.no_grad():
                e_loc = ham.local_value(wf, params, configs, amp)
            ones = torch.full((configs.shape[0],), inv, device=device)
            if is_complex:
                zero = torch.zeros_like(ones)
                g_plain = add(g_plain, pullback(ones, zero))
                g_oi = add(g_oi, pullback(zero, ones))
                g_scaled = add(g_scaled, pullback(e_loc.real * inv,
                                                  e_loc.imag * inv))
            else:
                g_plain = add(g_plain, pullback(ones))
                g_scaled = add(g_scaled, pullback(e_loc * inv))
            e2_mean = e2_mean + torch.sum(torch.abs(e_loc) ** 2) * inv
            e_mean = e_mean + torch.sum(e_loc) * inv

            for k in range(n_lower):
                wf_k, p_k = self.lower_wfs[k], self.lower_params[k]
                y = lowers[k].configs
                inv_y = 1.0 / (y.shape[0] * n_batches)
                amp_y, pull_y = pullback_of(wf, params, y)
                with torch.no_grad():
                    # A_k = <psi_k/psi> over this batch's psi-samples.
                    r = common.normalized_ratio(wf_k.apply(p_k, configs),
                                                amp)
                    # B_k and <s O> over the frozen chain's samples.
                    s = common.normalized_ratio(amp_y, wf_k.apply(p_k, y))
                a_list[k] = a_list[k] + torch.sum(r).to(cdtype) * inv
                b_list[k] = b_list[k] + torch.sum(s).to(cdtype) * inv_y
                if is_complex:
                    # Re<sO> and Im<sO> with O = O_r + i O_i.
                    g_s_re[k] = add(g_s_re[k], pull_y(s.real * inv_y,
                                                      -s.imag * inv_y))
                    g_s_im[k] = add(g_s_im[k], pull_y(s.imag * inv_y,
                                                      s.real * inv_y))
                else:
                    g_s_re[k] = add(g_s_re[k], pull_y(s * inv_y))
                lowers[k] = self.lower_sweeps[k](
                    p_k, lowers[k], cfg.num_monte_carlo_sweeps)
            sampler = self.sweeps(params, sampler, cfg.num_monte_carlo_sweeps)

        (g_plain, g_oi, g_scaled, g_s_re, g_s_im, e_mean, e2_mean, a_list,
         b_list, acc) = common.pmean(
            (g_plain, g_oi, g_scaled, g_s_re, g_s_im, e_mean, e2_mean,
             a_list, b_list, metropolis.acceptance_rate(sampler)), group)
        # Energy gradient (variance-reduced), as EnergyGradientOptimizer.
        grads = common.tree_weighted_diff(g_scaled, g_plain, e_mean.real)
        if is_complex:
            grads = common.tree_weighted_diff(grads, g_oi, e_mean.imag)
        energy = e_mean.real
        variance = e2_mean - torch.abs(e_mean) ** 2

        # Penalty gradients: 2 lambda Re[conj(A)<sO> − F <O_r>].
        overlap_total = torch.zeros((), device=device)
        lam2 = 2.0 * self.penalty
        for k in range(n_lower):
            a_k = a_list[k]
            fid = (a_k * b_list[k]).real
            overlap_total = overlap_total + fid
            if is_complex:
                # Re[conj(A)<sO>] = ReA·Re<sO> + ImA·Im<sO>.
                grads = tree_map(
                    lambda g, gre, gim, gp: g + lam2 * (
                        a_k.real * gre + a_k.imag * gim - fid * gp),
                    grads, g_s_re[k], g_s_im[k], g_plain)
            else:
                grads = tree_map(
                    lambda g, gs, gp: g + lam2 * (a_k * gs - fid * gp),
                    grads, g_s_re[k], g_plain)

        new_params, opt_state = self.sgd.update(grads, state.opt_state,
                                                params, state.epoch)
        metrics = {
            'energy': energy,
            'energy_variance': variance,
            'overlap': overlap_total,
            'loss': energy + self.penalty * overlap_total,
            'acceptance_rate': acc,
            'grad_norm': common.grad_global_norm(grads),
        }
        return TrainState(params=new_params, opt_state=opt_state,
                          sampler=sampler, epoch=state.epoch + 1,
                          extra={**state.extra, 'lower_samplers': lowers}
                          ), metrics


class SRPenaltyExcitedOptimizer(_FrozenStates, StochasticReconfiguration):
    """Natural-gradient excited-state search, 'ExcitedSR'.

    The penalty force is a covariance over the psi-samples,

        dF = 2 Re[ F/A * <conj(r) O>_X  -  F <O_r>_X ],   A = <r>_X,

    exactly the form minSR already solves — so the whole SR pipeline
    (solvers, trust region, residual rejection) applies unchanged with an
    effective local value

        e_solver(x) = E_loc(x) + lambda * Σ_k (F_k/A_k) * r_k(x)

    (the -F<O_r> piece comes from the solver's own centering).  The frozen
    chains set only the scalar coefficients, so they advance by
    num_monte_carlo_sweeps an epoch.
    """

    name = 'ExcitedSR'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config,
                 lower_states: Optional[
                     Sequence[Tuple[Wavefunction, Params]]] = None):
        StochasticReconfiguration.__init__(self, wf, hamiltonian, config)
        self._init_lower(config, lower_states)

    def init_state(self, seed: int, device,
                   n_local_chains: Optional[int] = None) -> TrainState:
        state = StochasticReconfiguration.init_state(self, seed, device,
                                                     n_local_chains)
        return state._replace(extra={
            **state.extra,
            'lower_samplers': self._lower_samplers(seed, device,
                                                   n_local_chains)})

    def _solver_residual(self, params, all_configs, amp, e_loc, state,
                         group=None):
        cfg = self.config
        lowers = [metropolis.reset_stats(s)
                  for s in state.extra['lower_samplers']]
        self._check_complex(amp.log.is_complex(), lowers)
        e_solver = e_loc
        overlap_total = torch.zeros((), device=all_configs.device)
        new_lowers = []
        with torch.no_grad():
            for k, (wf_k, p_k) in enumerate(zip(self.lower_wfs,
                                                self.lower_params)):
                r = common.normalized_ratio(wf_k.apply(p_k, all_configs),
                                            amp)
                y = lowers[k].configs
                s = common.normalized_ratio(self.wf.apply(params, y),
                                            wf_k.apply(p_k, y))
                a_k, b_k = common.pmean((torch.mean(r), torch.mean(s)),
                                        group)
                fid = (a_k * b_k).real
                overlap_total = overlap_total + fid
                denom = a_k + torch.where(torch.abs(a_k) < 1e-20, 1e-20, 0.0)
                e_solver = e_solver + self.penalty * (fid / denom) * r
                new_lowers.append(self.lower_sweeps[k](
                    p_k, lowers[k], cfg.num_monte_carlo_sweeps))
        extra = {**state.extra, 'lower_samplers': new_lowers}
        return e_solver, extra, {'overlap': overlap_total}
