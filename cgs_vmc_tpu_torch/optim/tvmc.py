"""Time-dependent variational Monte Carlo, t-VMC / TDVP (port of
cgs_vmc_tpu/optim/tvmc.py).

Evolves the variational state under the time-dependent variational
principle

    S(theta) theta_dot = f,     S = Re<O* O>_c   (the quantum metric),

with O_k = d log psi / d theta_k and the force

    imaginary time:  f = -Re<O* (E_loc - <E>)>   (energy descent, the SR
                                                  flow),
    real time:       f = +Im<O* (E_loc - <E>)>   (unitary dynamics; needs
                                                  a complex-log ansatz).

The solve is the sample-space push-through of dense SR (optim/sr.py): with
a complex log, stacking the real and imaginary Jacobian halves
J = [O_re; O_im] makes S = Jᵀ W J, and both forces are Jᵀ against a
stacked residual:

    Re<O* eps>  -> Jᵀ [w*eps_re; w*eps_im]
    Im<O* eps>  -> Jᵀ [w*eps_im; -w*eps_re]   (O* flips O_im's sign)

so real- and imaginary-time steps share one [2M, 2M] Cholesky solve, in
full f32 (TF32 off).  `weights` generalizes the 1/M Monte Carlo measure to
any probabilities: on the full basis with |psi|² weights a complete
(modulus, phase) parameterization reproduces exact Schrödinger dynamics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, tree_map
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.optim import common
from cgs_vmc_tpu_torch.optim.sr import (
    _imag, _stacked, flatten_params, jacobian_rows, matmul_precision)
from cgs_vmc_tpu_torch.sampler import metropolis


def tdvp_direction(
    wf: Wavefunction,
    params: Params,
    configs: torch.Tensor,
    e_loc: torch.Tensor,
    mode: str = 'real',
    diag_shift: float = 1e-4,
    weights: Optional[torch.Tensor] = None,
    jacobian_chunk: int = 0,
) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """Solves S theta_dot = f; returns (theta_dot params, <E_loc>, r2).

    mode: 'real' (unitary dynamics, complex-log ansatz required) or 'imag'
    (normalized imaginary-time flow, the SR descent direction; real
    ansatzes too).  jacobian_chunk > 0 takes the Jacobian rows that many
    samples at a time.

    r2 is the McLachlan residual distance ||Σ_k theta_dot_k O_k psi -
    psi_dot_exact||² / ||psi||² = <|eps|²> - theta_dot·f at the solution:
    the rate at which the variational manifold fails to follow the exact
    flow (0 for a complete parameterization).  Nothing is read back to the
    host: a system that is not positive definite gives NaNs.
    """
    if mode not in ('real', 'imag'):
        raise ValueError(f"mode must be 'real' or 'imag', got {mode!r}")
    m = configs.shape[0]
    if weights is None:
        weights = torch.full((m,), 1.0 / m, device=configs.device)
    is_complex = e_loc.is_complex()
    if mode == 'real' and not is_complex:
        raise ValueError(
            'Real-time TDVP needs a complex-log ansatz: a real '
            'wavefunction cannot acquire the phases unitary dynamics '
            "produces (use wavefunction_type='complex').")
    flat, unflatten = flatten_params(params)

    def single_log(p_flat, config):
        return wf.apply(unflatten(p_flat), config[None, :]).log[0]

    sqrt_w = torch.sqrt(weights)

    def scaled_rows(fn):
        rows = jacobian_rows(fn, flat, configs, jacobian_chunk)
        centered = rows - torch.sum(weights[:, None] * rows, dim=0,
                                    keepdim=True)
        return sqrt_w[:, None] * centered

    e_loc = e_loc.detach()
    e_mean = torch.sum(weights * e_loc)
    eps = e_loc - e_mean
    if is_complex:
        jac = torch.cat([scaled_rows(lambda p, c: single_log(p, c).real),
                         scaled_rows(lambda p, c: _imag(single_log(p, c)))])
        # real: f = +Im<O* eps> -> [eps_im; -eps_re] = stacked(-i eps);
        # imag: f = -Re<O* eps> -> -[eps_re; eps_im].
        resid = torch.cat([sqrt_w, sqrt_w]) * _stacked(
            eps * (-1j if mode == 'real' else -1.0))
    else:
        jac = scaled_rows(single_log)                         # [M, P]
        resid = -sqrt_w * eps                                 # imag mode

    # theta_dot = (JᵀJ + eps I_P)⁻¹ Jᵀ r = Jᵀ (J Jᵀ + eps I)⁻¹ r.
    with matmul_precision('highest'):
        t_matrix = jac @ jac.T
        diag_scale = torch.mean(torch.diagonal(t_matrix)) + 1e-30
        t_matrix = t_matrix + (diag_shift * diag_scale) * torch.eye(
            jac.shape[0], dtype=t_matrix.dtype, device=t_matrix.device)
        chol, info = torch.linalg.cholesky_ex(t_matrix)
        y = torch.cholesky_solve(resid[:, None], chol)[:, 0]
        y = torch.where(info == 0, y, torch.full_like(y, torch.nan))
        both = jac.T @ torch.stack([y, resid], dim=1)
        theta_dot, force = both[:, 0], both[:, 1]
        # McLachlan distance: <|eps|²> - theta_dot·f  (f = Jᵀ resid).
        eps2 = torch.sum(weights * torch.abs(eps) ** 2)
        r2 = eps2 - theta_dot @ force
    return unflatten(theta_dot), e_mean, torch.clamp(r2, min=0.0)


def _axpy(params: Params, step, direction: Params) -> Params:
    """params + step * direction, leafwise."""
    return tree_map(lambda p, d: p + step * d, params, direction)


class TimeEvolution:
    """Drives t-VMC: sample, solve the TDVP system, integrate.

    Integrators: 'euler' (one direction solve per step) and 'heun' (a
    midpoint correction on the same sample set: second order in dt at one
    extra solve).
    """

    name = 'TVMC'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config,
                 dt: float, mode: str = 'real',
                 integrator: str = 'heun',
                 adaptive_tol: float = 0.0):
        """adaptive_tol > 0 enables step-size control: the Heun embedded
        error ||k2 - k1||·dt/2 (relative to ||k1||·dt) is driven toward the
        tolerance, dt rescaled by clip(sqrt(tol/err), 0.5, 1.5) a step."""
        if integrator not in ('euler', 'heun'):
            raise ValueError(f'Unknown integrator {integrator!r}')
        if adaptive_tol and integrator != 'heun':
            raise ValueError('adaptive_tol requires the heun integrator '
                             '(the embedded error estimate)')
        self.wf = wf
        self.hamiltonian = hamiltonian
        self.config = config
        self.dt = float(dt)
        self.mode = mode
        self.integrator = integrator
        self.adaptive_tol = float(adaptive_tol)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def init_state(self, seed: int, params: Params, device
                   ) -> metropolis.SamplerState:
        return metropolis.init_sampler_for(seed, self.wf, params,
                                           self.config, device)

    def direction(self, params: Params, configs: torch.Tensor):
        """(theta_dot, <E_loc>, r2) at `params` on the sampled configs."""
        with torch.no_grad():
            e_loc = self.hamiltonian.local_value(self.wf, params, configs)
        return tdvp_direction(self.wf, params, configs, e_loc, self.mode,
                              self.config.sr_diag_shift,
                              jacobian_chunk=self.config.sr_jacobian_chunk)

    def step(self, params: Params, sampler: metropolis.SamplerState,
             dt: Optional[float] = None
             ) -> Tuple[Params, metropolis.SamplerState,
                        Dict[str, torch.Tensor]]:
        """One dt of evolution: decorrelate, solve, integrate.  Metrics
        are device scalars (no host sync here)."""
        cfg = self.config
        dt = self.dt if dt is None else float(dt)
        sampler = metropolis.refresh_amplitudes(self.wf, params, sampler)
        sampler = self.sweeps(params, sampler, cfg.num_monte_carlo_sweeps)
        configs = sampler.configs

        k1, e_mean, r2 = self.direction(params, configs)
        if self.integrator == 'heun':
            k2, _, _ = self.direction(_axpy(params, 0.5 * dt, k1), configs)
            new_params = _axpy(params, dt, k2)
            # Embedded (Euler vs Heun) error, relative to the step size.
            diff = tree_map(torch.subtract, k2, k1)
            err = 0.5 * common.grad_global_norm(diff) / (
                common.grad_global_norm(k1) + 1e-30)
        else:
            new_params = _axpy(params, dt, k1)
            err = torch.zeros((), device=configs.device)
        metrics = {'energy': e_mean.real,
                   'energy_imag': _imag(e_mean),
                   'tdvp_r2': r2,
                   'integrator_rel_error': err,
                   'dt': torch.tensor(dt, dtype=torch.float32)}
        return new_params, sampler, metrics

    def evolve(self, params: Params, sampler: metropolis.SamplerState,
               n_steps: int,
               observe: Optional[Callable[[Params], Dict]] = None,
               ) -> Tuple[Params, metropolis.SamplerState, list]:
        """Integrates n_steps of dt; `observe(params)` is recorded each step
        beside the metrics.  With adaptive_tol set, dt is rescaled between
        steps from the embedded error estimate."""
        records = []
        dt = self.dt
        for _ in range(n_steps):
            params, sampler, metrics = self.step(params, sampler, dt)
            rec = {k: float(v) for k, v in metrics.items()}
            if observe is not None:
                rec.update(observe(params))
            records.append(rec)
            if self.adaptive_tol:
                err = max(rec['integrator_rel_error'], 1e-12)
                dt *= float(np.clip(
                    np.sqrt(self.adaptive_tol / err), 0.5, 1.5))
        return params, sampler, records
