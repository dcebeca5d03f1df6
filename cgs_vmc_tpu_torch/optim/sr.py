"""Stochastic reconfiguration, natural-gradient VMC (port of
cgs_vmc_tpu/optim/sr.py, on one device).

Solves  (S + ε·I) · δ = g  where
  S_kj = <O_k O_j> − <O_k><O_j>,     O_k = d logψ / d θ_k,
  g_k  = <E_loc O_k> − <E_loc><O_k>.

Solvers (``config.sr_solver``):

 * 'dense' (default): materialize the centered log-derivative Jacobian
   Ō [M samples, P params] and solve in sample space (minSR, the
   push-through identity)  δ = Ōᵀ (Ō Ōᵀ / M + ε I_M)⁻¹ ε̄ / M,  by a
   Cholesky factorization of the [M, M] system; ε is relative to the mean
   diagonal of Ō Ōᵀ / M.
 * 'dense_cg': the same assembled system, solved by conjugate gradients.
 * 'sample_cg': the same system by CG on the Jacobian itself, never
   forming the [M, M] matrix.
 * 'cg': matrix-free CG in parameter space, S·v through jvp/vjp of the
   batched logψ; ε is absolute here, as in the JAX package.

The per-sample Jacobian rows are ``torch.func.vmap(torch.func.grad(...))``
over one flat parameter vector (``sr_jacobian_chunk`` > 0 bounds the
backward pass's memory by running that many samples at a time).  The
``sr_matmul_precision`` knob sets the GEMMs of the assembly: 'highest' is
full f32, 'high' and 'default' allow TF32 on the card; the setting is
scoped to the solve and restored after it, and the Cholesky factorization
is always f32.  ``sr_fast_jacobian`` (the JAX package's im2col rows, off
by default there) has no counterpart: the port always takes the vmap rows,
which are the same numbers.

Everything stays on the device: a non-positive-definite system gives NaNs
(``cholesky_ex`` reports it in ``info``, with no exception and no host
sync), and the non-finite fallback then takes the raw gradient, as in the
JAX package.  The CG loops run ``sr_cg_maxiter`` iterations with the
converged state frozen by masks instead of stopping early, so no iteration
reads a value back to the host.

Complex local values (a complex-phase ansatz, twisted boundaries): with
O_k = ∂log|ψ| + i·∂phase and real parameters, the metric S = Re⟨O*O⟩c and
the force Re⟨O*(E−Ē)⟩ are the real least-squares problem over the stacked
rows [Ō_re; Ō_im]·δ ≈ [Re ε; Im ε].  The sample-space solvers run unchanged
on that [2M, P] Jacobian (a [2M, 2M] system; the divisor stays M, the
sample count), and the parameter-space CG sums the matvecs of the two
parts.  The rows of each part are gradients of a real output, so autograd
never sees a complex cotangent.  The reported energy is the real part.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch

from cgs_vmc_tpu_torch.models.base import (
    Params, Wavefunction, tree_leaves, tree_map, tree_unflatten)
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.optim import common
from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.sampler import metropolis

_SOLVERS = ('dense', 'dense_cg', 'sample_cg', 'cg')
_TF32 = {'highest': False, 'high': True, 'default': True}


def flatten_params(params: Params
                   ) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Params]]:
    """(flat, unflatten): the leaves concatenated into one vector, and its
    inverse, which returns views of its argument in the params' structure
    (the counterpart of jax.flatten_util.ravel_pytree; leaves in
    tree_leaves order)."""
    leaves = tree_leaves(params)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.detach().reshape(-1) for leaf in leaves])

    def unflatten(vector: torch.Tensor) -> Params:
        parts = torch.split(vector, sizes)
        return tree_unflatten(params, [part.view(shape) for part, shape
                                       in zip(parts, shapes)])

    return flat, unflatten


def jacobian_rows(fn, flat_params: torch.Tensor, configs: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """Per-sample gradient rows [M, P] of fn(flat_params, config) via
    vmap(grad), `chunk` samples at a time when chunk > 0."""
    rows = torch.func.vmap(torch.func.grad(fn), in_dims=(None, 0),
                           chunk_size=chunk or None)
    return rows(flat_params, configs)


@contextlib.contextmanager
def matmul_precision(name: str):
    """Scoped cuBLAS TF32 setting for the SR GEMMs ('highest' = full f32;
    'high' / 'default' = TF32), restored on exit."""
    if name not in _TF32:
        raise ValueError(f'sr_matmul_precision {name!r}; known: '
                         f'{sorted(_TF32)}')
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = _TF32[name]
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _imag(x: torch.Tensor) -> torch.Tensor:
    """Imaginary part; zeros for a real tensor (whose .imag raises)."""
    return x.imag if x.is_complex() else torch.zeros_like(x)


def _stacked(eps: torch.Tensor) -> torch.Tensor:
    """[Re ε; Im ε] for complex local values, ε itself for real ones."""
    return torch.cat([eps.real, eps.imag]) if eps.is_complex() else eps


def _cg(matvec, b: torch.Tensor, tol: float, maxiter: int) -> torch.Tensor:
    """Conjugate gradients from x = 0 on a flat vector, stopping (by
    freezing the state) once |r|² <= tol²·|b|² or after maxiter steps —
    the JAX package's while-loop, run for maxiter steps with masks so that
    nothing is read back to the host."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.dot(b, b)
    tol2 = (tol ** 2) * rs
    for _ in range(maxiter):
        active = rs > tol2
        ap = matvec(p)
        alpha = rs / (torch.dot(p, ap) + 1e-38)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        rs_new = torch.dot(r_new, r_new)
        p_new = r_new + (rs_new / (rs + 1e-38)) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rs = torch.where(active, rs_new, rs)
    return x


class StochasticReconfiguration:
    """Ground-state optimizer 'SR'."""

    name = 'SR'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config):
        if config.sr_solver not in _SOLVERS:
            raise ValueError(f'sr_solver {config.sr_solver!r}; known: '
                             f'{list(_SOLVERS)}')
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

    def sample(self, params: Params, sampler: metropolis.SamplerState
               ) -> Tuple[metropolis.SamplerState, torch.Tensor]:
        """The epoch's sampling: equilibrate, then num_batches_per_epoch
        batches, each recorded before its decorrelation sweeps.  Returns
        (sampler, configs [batches·chains, n_sites])."""
        cfg = self.config
        sampler = metropolis.reset_stats(sampler)
        # Params changed since last epoch's sweeps wrote the amplitude cache.
        sampler = metropolis.refresh_amplitudes(self.wf, params, sampler)
        sampler = self.sweeps(params, sampler, cfg.num_equilibration_sweeps)
        batches = []
        for _ in range(cfg.num_batches_per_epoch):
            batches.append(sampler.configs)
            sampler = self.sweeps(params, sampler,
                                  cfg.num_monte_carlo_sweeps)
        return sampler, torch.cat(batches)

    def epoch(self, state: TrainState
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One SR epoch: sample, local energies, solve, gate, update.
        Metrics are device scalars (no host sync here)."""
        params = state.params
        sampler, all_configs = self.sample(params, state.sampler)
        with torch.no_grad():
            amp = self.wf.apply(params, all_configs)
            e_loc = self.hamiltonian.local_value(self.wf, params,
                                                 all_configs, amp)
        e_mean = torch.mean(e_loc)
        e2_mean = torch.mean(torch.abs(e_loc) ** 2)

        # Residual hook: subclasses may augment the solver's local values
        # while the reported energy stays the raw <E_loc>.
        e_solver, extra_state, extra_metrics = self._solver_residual(
            params, all_configs, amp, e_loc, state)
        new_params, opt_state, residual_norm, grad_e = (
            self.update_from_samples(params, state.opt_state, state.epoch,
                                     all_configs, e_solver))
        metrics = {
            'energy': e_mean.real,
            'energy_variance': e2_mean - torch.abs(e_mean) ** 2,
            'acceptance_rate': metropolis.acceptance_rate(sampler),
            'grad_norm': common.grad_global_norm(grad_e),
            'sr_residual_norm': residual_norm,
            **extra_metrics,
        }
        return TrainState(params=new_params, opt_state=opt_state,
                          sampler=sampler, epoch=state.epoch + 1,
                          extra=extra_state), metrics

    def update_from_samples(self, params: Params, opt_state, epoch: int,
                            all_configs: torch.Tensor, e_solver: torch.Tensor,
                            e_solver_mean: Optional[torch.Tensor] = None):
        """Solve + gate + apply one SR step from a pre-sampled batch.

        Gating, as the JAX package: a non-finite δ falls back to the raw
        gradient; with sr_reject_residual > 0 the step is zeroed when the
        solve's residual exceeds sr_reject_residual·|g|; δ is clipped to
        norm sr_delta_clip.  Returns (new_params, new_opt_state,
        residual_norm, grad_e).
        """
        cfg = self.config
        if e_solver_mean is None:
            e_solver_mean = torch.mean(e_solver)
        e_solver = e_solver.detach()
        solver = cfg.sr_solver
        if solver in ('dense', 'dense_cg'):
            delta, grad_e, residual_norm = self._dense_solve(
                all_configs, params, e_solver, e_solver_mean,
                use_cg=(solver == 'dense_cg'))
        elif solver == 'sample_cg':
            delta, grad_e, residual_norm = self._sample_cg_solve(
                all_configs, params, e_solver, e_solver_mean)
        else:
            delta, grad_e, residual_norm = self._cg_solve(
                all_configs, params, e_solver, e_solver_mean)

        finite = torch.stack([torch.isfinite(leaf).all()
                              for leaf in tree_leaves(delta)]).all()
        delta = tree_map(lambda d, g: torch.where(finite, d, g),
                         delta, grad_e)
        if cfg.sr_reject_residual > 0:
            ok = torch.logical_or(
                ~finite,  # the fallback gradient is always usable
                residual_norm < cfg.sr_reject_residual
                * (common.grad_global_norm(grad_e) + 1e-12))
            delta = tree_map(lambda d: torch.where(ok, d, torch.zeros_like(d)),
                             delta)
        delta_norm = common.grad_global_norm(delta)
        clip = torch.clamp(cfg.sr_delta_clip / (delta_norm + 1e-12),
                           max=1.0)
        delta = tree_map(lambda d: d * clip, delta)

        new_params, opt_state = self.sgd.update(delta, opt_state, params,
                                                epoch)
        return new_params, opt_state, residual_norm, grad_e

    def _solver_residual(self, params, all_configs, amp, e_loc, state):
        """Hook: (solver local values, new extra dict, extra metrics).

        The base optimizer solves against the plain local energies;
        subclasses may add penalty terms expressible as extra local values
        over the same samples."""
        del params, all_configs, amp
        return e_loc, dict(state.extra), {}

    # ------------------------------------------------------------------
    # Solvers.
    # ------------------------------------------------------------------

    def _centered_jacobian(self, all_configs: torch.Tensor, params: Params,
                           stacked: bool = False):
        """(Ō centered over the samples, unflatten): [M, P] rows of ∂logψ,
        or with `stacked` (complex local values) the [2M, P] rows
        [Ō_re; Ō_im] of ∂log|ψ| and ∂phase, each part centered by
        itself."""
        flat, unflatten = flatten_params(params)
        wf = self.wf

        def single_log(p_flat, config):
            return wf.apply(unflatten(p_flat), config[None, :]).log[0]

        def centered_rows(fn):
            raw = jacobian_rows(fn, flat, all_configs,
                                self.config.sr_jacobian_chunk)
            return raw - torch.mean(raw, dim=0, keepdim=True)

        if not stacked:
            return centered_rows(single_log), unflatten
        return torch.cat([
            centered_rows(lambda p, c: single_log(p, c).real),
            centered_rows(lambda p, c: _imag(single_log(p, c)))]), unflatten

    def _dense_solve(self, all_configs, params, e_loc, e_mean,
                     use_cg: bool = False):
        """Sample-space minSR: the centered Jacobian, then
        `_solve_sample_space` on it."""
        jac, unflatten = self._centered_jacobian(all_configs, params,
                                                 e_loc.is_complex())
        delta, grad_e, residual_norm = self._solve_sample_space(
            jac, e_loc - e_mean, use_cg)
        return unflatten(delta), unflatten(grad_e), residual_norm

    def _solve_sample_space(self, jac: torch.Tensor, eps: torch.Tensor,
                            use_cg: bool = False):
        """δ = Ōᵀ (Ō Ōᵀ/M + εI)⁻¹ ε̄ / M with ε relative to the mean
        diagonal, by Cholesky or, with use_cg ('dense_cg'), by CG on the
        assembled system (its matvec in full f32).  `eps` holds the M
        centered local values; complex ones go with the 2M stacked rows of
        `_centered_jacobian` and are stacked alike here.  Returns flat (δ,
        g, |residual|)."""
        cfg = self.config
        n_rows, m = jac.shape[0], eps.shape[0]
        with matmul_precision(cfg.sr_matmul_precision):
            t_matrix = (jac @ jac.T) / m
            diag_scale = torch.mean(torch.diagonal(t_matrix)) + 1e-12
            t_matrix = t_matrix + (cfg.sr_diag_shift * diag_scale) * torch.eye(
                n_rows, dtype=t_matrix.dtype, device=t_matrix.device)
            rhs = _stacked(eps) / m
            if use_cg:
                with matmul_precision('highest'):
                    y = _cg(lambda v: t_matrix @ v, rhs, cfg.sr_cg_tol,
                            cfg.sr_cg_maxiter)
            else:
                chol, info = torch.linalg.cholesky_ex(t_matrix)
                y = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
                # Not positive definite: NaNs, so the gate falls back.
                y = torch.where(info == 0, y, torch.full_like(y, torch.nan))
            # One back-GEMM for δ = Jᵀy, g = Jᵀ(ε̄/M) and the parameter-
            # space residual Jᵀ(Ty − ε̄/M) = Sδ + ε_eff δ − g.
            r_sample = t_matrix @ y - rhs
            combo = jac.T @ torch.stack([y, rhs, r_sample], dim=1)
        return combo[:, 0], combo[:, 1], torch.linalg.vector_norm(combo[:, 2])

    def _sample_cg_solve(self, all_configs, params, e_loc, e_mean):
        """The same sample-space system as `_dense_solve`, solved by CG on
        the centered Jacobian (u = Ōᵀx, then Ō u per iteration) without
        forming the [M, M] matrix."""
        cfg = self.config
        jac, unflatten = self._centered_jacobian(all_configs, params,
                                                 e_loc.is_complex())
        m = e_loc.shape[0]
        b = _stacked(e_loc - e_mean) / m
        # Scale-invariant shift: mean_i(|row_i|²/M) over the M or 2M rows.
        shift = cfg.sr_diag_shift * (
            torch.sum(jac * jac) / (jac.shape[0] * m) + 1e-12)
        with matmul_precision(cfg.sr_matmul_precision):
            def matvec(x):
                return jac @ (jac.T @ x) / m + shift * x

            y = _cg(matvec, b, cfg.sr_cg_tol, cfg.sr_cg_maxiter)
            delta = jac.T @ y
            grad = jac.T @ b
            residual = jac.T @ (matvec(y) - b)
        return (unflatten(delta), unflatten(grad),
                torch.linalg.vector_norm(residual))

    def _cg_solve(self, all_configs, params, e_loc, e_mean):
        """Matrix-free CG in parameter space: S·v = Jᵀ(Jv − <Jv>)/M + ε v
        through jvp and vjp of the batched logψ (O(params) memory).  A
        complex log contributes the sum of its real and imaginary parts'
        matvecs and forces, each from a real-valued function; a real log
        takes the real part of the local values."""
        cfg = self.config
        flat, unflatten = flatten_params(params)
        wf = self.wf
        m = all_configs.shape[0]

        def log_fn(p_flat):
            return wf.apply(unflatten(p_flat), all_configs).log

        eps = e_loc - e_mean
        with torch.no_grad():
            complex_log = log_fn(flat).is_complex()
        if complex_log:
            parts = [(lambda p: log_fn(p).real, eps.real),
                     (lambda p: log_fn(p).imag, _imag(eps))]
        else:
            parts = [(log_fn, eps.real)]
        pullbacks = [torch.func.vjp(fn, flat)[1] for fn, _ in parts]

        grad_e = sum(pullback(part_eps / m)[0]
                     for pullback, (_, part_eps) in zip(pullbacks, parts))

        def matvec(v):
            # Centered algebraically: S v = <O·(Jv − <Jv>)>.
            out = cfg.sr_diag_shift * v
            for pullback, (fn, _) in zip(pullbacks, parts):
                _, jv = torch.func.jvp(fn, (flat,), (v,))
                out = out + pullback((jv - torch.mean(jv)) / m)[0]
            return out

        delta = _cg(matvec, grad_e, cfg.sr_cg_tol, cfg.sr_cg_maxiter)
        residual = matvec(delta) - grad_e
        return (unflatten(delta), unflatten(grad_e),
                torch.linalg.vector_norm(residual))
