"""Stochastic reconfiguration, natural-gradient VMC (port of
cgs_vmc_tpu/optim/sr.py).

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
over one flat parameter vector, in blocks of samples: ``sr_jacobian_chunk``
> 0 samples a block, as set; with 0, on a card, the block is chosen once
for each sample count, on the first (eager) epoch before any capture, by
probing the rows' peak memory (`choose_row_block`): all M rows in one
block where they fit in a quarter of the card's free memory (the eager
epoch's cached memory and a captured graph's private pool each hold a
copy), else blocks of equal size that fit; not even one board raises.
Elsewhere one block.  The counter ``sr.row_blocks`` counts the blocks.  The
``sr_matmul_precision`` knob sets the GEMMs of the assembly: 'highest' is
full f32, 'high' and 'default' allow TF32 on the card; the setting is
scoped to the solve and restored after it, and the Cholesky factorization
is always f32.  With ``sr_fast_jacobian`` (off by default, as in the JAX
package) the real rows of a (symmetrized) conv, ResNet or PixelCNN come
from ``optim/fast_jacobian.py`` instead: im2col patches and per-sample
batched GEMMs, the same numbers to f32 rounding; any other ansatz, and the
stacked rows of a complex one, keep the vmap rows.

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

Under a chains group (parallel/mesh.py; ``group=None`` is one process)
each rank holds its own samples.  'dense' and 'dense_cg' all-gather the
Jacobian rows in rank order, center them with the global mean and solve
the global [M, M] system on every rank (a complex ansatz gathers the real
and imaginary rows apart and stacks them), so the update is the single
process's on the same samples.  The JAX package centers each shard by its
own mean before its gather, which makes its re-centering a no-op and its
sharded dense system not the global one (ROADMAP.md §3); its sharded
'sample_cg' centers with the global mean, as the port does everywhere.
'sample_cg' keeps the Jacobian sharded and psums the column sums, Jᵀx, the
dots and the shift; 'cg' pmeans its pullbacks and the mean of Jv.  The
energies and the acceptance rate are pmean'd.
"""

from __future__ import annotations

import contextlib
import gc
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cgs_vmc_tpu_torch.models.base import (
    Params, Wavefunction, tree_leaves, tree_map, tree_unflatten)
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.optim import common, fast_jacobian
from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.sampler import metropolis
from cgs_vmc_tpu_torch.utils import profiling

_SOLVERS = ('dense', 'dense_cg', 'sample_cg', 'cg')
_TF32 = {'highest': False, 'high': True, 'default': True}
# The share of the card's free memory the rows may take: the eager epoch's
# cached memory and a captured graph's private pool each hold a copy, and
# the other half is left to the epoch's other phases (which both pools
# also hold), library workspaces and what the process runs beside the
# graph (an eager epoch, an evaluation).
_ROWS_SHARE = 0.25
_FIRST_PROBE = 16        # boards of the first memory probe


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
    vmap(grad), in blocks of `chunk` samples when 0 < chunk < M (one block
    of all M otherwise), each block one vmap call written into its rows;
    the blocks are counted in ``sr.row_blocks``."""
    m = configs.shape[0]
    block = chunk if 0 < chunk < m else max(m, 1)
    rows = torch.func.vmap(torch.func.grad(fn), in_dims=(None, 0))
    profiling.count('sr.row_blocks', math.ceil(m / block))
    if block >= m:
        with profiling.vmapped(m):
            return rows(flat_params, configs)
    out = torch.empty((m, flat_params.numel()), dtype=flat_params.dtype,
                      device=flat_params.device)
    for start in range(0, m, block):
        part = configs[start:start + block]
        with profiling.vmapped(part.shape[0]):
            out[start:start + part.shape[0]] = rows(flat_params, part)
    return out


class _PeakAllocated(TorchDispatchMode):
    """Inside it, the largest of the card's allocated bytes read after
    every operation (`peak`): the probe's own memory, read without
    resetting the allocator's peak statistics."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device
        self.start = self.peak = torch.cuda.memory_allocated(device)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.peak = max(self.peak, torch.cuda.memory_allocated(self.device))
        return out


def _row_peak_bytes(fn, flat: torch.Tensor, configs: torch.Tensor) -> int:
    """Bytes the rows of `configs` hold on the card at their peak, above
    what was allocated before (counts and spans dropped).  Garbage of the
    earlier work is collected first: freed inside the probe, it would
    hide the probe's own bytes."""
    gc.collect()
    with profiling.capturing(), _PeakAllocated(configs.device) as probe:
        jacobian_rows(fn, flat, configs, 0)
    return probe.peak - probe.start


def choose_row_block(m: int, probe: Callable[[int], float],
                     row_bytes: float, budget: float) -> int:
    """The boards a block of the rows of `m` boards, so that the epoch's
    rows hold at most `budget` bytes: `m` where all fit, else the largest
    equal blocks that do.

    probe(b): the bytes the rows of b boards hold at their peak (their
    own [b, P] rows included); row_bytes: one board's row in the [M, P]
    Jacobian.  Beside a block the epoch holds the centered Jacobian and,
    with more than one block, the whole [M, P] the blocks are written
    into.  Probes grow by doubling while twice the probed boards still
    fit by the last estimate (whose per-board bytes, the fixed part
    included, only fall as the probe grows)."""
    b = min(m, _FIRST_PROBE)
    while True:
        per_board = probe(b) / b
        if m * (per_board + row_bytes) <= budget:
            return m
        fit = int((budget - 2.0 * m * row_bytes) // per_board)
        if fit < 1:
            raise RuntimeError(
                f'the SR Jacobian rows of one board ({per_board / 2**30:.2f}'
                f' GiB, with the [{m}, P] Jacobian twice beside them) do '
                f'not fit in the {budget / 2**30:.2f} GiB they may take of '
                "the card: take sr_solver 'cg' or fewer samples")
        if 2 * b > fit or b >= m:
            return math.ceil(m / math.ceil(m / fit))
        b = min(m, 2 * b)


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


def _cg(matvec, b: torch.Tensor, tol: float, maxiter: int,
        dot=torch.dot) -> torch.Tensor:
    """Conjugate gradients from x = 0 on a flat vector, stopping (by
    freezing the state) once |r|² <= tol²·|b|² or after maxiter steps —
    the JAX package's while-loop, run for maxiter steps with masks so that
    nothing is read back to the host.  `dot` is the inner product (psum'd
    over the ranks when the vectors are sharded)."""
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = dot(b, b)
    tol2 = (tol ** 2) * rs
    for _ in range(maxiter):
        active = rs > tol2
        ap = matvec(p)
        alpha = rs / (dot(p, ap) + 1e-38)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        rs_new = dot(r_new, r_new)
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
        self.fast_rows = (fast_jacobian.rows_fn_for(wf)
                          if config.sr_fast_jacobian else None)
        self.row_blocks: Dict[Tuple[int, int], int] = {}

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

    def epoch(self, state: TrainState, group=None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One SR epoch: sample, local energies, solve, gate, update, the
        moments over `group`'s ranks (None: this process's samples only).
        Metrics are device scalars (no host sync here)."""
        params = state.params
        sampler, all_configs = self.sample(params, state.sampler)
        with torch.no_grad():
            amp = self.wf.apply(params, all_configs)
            e_loc = self.hamiltonian.local_value(self.wf, params,
                                                 all_configs, amp)
        e_mean, e2_mean, acc = common.pmean(
            (torch.mean(e_loc), torch.mean(torch.abs(e_loc) ** 2),
             metropolis.acceptance_rate(sampler)), group)

        # Residual hook: subclasses may augment the solver's local values
        # while the reported energy stays the raw <E_loc>.
        e_solver, extra_state, extra_metrics = self._solver_residual(
            params, all_configs, amp, e_loc, state, group)
        new_params, opt_state, residual_norm, grad_e = (
            self.update_from_samples(params, state.opt_state, state.epoch,
                                     all_configs, e_solver, group=group))
        metrics = {
            'energy': e_mean.real,
            'energy_variance': e2_mean - torch.abs(e_mean) ** 2,
            'acceptance_rate': acc,
            'grad_norm': common.grad_global_norm(grad_e),
            'sr_residual_norm': residual_norm,
            **extra_metrics,
        }
        return TrainState(params=new_params, opt_state=opt_state,
                          sampler=sampler, epoch=state.epoch + 1,
                          extra=extra_state), metrics

    def update_from_samples(self, params: Params, opt_state, epoch: int,
                            all_configs: torch.Tensor, e_solver: torch.Tensor,
                            e_solver_mean: Optional[torch.Tensor] = None,
                            group=None):
        """Solve + gate + apply one SR step from a pre-sampled batch (this
        rank's samples when `group` is given).

        Gating, as the JAX package: a non-finite δ falls back to the raw
        gradient; with sr_reject_residual > 0 the step is zeroed when the
        solve's residual exceeds sr_reject_residual·|g|; δ is clipped to
        norm sr_delta_clip.  Returns (new_params, new_opt_state,
        residual_norm, grad_e).
        """
        cfg = self.config
        if e_solver_mean is None:
            e_solver_mean = common.pmean(torch.mean(e_solver), group)
        e_solver = e_solver.detach()
        solver = cfg.sr_solver
        if solver in ('dense', 'dense_cg'):
            delta, grad_e, residual_norm = self._dense_solve(
                all_configs, params, e_solver, e_solver_mean,
                use_cg=(solver == 'dense_cg'), group=group)
        elif solver == 'sample_cg':
            delta, grad_e, residual_norm = self._sample_cg_solve(
                all_configs, params, e_solver, e_solver_mean, group)
        else:
            delta, grad_e, residual_norm = self._cg_solve(
                all_configs, params, e_solver, e_solver_mean, group)

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

    def _solver_residual(self, params, all_configs, amp, e_loc, state,
                         group=None):
        """Hook: (solver local values, new extra dict, extra metrics).

        The base optimizer solves against the plain local energies;
        subclasses may add penalty terms expressible as extra local values
        over the same samples (their moments pmean'd over `group`)."""
        del params, all_configs, amp, group
        return e_loc, dict(state.extra), {}

    # ------------------------------------------------------------------
    # Solvers.
    # ------------------------------------------------------------------

    def _centered_jacobian(self, all_configs: torch.Tensor, params: Params,
                           stacked: bool = False, group=None,
                           keep_sharded: bool = False):
        """(Ō centered over the samples, unflatten): [M, P] rows of ∂logψ,
        or with `stacked` (complex local values) the [2M, P] rows
        [Ō_re; Ō_im] of ∂log|ψ| and ∂phase, each part centered by itself.
        Under `group` each part's rows are gathered from every rank in rank
        order before they are centered, so every rank holds the global
        rows, centered with the global mean; with `keep_sharded` each rank
        keeps its own rows, centered with the global mean of the psum'd
        column sums.  The real rows come from `fast_rows` when
        sr_fast_jacobian is set and the ansatz has them."""
        flat, unflatten = flatten_params(params)
        wf = self.wf

        def single_log(p_flat, config):
            return wf.apply(unflatten(p_flat), config[None, :]).log[0]

        def vmap_rows(fn):
            chunk = self._row_block(fn, flat, all_configs,
                                    2 if stacked else 1)
            return jacobian_rows(fn, flat, all_configs, chunk)

        def center(raw):
            if keep_sharded and group is not None:
                m = raw.shape[0] * common.group_size(group)
                return raw - common.psum(
                    torch.sum(raw, dim=0, keepdim=True), group) / m
            raw = common.all_gather_rows(raw, group)
            return raw - torch.mean(raw, dim=0, keepdim=True)

        if not stacked:
            raw = (vmap_rows(single_log) if self.fast_rows is None
                   else self.fast_rows(params, all_configs,
                                       self.config.sr_jacobian_chunk))
            return center(raw), unflatten
        return torch.cat([
            center(vmap_rows(lambda p, c: single_log(p, c).real)),
            center(vmap_rows(lambda p, c: _imag(single_log(p, c))))
        ]), unflatten

    def _row_block(self, fn, flat: torch.Tensor, configs: torch.Tensor,
                   parts: int) -> int:
        """The rows' block: sr_jacobian_chunk where set; on a card the
        block `choose_row_block` gives, chosen at the first call for each
        (sample count, parts) outside a capture and kept; else 0 (one
        block)."""
        chunk = self.config.sr_jacobian_chunk
        if chunk or configs.device.type != 'cuda':
            return chunk
        key = (configs.shape[0], parts)
        if key not in self.row_blocks:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f'no block chosen for the SR rows of {key[0]} samples: '
                    'an eager epoch before the capture chooses it')
            device = configs.device
            free = (torch.cuda.mem_get_info(device)[0]
                    + torch.cuda.memory_reserved(device)
                    - torch.cuda.memory_allocated(device))
            self.row_blocks[key] = choose_row_block(
                key[0], lambda b: _row_peak_bytes(fn, flat, configs[:b]),
                parts * flat.numel() * flat.element_size(),
                _ROWS_SHARE * free)
        return self.row_blocks[key]

    def _dense_solve(self, all_configs, params, e_loc, e_mean,
                     use_cg: bool = False, group=None):
        """Sample-space minSR: the centered (and, under `group`, gathered)
        Jacobian, then `_solve_sample_space` on it with the gathered
        centered local values."""
        jac, unflatten = self._centered_jacobian(all_configs, params,
                                                 e_loc.is_complex(), group)
        delta, grad_e, residual_norm = self._solve_sample_space(
            jac, common.all_gather_rows(e_loc - e_mean, group), use_cg)
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

    def _sample_cg_solve(self, all_configs, params, e_loc, e_mean,
                         group=None):
        """The same sample-space system as `_dense_solve`, solved by CG on
        the centered Jacobian (u = Ōᵀx, then Ō u per iteration) without
        forming the [M, M] matrix.  Under `group` the Jacobian stays
        sharded: its columns are centered by the psum'd column sums, and
        Jᵀx, the CG dots and the shift are psum'd over the ranks."""
        cfg = self.config
        jac, unflatten = self._centered_jacobian(
            all_configs, params, e_loc.is_complex(), group, keep_sharded=True)
        world = common.group_size(group)
        m = e_loc.shape[0] * world
        n_rows = jac.shape[0] * world
        b = _stacked(e_loc - e_mean) / m
        # Scale-invariant shift: mean_i(|row_i|²/M) over the M or 2M rows.
        shift = cfg.sr_diag_shift * (
            common.psum(torch.sum(jac * jac), group) / (n_rows * m) + 1e-12)

        def dot(u, v):
            return common.psum(torch.dot(u, v), group)

        with matmul_precision(cfg.sr_matmul_precision):
            def pullback(x):
                return common.psum(jac.T @ x, group)

            def matvec(x):
                return jac @ pullback(x) / m + shift * x

            y = _cg(matvec, b, cfg.sr_cg_tol, cfg.sr_cg_maxiter, dot)
            delta = pullback(y)
            grad = pullback(b)
            residual = pullback(matvec(y) - b)
        return (unflatten(delta), unflatten(grad),
                torch.linalg.vector_norm(residual))

    def _cg_solve(self, all_configs, params, e_loc, e_mean, group=None):
        """Matrix-free CG in parameter space: S·v = Jᵀ(Jv − <Jv>)/M + ε v
        through jvp and vjp of the batched logψ (O(params) memory).  A
        complex log contributes the sum of its real and imaginary parts'
        matvecs and forces, each from a real-valued function; a real log
        takes the real part of the local values.  Under `group` the
        pullbacks and <Jv> are pmean'd, so the parameter-space vectors are
        the same on every rank."""
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
        vjps = [torch.func.vjp(fn, flat)[1] for fn, _ in parts]
        pullbacks = [lambda w, vjp=vjp: common.pmean(vjp(w)[0], group)
                     for vjp in vjps]

        grad_e = sum(pullback(part_eps / m)
                     for pullback, (_, part_eps) in zip(pullbacks, parts))

        def matvec(v):
            # Centered algebraically: S v = <O·(Jv − <Jv>)>.
            out = cfg.sr_diag_shift * v
            for pullback, (fn, _) in zip(pullbacks, parts):
                _, jv = torch.func.jvp(fn, (flat,), (v,))
                jv_mean = common.pmean(torch.mean(jv), group)
                out = out + pullback((jv - jv_mean) / m)
            return out

        delta = _cg(matvec, grad_e, cfg.sr_cg_tol, cfg.sr_cg_maxiter)
        residual = matvec(delta) - grad_e
        return (unflatten(delta), unflatten(grad_e),
                torch.linalg.vector_norm(residual))
