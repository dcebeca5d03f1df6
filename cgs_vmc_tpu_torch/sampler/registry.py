"""Fast-path sampler registry (port of cgs_vmc_tpu/sampler/registry.py).

Each fast path is an entry with a ``supports(wf, config)`` predicate and a
``make(wf, config)`` factory; entries are consulted in descending priority
and the generic Metropolis sampler is the fallback.  The built-in entries,
with the JAX package's priorities and predicates:

====================  ========  =====================================
entry                 priority  condition
====================  ========  =====================================
tempering                  150  config.pt_replicas >= 2 (either move)
mtm                        100  config.mtm_candidates > 1
exact_autoregressive        95  autoregressive ansatz (bare, or the
                                modulus of a 'complex' one), Sz = 0,
                                use_fast_sampler
mps_env                     90  config.mps_incremental_sweeps (opt-in)
rbm_kernel                  50  pure RBM + use_fast_sampler
jastrow_delta               45  plain Jastrow + use_fast_sampler
pbdg_sherman_morrison       40  ProjectedBDG + use_fast_sampler
generic                   -inf  always
====================  ========  =====================================

All but 'tempering' decline a non-exchange move.  The JAX package names
the RBM entry 'rbm_pallas' and offers it on a TPU only; here 'rbm_kernel'
has no backend gate: it is chosen for a pure RBM on any
device, and the kernel wrappers dispatch on the tensors' device (the plain
versions on the CPU, the CUDA kernels on a card).  FullyConnectedNNB has no
incremental entry: its pairing matrix is emitted by an MLP of the whole
configuration, so one exchange moves every entry and the determinant
update is not low-rank.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, NamedTuple

from cgs_vmc_tpu_torch.models.base import Wavefunction
from cgs_vmc_tpu_torch.sampler import (
    fast_ar, fast_jastrow, fast_mps, fast_pbdg, fast_rbm, mtm, tempering)
from cgs_vmc_tpu_torch.sampler import metropolis as mp
from cgs_vmc_tpu_torch.utils.profiling import span

# sweeps_fn(params, sampler_state, num_sweeps) -> sampler_state
SweepsFn = Callable[..., mp.SamplerState]


class FastPath(NamedTuple):
    name: str
    priority: float
    supports: Callable[[Wavefunction, object], bool]
    make: Callable[[Wavefunction, object], SweepsFn]


_REGISTRY: List[FastPath] = []


def register_fast_path(name: str, *, priority: float,
                       supports: Callable[[Wavefunction, object], bool],
                       make: Callable[[Wavefunction, object], SweepsFn],
                       ) -> None:
    """Registers a sampler fast path (re-registering a name replaces it)."""
    global _REGISTRY
    _REGISTRY = [e for e in _REGISTRY if e.name != name]
    entry = FastPath(name, float(priority), supports, make)
    keys = [-e.priority for e in _REGISTRY]
    _REGISTRY.insert(bisect.bisect_right(keys, -entry.priority), entry)


def registered_fast_paths() -> List[FastPath]:
    return list(_REGISTRY)


def resolved_name(wf: Wavefunction, config) -> str:
    """Which entry resolve_sweeps_fn would pick."""
    for entry in _REGISTRY:
        if entry.supports(wf, config):
            return entry.name
    return 'generic'


def resolve_sweeps_fn(wf: Wavefunction, config) -> SweepsFn:
    """Highest-priority supporting fast path, else the generic sampler;
    each call is a ``sampler`` span (utils/profiling.py)."""
    fn = next((entry.make(wf, config) for entry in _REGISTRY
               if entry.supports(wf, config)), None)
    if fn is None:
        move = mp.move_type(config)

        def fn(params, state, num_sweeps):
            return mp.run_sweeps(wf, params, state, num_sweeps, move)

    def sweeps(params, state, num_sweeps):
        with span('sampler', state.configs.device):
            return fn(params, state, num_sweeps)
    return sweeps


def check_state(wf: Wavefunction, config, state: mp.SamplerState) -> None:
    """Entry-time check of the chosen path's preconditions on `state` (the
    RBM kernels' Sz=0 sector).  Reads the chains back to the host: call it
    once per run, not per sweeps call."""
    if resolved_name(wf, config) == 'rbm_kernel':
        fast_rbm.check_sector(state.configs)


def _exchange_only(config) -> bool:
    return mp.move_type(config) == 'exchange'


def _use_fast(config) -> bool:
    return bool(getattr(config, 'use_fast_sampler', True))


def _make_from(module) -> Callable[[Wavefunction, object], SweepsFn]:
    """The factory of a sampler module with run_sweeps(wf, params, state,
    num_sweeps)."""
    def make(wf, config):
        def sweeps(params, state, num_sweeps):
            return module.run_sweeps(wf, params, state, num_sweeps)
        return sweeps
    return make


def _pt_supports(wf, config) -> bool:
    # Parallel tempering replaces the whole sweep discipline (replica
    # ladder + swap rounds), so the explicit knob outranks every
    # single-temperature path; it composes with either move type.
    n = getattr(config, 'pt_replicas', 0)
    return bool(n and n >= 2)


def _pt_make(wf, config) -> SweepsFn:
    move = mp.move_type(config)

    def sweeps(params, state, num_sweeps):
        return tempering.run_sweeps(wf, params, state, num_sweeps, move=move)
    return sweeps


def _mtm_supports(wf, config) -> bool:
    k = getattr(config, 'mtm_candidates', 0)
    return _exchange_only(config) and bool(k and k > 1)


def _mtm_make(wf, config) -> SweepsFn:
    k = config.mtm_candidates

    def sweeps(params, state, num_sweeps):
        return mtm.run_sweeps(wf, params, state, num_sweeps, k=k)
    return sweeps


def _ar_supports(wf, config) -> bool:
    # Exact ancestral sampling replaces Metropolis only within the move
    # semantics it reproduces: the conditionals are Sz=0-sector-projected,
    # the exchange move's state space.
    return (_exchange_only(config) and not getattr(config, 'total_sz2', 0)
            and _use_fast(config) and fast_ar.supports(wf))


def _mps_supports(wf, config) -> bool:
    return (_exchange_only(config)
            and bool(getattr(config, 'mps_incremental_sweeps', False))
            and fast_mps.supports(wf))


def _rbm_supports(wf, config) -> bool:
    # total_sz2: the rank picks cover exactly n_sites//2 down spins.
    return (_exchange_only(config) and not getattr(config, 'total_sz2', 0)
            and _use_fast(config) and fast_rbm.supports(wf))


def _jastrow_supports(wf, config) -> bool:
    return (_exchange_only(config) and _use_fast(config)
            and fast_jastrow.supports(wf))


def _pbdg_supports(wf, config) -> bool:
    # total_sz2: the pairing submatrix is n/2 x n/2 (half filling).
    return (_exchange_only(config) and not getattr(config, 'total_sz2', 0)
            and _use_fast(config) and fast_pbdg.supports(wf))


register_fast_path('tempering', priority=150, supports=_pt_supports,
                   make=_pt_make)
register_fast_path('mtm', priority=100, supports=_mtm_supports,
                   make=_mtm_make)
register_fast_path('exact_autoregressive', priority=95,
                   supports=_ar_supports, make=_make_from(fast_ar))
register_fast_path('mps_env', priority=90, supports=_mps_supports,
                   make=_make_from(fast_mps))
register_fast_path('rbm_kernel', priority=50, supports=_rbm_supports,
                   make=_make_from(fast_rbm))
register_fast_path('jastrow_delta', priority=45, supports=_jastrow_supports,
                   make=_make_from(fast_jastrow))
register_fast_path('pbdg_sherman_morrison', priority=40,
                   supports=_pbdg_supports, make=_make_from(fast_pbdg))
