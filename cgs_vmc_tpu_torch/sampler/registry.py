"""Fast-path sampler registry (port of cgs_vmc_tpu/sampler/registry.py).

Each fast path is an entry with a ``supports(wf, config)`` predicate and a
``make(wf, config)`` factory; entries are consulted in descending priority
and the generic Metropolis sampler is the fallback.  The port has one
built-in entry so far, the fused RBM kernels ('rbm_kernel', priority 50).
Unlike the JAX entry it has no backend gate: it is chosen for a pure RBM on
any device, and the kernel wrappers dispatch on the tensors' device (the
plain versions on the CPU, the CUDA kernels on a card).
"""

from __future__ import annotations

import bisect
from typing import Callable, List, NamedTuple

from cgs_vmc_tpu_torch.models.base import Wavefunction
from cgs_vmc_tpu_torch.sampler import fast_rbm
from cgs_vmc_tpu_torch.sampler import metropolis as mp

# sweeps_fn(params, sampler_state, num_sweeps) -> sampler_state
SweepsFn = Callable[..., mp.SamplerState]


class FastPath(NamedTuple):
    name: str
    priority: float
    supports: Callable[[Wavefunction, object], bool]
    make: Callable[[Wavefunction, object], SweepsFn]


_REGISTRY: List[FastPath] = []

# Config knobs that select, for any ansatz, a JAX sampler the port does not
# have yet (both outrank the RBM kernels in the JAX registry).
_UNPORTED_KNOBS = (('mtm_candidates', 'sampler/mtm.py'),
                   ('pt_replicas', 'sampler/tempering.py'))


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


def _check_ported(config) -> None:
    for knob, module in _UNPORTED_KNOBS:
        value = getattr(config, knob, 0) or 0
        if value >= 2:
            raise NotImplementedError(
                f'{knob}={value!r} selects {module}, which is not ported '
                'yet (ROADMAP.md lists the queue)')


def resolved_name(wf: Wavefunction, config) -> str:
    """Which entry resolve_sweeps_fn would pick."""
    _check_ported(config)
    for entry in _REGISTRY:
        if entry.supports(wf, config):
            return entry.name
    return 'generic'


def resolve_sweeps_fn(wf: Wavefunction, config) -> SweepsFn:
    """Highest-priority supporting fast path, else the generic sampler."""
    _check_ported(config)
    for entry in _REGISTRY:
        if entry.supports(wf, config):
            return entry.make(wf, config)
    move = mp.move_type(config)

    def generic(params, state, num_sweeps):
        return mp.run_sweeps(wf, params, state, num_sweeps, move)
    return generic


def check_state(wf: Wavefunction, config, state: mp.SamplerState) -> None:
    """Entry-time check of the chosen path's preconditions on `state` (the
    RBM kernels' Sz=0 sector).  Reads the chains back to the host: call it
    once per run, not per sweeps call."""
    if resolved_name(wf, config) == 'rbm_kernel':
        fast_rbm.check_sector(state.configs)


def _rbm_supports(wf, config) -> bool:
    if mp.move_type(config) != 'exchange':
        return False
    if getattr(config, 'total_sz2', 0):
        # The rank picks cover exactly n_sites//2 down spins.
        return False
    if not getattr(config, 'use_fast_sampler', True):
        return False
    return fast_rbm.supports(wf)


def _rbm_make(wf, config) -> SweepsFn:
    def sweeps(params, state, num_sweeps):
        return fast_rbm.run_sweeps(wf, params, state, num_sweeps)
    return sweeps


register_fast_path('rbm_kernel', priority=50, supports=_rbm_supports,
                   make=_rbm_make)
