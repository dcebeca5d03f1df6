"""Sz-conserving Metropolis exchange sampler (port of
cgs_vmc_tpu/sampler/metropolis.py): the generic sampler, and the
statistical oracle for the fused RBM kernels.

Move semantics are the JAX package's: pick one random down and one random
up spin per chain by the noise-weighted argmin/argmax trick, exchange them,
accept when 2Δlog|ψ| > log u.  Randomness comes from one torch.Generator on
the chains' device, held in the sampler state and checkpointed with it.
It takes the place of the JAX package's per-chain keys, so
`advance_chain_keys` (which kept those key streams from aliasing) has no
counterpart here: one generator stream never re-enters itself.  The
generator advances in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cgs_vmc_tpu_torch import basis as basis_lib
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction
from cgs_vmc_tpu_torch.utils.device import resolve_device


class SamplerState(NamedTuple):
    """Per-chain Markov state (tensors lead with the chain axis)."""
    configs: torch.Tensor        # [chains, n_sites] ±1 float32
    log_amp: torch.Tensor        # [chains] log|psi| (+ i·phase: complex64)
    sign: torch.Tensor           # [chains] sign(psi(configs))
    generator: torch.Generator   # on the chains' device
    num_accepted: torch.Tensor   # [chains] float32 accepted-move counter
    num_proposed: torch.Tensor   # [chains] float32 proposal counter


def init_sampler(generator: torch.Generator, wf: Wavefunction,
                 params: Params, n_sites: int, n_chains: int,
                 full_space: bool = False,
                 n_down: Optional[int] = None) -> SamplerState:
    """Random chains on the generator's device plus their amplitudes.

    full_space: uniform over the full 2^N space (for the 'flip' move)
    instead of the fixed-Sz sector n_down (default Sz=0)."""
    if full_space:
        configs = basis_lib.random_spin_configurations(generator, n_sites,
                                                       n_chains)
    else:
        configs = basis_lib.random_configurations(generator, n_sites,
                                                  n_chains, n_down)
    with torch.no_grad():
        amp = wf.apply(params, configs)
    zeros = torch.zeros(n_chains, dtype=torch.float32, device=configs.device)
    return SamplerState(configs=configs, log_amp=amp.log, sign=amp.sign,
                        generator=generator, num_accepted=zeros,
                        num_proposed=zeros.clone())


def propose_exchange_sites(generator: torch.Generator,
                           configs: torch.Tensor):
    """The sites of one exchange proposal per chain and its acceptance
    uniform: (down_site, up_site, accept_uniform), a uniformly random -1
    spin and a uniformly random +1 spin.  Draws the site noise, then the
    uniforms; every sampler that proposes this move draws through here, so
    that one seed gives them the same proposals."""
    n_chains, n_sites = configs.shape
    site_u = torch.rand((n_chains, n_sites), generator=generator,
                        device=configs.device)
    accept_u = torch.rand(n_chains, generator=generator,
                          device=configs.device)
    swap_choice = configs * site_u
    down_site = torch.argmin(swap_choice, dim=-1)  # a random -1 spin
    up_site = torch.argmax(swap_choice, dim=-1)    # a random +1 spin
    return down_site, up_site, accept_u


def _propose_exchange(generator: torch.Generator, configs: torch.Tensor):
    """One exchange proposal per chain: (proposed, accept_uniform)."""
    down_site, up_site, accept_u = propose_exchange_sites(generator, configs)
    rows = torch.arange(configs.shape[0], device=configs.device)
    proposed = configs.clone()
    proposed[rows, down_site] = 1.0
    proposed[rows, up_site] = -1.0
    return proposed, accept_u


def _propose_flip(generator: torch.Generator, configs: torch.Tensor):
    """One single-spin-flip proposal per chain (non-Sz-conserving)."""
    n_chains, n_sites = configs.shape
    sites = torch.randint(0, n_sites, (n_chains,), generator=generator,
                          device=configs.device)
    accept_u = torch.rand(n_chains, generator=generator,
                          device=configs.device)
    rows = torch.arange(n_chains, device=configs.device)
    proposed = configs.clone()
    proposed[rows, sites] *= -1.0
    return proposed, accept_u


PROPOSALS = {
    'exchange': _propose_exchange,
    'flip': _propose_flip,
}


@torch.no_grad()
def mc_step(wf: Wavefunction, params: Params, state: SamplerState,
            move: str = 'exchange') -> SamplerState:
    """One Metropolis move on every chain: accept when
    2*(log|psi'| - log|psi|) > log(u), the |psi|²-sampling rule."""
    proposed, accept_u = PROPOSALS[move](state.generator, state.configs)
    amp_new = wf.apply(params, proposed)
    delta_log = (amp_new.log - state.log_amp).real
    accept = 2.0 * delta_log > torch.log(accept_u)
    return SamplerState(
        configs=torch.where(accept[:, None], proposed, state.configs),
        log_amp=torch.where(accept, amp_new.log, state.log_amp),
        sign=torch.where(accept, amp_new.sign, state.sign),
        generator=state.generator,
        num_accepted=state.num_accepted + accept.to(torch.float32),
        num_proposed=state.num_proposed + 1.0,
    )


def run_steps(wf: Wavefunction, params: Params, state: SamplerState,
              num_steps: int, move: str = 'exchange') -> SamplerState:
    for _ in range(num_steps):
        state = mc_step(wf, params, state, move)
    return state


def run_sweeps(wf: Wavefunction, params: Params, state: SamplerState,
               num_sweeps: int, move: str = 'exchange') -> SamplerState:
    """A sweep = n_sites proposals per chain."""
    n_sites = state.configs.shape[-1]
    return run_steps(wf, params, state, num_sweeps * n_sites, move)


def move_type(config) -> str:
    """The configured Metropolis move ('exchange' | 'flip')."""
    return getattr(config, 'mc_move_type', 'exchange') or 'exchange'


def init_sampler_for(seed: int, wf: Wavefunction, params: Params, config,
                     device, n_chains: Optional[int] = None
                     ) -> SamplerState:
    """Config-aware init on `device` with a generator seeded by `seed`:
    full-space chains when the move is 'flip', the total_sz2 sector
    otherwise."""
    device = resolve_device(device)
    n_replicas = getattr(config, 'pt_replicas', 0)
    if n_replicas and n_replicas >= 2:
        raise NotImplementedError(
            'parallel tempering (pt_replicas >= 2) is not ported yet; '
            'ROADMAP.md lists sampler/tempering.py in the queue')
    full_space = move_type(config) == 'flip'
    total_sz2 = getattr(config, 'total_sz2', 0)
    if full_space and total_sz2:
        raise ValueError(
            "total_sz2 != 0 requires the Sz-conserving 'exchange' move: "
            "single-spin flips do not stay in a fixed-Sz sector")
    n_down = basis_lib.n_down_for(config.num_sites, total_sz2)
    generator = torch.Generator(device=device).manual_seed(seed)
    return init_sampler(generator, wf, params, config.num_sites,
                        n_chains or config.batch_size,
                        full_space=full_space, n_down=n_down)


@torch.no_grad()
def refresh_amplitudes(wf: Wavefunction, params: Params,
                       state: SamplerState) -> SamplerState:
    """Recomputes the cached (sign, log) for the current configs; needed
    whenever params changed since the cache was written."""
    amp = wf.apply(params, state.configs)
    return state._replace(log_amp=amp.log, sign=amp.sign)


def reset_stats(state: SamplerState) -> SamplerState:
    return state._replace(num_accepted=torch.zeros_like(state.num_accepted),
                          num_proposed=torch.zeros_like(state.num_proposed))


def acceptance_rate(state: SamplerState) -> torch.Tensor:
    """Fraction of accepted moves since the last reset, [] float32."""
    total = torch.sum(state.num_proposed)
    return torch.sum(state.num_accepted) / torch.clamp(total, min=1.0)
