"""Parallel tempering (replica exchange) over |psi|^(2*beta) ladders (port
of cgs_vmc_tpu/sampler/tempering.py).

For rugged |psi|² landscapes single-temperature chains mix slowly; parallel
tempering runs K replicas of every chain at exponents 1 = beta_0 > ... >
beta_{K-1} (sampling |psi|^(2*beta_k)) and proposes neighbour swaps after
every sweep, letting the flattened replicas ferry configurations across
probability barriers.

* Replicas ride the batch axis: one tempered Metropolis step evaluates all
  K replicas of all chains in a single forward pass over [chains*K,
  n_sites].
* Every chain carries its own K-replica ladder and every tensor of the
  state leads with the chain axis; swaps are chain-local (a [chains, K]
  permutation gather).
* The physical (beta=1) replica occupies the SamplerState-named fields, so
  every consumer (optimizers collecting ``sampler.configs``, acceptance
  statistics, evaluators) sees exactly the physical ensemble; the tempered
  replicas live in the ``aux_*`` fields.

One generator on the chains' device takes the place of the JAX package's
per-slot and per-chain keys.  Draw order within a sweep: n_sites
Metropolis steps, each drawing its proposal for all chains*K flattened
rows (replica index fastest) and then the acceptance uniforms, followed by
one ``torch.rand((chains, K-1))`` for the swap round.

Enable with ``config.pt_replicas = K`` (K >= 2); the ladder is geometric
down to ``config.pt_beta_min`` and the swap rounds alternate even/odd
neighbour pairings.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cgs_vmc_tpu_torch import basis as basis_lib
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction
from cgs_vmc_tpu_torch.sampler import metropolis


class PTSamplerState(NamedTuple):
    """Per-chain parallel-tempering state (all tensors chain-leading).

    The first six fields are the physical (beta=1) replica with
    SamplerState semantics; aux_* hold the R = K-1 tempered replicas of
    each chain.
    """
    configs: torch.Tensor        # [chains, n_sites] physical replica
    log_amp: torch.Tensor        # [chains]
    sign: torch.Tensor           # [chains]
    generator: torch.Generator   # on the chains' device; all draws
    num_accepted: torch.Tensor   # [chains] physical-move acceptance counter
    num_proposed: torch.Tensor   # [chains]
    aux_configs: torch.Tensor    # [chains, R, n_sites] tempered replicas
    aux_log: torch.Tensor        # [chains, R]
    aux_sign: torch.Tensor       # [chains, R]
    betas: torch.Tensor          # [chains, K] descending, betas[:, 0] = 1
    swap_accepted: torch.Tensor  # [chains, R] per neighbour pair
    swap_proposed: torch.Tensor  # [chains, R]


def geometric_ladder(n_replicas: int, beta_min: float) -> torch.Tensor:
    """[K] descending geometric exponents 1 ... beta_min (float32, CPU)."""
    if n_replicas < 2:
        raise ValueError('pt_replicas must be >= 2 for tempering')
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f'pt_beta_min must be in (0, 1), got {beta_min}')
    steps = torch.arange(n_replicas, dtype=torch.float32) / (n_replicas - 1)
    return torch.tensor(beta_min, dtype=torch.float32) ** steps


def init_pt_sampler(generator: torch.Generator, wf: Wavefunction,
                    params: Params, n_sites: int, n_chains: int,
                    n_replicas: int, beta_min: float,
                    full_space: bool = False,
                    n_down: Optional[int] = None) -> PTSamplerState:
    """Random ladders on the generator's device plus their amplitudes."""
    betas = geometric_ladder(n_replicas, beta_min)
    total = n_chains * n_replicas
    if full_space:
        flat = basis_lib.random_spin_configurations(generator, n_sites, total)
    else:
        flat = basis_lib.random_configurations(generator, n_sites, total,
                                               n_down)
    with torch.no_grad():
        amp = wf.apply(params, flat)
    device = flat.device
    configs = flat.reshape(n_chains, n_replicas, n_sites)
    logs = amp.log.reshape(n_chains, n_replicas)
    signs = amp.sign.reshape(n_chains, n_replicas)
    r = n_replicas - 1
    return PTSamplerState(
        configs=configs[:, 0], log_amp=logs[:, 0], sign=signs[:, 0],
        generator=generator,
        num_accepted=torch.zeros(n_chains, device=device),
        num_proposed=torch.zeros(n_chains, device=device),
        aux_configs=configs[:, 1:], aux_log=logs[:, 1:],
        aux_sign=signs[:, 1:],
        betas=betas.to(device).expand(n_chains, n_replicas).contiguous(),
        swap_accepted=torch.zeros((n_chains, r), device=device),
        swap_proposed=torch.zeros((n_chains, r), device=device))


def _stacked(state: PTSamplerState):
    """Full-ladder views [chains, K, ...] (physical at index 0)."""
    configs = torch.cat([state.configs[:, None], state.aux_configs], dim=1)
    logs = torch.cat([state.log_amp[:, None], state.aux_log], dim=1)
    signs = torch.cat([state.sign[:, None], state.aux_sign], dim=1)
    return configs, logs, signs


def _unstacked(state: PTSamplerState, configs, logs, signs
               ) -> PTSamplerState:
    return state._replace(
        configs=configs[:, 0], log_amp=logs[:, 0], sign=signs[:, 0],
        aux_configs=configs[:, 1:], aux_log=logs[:, 1:],
        aux_sign=signs[:, 1:])


def _swap_round(state: PTSamplerState, parity: int,
                uniforms: torch.Tensor) -> PTSamplerState:
    """One neighbour-swap round at the given pairing parity (0 or 1) with
    the acceptance uniforms [chains, R] given.

    Pair i couples replicas (i, i+1); only pairs with i % 2 == parity
    propose this round, so proposed swaps are disjoint.  Acceptance is
    the standard replica-exchange rule for pi_k = |psi|^(2*beta_k):
      A = min(1, exp(2*(beta_i - beta_{i+1}) * (log|psi_{i+1}| - log|psi_i|)))
    Configurations and their cached amplitudes swap; the beta ladder
    stays put.
    """
    configs, logs, signs = _stacked(state)
    n_rep = logs.shape[1]
    r = n_rep - 1
    device = logs.device

    real_logs = logs.real                                     # [chains, K]
    d_beta = state.betas[:, :-1] - state.betas[:, 1:]         # [chains, R]
    d_log = real_logs[:, 1:] - real_logs[:, :-1]              # [chains, R]
    pair_on = (torch.arange(r, device=device) % 2) == parity  # [R]
    accept = pair_on[None, :] & (2.0 * d_beta * d_log > torch.log(uniforms))

    # Chain-local permutation: row k swaps with k+1 where pair k accepted.
    pad = torch.zeros_like(accept[:, :1])
    swap_next = torch.cat([accept, pad], dim=1).to(torch.int64)  # [chains, K]
    swap_prev = torch.cat([pad, accept], dim=1).to(torch.int64)
    perm = torch.arange(n_rep, device=device)[None, :] + swap_next - swap_prev

    state = _unstacked(
        state,
        torch.gather(configs, 1,
                     perm[:, :, None].expand(-1, -1, configs.shape[2])),
        torch.gather(logs, 1, perm), torch.gather(signs, 1, perm))
    return state._replace(
        swap_accepted=state.swap_accepted + accept.to(torch.float32),
        swap_proposed=state.swap_proposed + pair_on.to(torch.float32)[None, :])


@torch.no_grad()
def run_sweeps(wf: Wavefunction, params: Params, state: PTSamplerState,
               num_sweeps: int, move: str = 'exchange') -> PTSamplerState:
    """num_sweeps tempered sweeps, one swap round after each sweep.

    A sweep = n_sites tempered Metropolis proposals on every replica of
    every chain, executed as flattened [chains*K] SamplerState steps so
    each proposal is one forward pass over the whole ladder.
    """
    n_chains, n_sites = state.configs.shape
    n_rep = state.betas.shape[1]
    total = n_chains * n_rep
    beta_flat = state.betas.reshape(total)
    for i in range(num_sweeps):
        configs, logs, signs = _stacked(state)
        zeros = torch.zeros(total, device=configs.device)
        flat = metropolis.SamplerState(
            configs=configs.reshape(total, n_sites),
            log_amp=logs.reshape(total), sign=signs.reshape(total),
            generator=state.generator, num_accepted=zeros,
            num_proposed=zeros)
        flat = metropolis.run_steps(wf, params, flat, n_sites, move,
                                    beta=beta_flat)
        state = _unstacked(state,
                           flat.configs.reshape(n_chains, n_rep, n_sites),
                           flat.log_amp.reshape(n_chains, n_rep),
                           flat.sign.reshape(n_chains, n_rep))
        # Physical-move statistics only (replica 0), keeping the
        # SamplerState acceptance-rate semantics for consumers.
        state = state._replace(
            num_accepted=(state.num_accepted
                          + flat.num_accepted.reshape(n_chains, n_rep)[:, 0]),
            num_proposed=(state.num_proposed
                          + flat.num_proposed.reshape(n_chains, n_rep)[:, 0]))
        uniforms = torch.rand((n_chains, n_rep - 1),
                              generator=state.generator,
                              device=configs.device)
        state = _swap_round(state, i % 2, uniforms)
    return state


@torch.no_grad()
def refresh_amplitudes(wf: Wavefunction, params: Params,
                       state: PTSamplerState) -> PTSamplerState:
    """Recomputes the cached amplitudes of all replicas (one forward):
    stale aux amplitudes would corrupt both the tempered acceptance ratios
    and the swap decisions, so the ladder refreshes together."""
    configs, _, _ = _stacked(state)
    n_chains, n_rep, n_sites = configs.shape
    amp = wf.apply(params, configs.reshape(n_chains * n_rep, n_sites))
    return _unstacked(state, configs, amp.log.reshape(n_chains, n_rep),
                      amp.sign.reshape(n_chains, n_rep))


def reset_stats(state: PTSamplerState) -> PTSamplerState:
    return state._replace(
        num_accepted=torch.zeros_like(state.num_accepted),
        num_proposed=torch.zeros_like(state.num_proposed),
        swap_accepted=torch.zeros_like(state.swap_accepted),
        swap_proposed=torch.zeros_like(state.swap_proposed))


def swap_rate(state: PTSamplerState) -> torch.Tensor:
    """Mean accepted/proposed swap fraction per neighbour pair, [R]."""
    acc = torch.sum(state.swap_accepted, dim=0)
    prop = torch.sum(state.swap_proposed, dim=0)
    return acc / torch.clamp(prop, min=1.0)
