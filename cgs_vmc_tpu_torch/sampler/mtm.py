"""Multiple-try Metropolis (MTM) exchange sampler (port of
cgs_vmc_tpu/sampler/mtm.py).

Performance variant of the generic sampler (sampler/metropolis.py) for
expensive ansatzes: each step proposes K candidate exchange moves per chain
and evaluates all of them in one batched forward pass, then selects among
them with Born weights.  The generic sampler pays one forward (and its
launches) per single proposal; MTM batches the (2K−1) amplitude evaluations
of a step into two forward passes.

Algorithm (Liu, Liang & Wong 2000; symmetric proposal T, weights
w(y) = |ψ(y)|² = π(y)):

  1. draw candidates y_1..y_K ~ T(x → ·); pick y = y_j with probability
     π(y_j) / Σ_k π(y_k);
  2. draw reference points x*_1..x*_{K−1} ~ T(y → ·), set x*_K = x;
  3. accept y with probability min(1, Σ_k π(y_k) / Σ_k π(x*_k)).

This preserves detailed balance for |ψ|² exactly.  Moves are the
Sz-conserving exchanges of the generic sampler.

Draw order of a step, all from the state's one generator: the candidates'
site noise ``rand((chains, K, n_sites))``, the selection noise
``rand((chains, K))``, the reference points' site noise
``rand((chains, K−1, n_sites))`` (K > 1 only), the acceptance uniforms
``rand(chains)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState


def _propose_k(generator: torch.Generator, configs: torch.Tensor, k: int
               ) -> torch.Tensor:
    """K independent exchange proposals per chain, [chains, k, n_sites]:
    the noise-weighted argmin/argmax pick of the generic sampler, over a
    candidate axis."""
    n_chains, n_sites = configs.shape
    u = torch.rand((n_chains, k, n_sites), generator=generator,
                   device=configs.device)
    swap_choice = configs[:, None, :] * u
    down = torch.argmin(swap_choice, dim=-1, keepdim=True)  # random -1 sites
    up = torch.argmax(swap_choice, dim=-1, keepdim=True)    # random +1 sites
    candidates = configs[:, None, :].repeat(1, k, 1)
    candidates.scatter_(2, down, 1.0)
    candidates.scatter_(2, up, -1.0)
    return candidates


def _categorical(generator: torch.Generator, logits: torch.Tensor
                 ) -> torch.Tensor:
    """One index per row with probability softmax(logits), by the
    Gumbel-max trick: -inf logits are never picked while a finite one is
    there, and no row can give a NaN."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def mtm_step(wf: Wavefunction, params: Params, state: SamplerState,
             k: int) -> SamplerState:
    """One MTM step on every chain (2 batched forward passes)."""
    configs = state.configs
    n_chains, n_sites = configs.shape
    rows = torch.arange(n_chains, device=configs.device)
    generator = state.generator

    # Forward candidates.  Re log: |ψ|² weights; the phase of a complex
    # log never enters.
    candidates = _propose_k(generator, configs, k)
    amp_y = wf.apply(params, candidates.reshape(n_chains * k, n_sites))
    log_pi_y = 2.0 * amp_y.log.real.reshape(n_chains, k)
    select = _categorical(generator, log_pi_y)               # [chains]
    chosen = candidates[rows, select]                        # [chains, n]
    chosen_log = amp_y.log.reshape(n_chains, k)[rows, select]
    chosen_sign = amp_y.sign.reshape(n_chains, k)[rows, select]

    # Reference set from the chosen candidate, the current state last.
    log_pi_x = 2.0 * state.log_amp.real[:, None]
    if k > 1:
        refs = _propose_k(generator, chosen, k - 1)
        amp_x = wf.apply(params, refs.reshape(n_chains * (k - 1), n_sites))
        log_pi_x = torch.cat(
            [2.0 * amp_x.log.real.reshape(n_chains, k - 1), log_pi_x], dim=1)

    # Acceptance: min(1, Σπ(y) / Σπ(x*)).
    log_w_y = torch.logsumexp(log_pi_y, dim=1)
    log_w_x = torch.logsumexp(log_pi_x, dim=1)
    u = torch.rand(n_chains, generator=generator, device=configs.device)
    accept = (log_w_y - log_w_x) > torch.log(u)

    return state._replace(
        configs=torch.where(accept[:, None], chosen, configs),
        log_amp=torch.where(accept, chosen_log, state.log_amp),
        sign=torch.where(accept, chosen_sign, state.sign),
        num_accepted=state.num_accepted + accept.to(torch.float32),
        num_proposed=state.num_proposed + 1.0)


def run_sweeps(wf: Wavefunction, params: Params, state: SamplerState,
               num_sweeps: int, k: int,
               steps_per_sweep: Optional[int] = None) -> SamplerState:
    """MTM sweeps.  A sweep is n_sites // k MTM steps by default: each step
    examines k candidate moves, so a sweep's proposal work matches the
    single-try sampler's n_sites proposals."""
    n_sites = state.configs.shape[-1]
    if steps_per_sweep is None:
        steps_per_sweep = max(n_sites // max(k, 1), 1)
    for _ in range(num_sweeps * steps_per_sweep):
        state = mtm_step(wf, params, state, k)
    return state
