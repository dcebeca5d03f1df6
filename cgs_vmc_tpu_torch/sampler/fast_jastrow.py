"""Incremental Metropolis sweeps for the Jastrow ansatz: exact O(n) delta
(port of cgs_vmc_tpu/sampler/fast_jastrow.py).

For log psi = 1/2 s^T S s + b^T s (models/jastrow.py) a pair exchange
(down site d: -1 -> +1, up site u: +1 -> -1, i.e. Delta_d = +2,
Delta_u = -2) changes the log-amplitude by the exact closed form

    delta = Delta^T S s + 1/2 Delta^T S Delta + b^T Delta
          = 2 S[d]·s - 2 S[u]·s + 2 S_dd + 2 S_uu - 4 S_du
          + 2 b_d - 2 b_u

— two row gathers and a dot per chain, O(n) against the generic sampler's
O(n²) quadratic form per proposal.  The proposal is the generic sampler's
own (metropolis.propose_exchange_sites: the same draws from the state's
generator in the same order), so with one seed the two samplers walk the
same chains up to float32 ties; only the amplitude arithmetic differs.
The cached log_amp is re-derived from one exact forward at the end of
every call, so incremental float32 drift cannot build up across calls.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models.base import Params
from cgs_vmc_tpu_torch.models.jastrow import JastrowWavefunction
from cgs_vmc_tpu_torch.sampler.metropolis import (
    SamplerState, propose_exchange_sites)


def supports(wf) -> bool:
    """True for a plain (unsymmetrized, log-output) Jastrow ansatz."""
    return (isinstance(wf, JastrowWavefunction)
            and wf.output_activation == 'exp')


def exchange_delta(sym: torch.Tensor, b: torch.Tensor, configs: torch.Tensor,
                   down: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """log psi(exchanged) - log psi(configs), [chains], for raising the
    down site and lowering the up site of each chain."""
    rows_d = sym[down]                          # [chains, n] = S[d, :]
    rows_u = sym[up]                            # [chains, n] = S[u, :]
    chains = torch.arange(configs.shape[0], device=configs.device)
    return (2.0 * torch.sum(rows_d * configs, dim=-1)
            - 2.0 * torch.sum(rows_u * configs, dim=-1)
            + 2.0 * rows_d[chains, down]        # S_dd
            + 2.0 * rows_u[chains, up]          # S_uu
            - 4.0 * rows_d[chains, up]          # S_du
            + 2.0 * b[down] - 2.0 * b[up])


def _step(sym: torch.Tensor, b: torch.Tensor, state: SamplerState
          ) -> SamplerState:
    """One exchange move per chain with the incremental delta."""
    configs = state.configs
    down, up, accept_u = propose_exchange_sites(state.generator, configs)
    delta = exchange_delta(sym, b, configs, down, up)
    accept = 2.0 * delta > torch.log(accept_u)  # |psi'|/|psi| > sqrt(u)
    proposed = configs.clone()          # see metropolis._propose_exchange
    proposed.scatter_(1, down[:, None], 1.0)
    proposed.scatter_(1, up[:, None], -1.0)
    return SamplerState(
        configs=torch.where(accept[:, None], proposed, configs),
        log_amp=torch.where(accept, state.log_amp + delta, state.log_amp),
        sign=state.sign,                         # Jastrow is positive
        generator=state.generator,
        num_accepted=state.num_accepted + accept.to(torch.float32),
        num_proposed=state.num_proposed + 1.0,
    )


@torch.no_grad()
def run_sweeps(wf, params: Params, state: SamplerState,
               num_sweeps: int) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on Jastrow ansatzes."""
    if not supports(wf):
        raise ValueError('fast_jastrow requires a plain JastrowWavefunction '
                         "with output_activation='exp'")
    if num_sweeps <= 0:
        return state
    sym = JastrowWavefunction.symmetric_pair(params)
    b = params['onsite']['b']
    for _ in range(num_sweeps * state.configs.shape[-1]):
        state = _step(sym, b, state)
    # One full forward per call (not per step) pins the cached log_amp to
    # the forward pass.
    amp = wf.apply(params, state.configs)
    return state._replace(log_amp=amp.log, sign=amp.sign)
