"""Incremental MPS sampler: environment-cached adjacent-exchange sweeps
(port of cgs_vmc_tpu/sampler/fast_mps.py).

The generic sampler pays a full O(N·D²) chain contraction per proposal;
for an MPS the standard fast move set is a sequential sweep of adjacent
exchanges with cached environments (the sampling analog of a DMRG sweep):

 * one right-to-left pass per sweep caches every suffix environment
   S_k = M_k(s_k)·…·last(s_{N-1})  (normalized per step; normalizations
   cancel in ratios),
 * a left-to-right march proposes exchanging (k, k+1) at each bond,
   evaluating both the current and the swapped local amplitude as
   L · M_k · M_{k+1} · S_{k+2} — O(D²) per proposal — and extends the
   prefix L with the (possibly updated) site matrix.

Per sweep: O(N·D²) in all instead of the generic path's O(N²·D²).

Move set: adjacent exchanges in a fixed order conserve Sz and are ergodic
in the sector (adjacent transpositions generate S_N), and each bond update
is a valid Metropolis kernel for |ψ|² (symmetric proposal, acceptance
|ψ'/ψ|² > u), so the composition preserves the Born distribution.  The
mixing differs from the global down×up exchange (local diffusion against
long-range swaps), so this sampler is opt-in through
``config.mps_incremental_sweeps``.  A call's uniforms are drawn up front
from the state's generator as one [sweeps, N-1, chains] array.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models.base import Params
from cgs_vmc_tpu_torch.models.mps import MatrixProductState, spin_index
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState


def supports(wf) -> bool:
    return isinstance(wf, MatrixProductState)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """Max-abs row normalization (the scale cancels in same-bond ratios)."""
    norm = torch.amax(torch.abs(v), dim=-1, keepdim=True)
    return v / torch.where(norm > 0, norm, torch.ones_like(norm))


def _suffix_envs(params: Params, configs: torch.Tensor) -> list:
    """[S_2, …, S_{N-1}], each [B, D]: S_{N-1} = last(s_{N-1}) and
    S_k = mid_{k-1}(s_k) · S_{k+1}, normalized (site k's tensor is
    ``mid[k-1]``)."""
    n = configs.shape[1]
    spin = spin_index(configs)                            # [B, N]
    env = _normalize(params['last'][spin[:, -1]])         # [B, D]
    envs = [env]
    for k in range(n - 2, 1, -1):
        mats = params['mid'][k - 1][spin[:, k]]           # [B, D, D]
        env = _normalize(torch.einsum('bde,be->bd', mats, env))
        envs.append(env)
    return envs[::-1]


@torch.no_grad()
def run_sweeps(wf, params: Params, state: SamplerState, num_sweeps: int
               ) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on MPS ansatzes."""
    if not supports(wf):
        raise ValueError('fast_mps sampler requires a MatrixProductState')
    if num_sweeps <= 0:
        return state
    configs = state.configs
    n_chains, n_sites = configs.shape
    device = configs.device
    first, mid, last = params['first'], params['mid'], params['last']
    u_all = torch.rand((num_sweeps, n_sites - 1, n_chains),
                       generator=state.generator, device=device)
    accepted = torch.zeros(n_chains, dtype=torch.float32, device=device)
    proposed = torch.zeros(n_chains, dtype=torch.float32, device=device)

    def site_k_apply(k, left, spin):
        """Site k's tensor applied to the running prefix (site 0 is the
        boundary vector)."""
        if k == 0:
            return first[spin]
        return torch.einsum('bd,bde->be', left, mid[k - 1][spin])

    for sweep in range(num_sweeps):
        envs = _suffix_envs(params, configs)               # S_2 … S_{N-1}
        configs = configs.clone()
        left = None                                        # prefix before k
        for k in range(n_sites - 1):
            s_k, s_k1 = configs[:, k], configs[:, k + 1]
            idx_k, idx_k1 = spin_index(s_k), spin_index(s_k1)

            def through(first_spin, second_spin):
                v = site_k_apply(k, left, first_spin)      # after site k
                if k + 1 == n_sites - 1:
                    # The last bond contracts `last` elementwise; there is
                    # no suffix beyond it.
                    return torch.sum(v * last[second_spin], dim=-1)
                v2 = torch.einsum('bd,bde->be', v, mid[k][second_spin])
                return torch.sum(v2 * envs[k], dim=-1)     # with S_{k+2}

            cur = through(idx_k, idx_k1)
            new = through(idx_k1, idx_k)
            active = idx_k != idx_k1
            accept = active & (new * new > u_all[sweep, k] * cur * cur)
            new_k = torch.where(accept, s_k1, s_k)
            new_k1 = torch.where(accept, s_k, s_k1)
            configs[:, k], configs[:, k + 1] = new_k, new_k1

            # Extend the prefix through site k with its final spin.
            left = _normalize(site_k_apply(k, left,
                                           spin_index(configs[:, k])))
            # Only active proposals (antiparallel bonds) count: a parallel
            # bond is a no-op here, while the down×up proposals of the
            # other samplers are always active; counting the no-ops would
            # make acceptance rates incomparable across samplers.
            accepted = accepted + accept.to(torch.float32)
            proposed = proposed + active.to(torch.float32)

    amp = wf.apply(params, configs)
    return SamplerState(
        configs=configs, log_amp=amp.log, sign=amp.sign,
        generator=state.generator,
        num_accepted=state.num_accepted + accepted,
        num_proposed=state.num_proposed + proposed)
