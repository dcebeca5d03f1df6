"""Incremental determinant sampler: Sherman–Morrison exchange moves for
the projected-BDG pairing ansatz (port of
cgs_vmc_tpu/sampler/fast_pbdg.py).

The generic sampler pays a full batched `slogdet` of the [B, n/2, n/2]
pairing submatrix per proposal (an O(h³) LU per chain per move).  An
exchange move replaces one row and one column of the submatrix, so with
the inverse cached the amplitude ratio is two rank-1 determinant-lemma
evaluations and the cache update two rank-1 Sherman–Morrison corrections,
O(h²) per move.

Bookkeeping: row slot r of the cached matrix M holds pairing[up_sites[r], ·]
and column slot c holds pairing[·, down_sites[c]] in arbitrary (insertion)
order — |det| is permutation-invariant, and Metropolis only needs |ratio|,
so no sorted order (and no permutation sign) is kept.  The exact signed
amplitude is recomputed once at the end of the call with the ansatz's full
`apply` (sorted gathers + slogdet), which also removes the accumulated
float32 drift.  The inverse cache is rebuilt from scratch once per sweep,
bounding both rounding drift and the reach of a near-singular intermediate
update.

Move semantics are the generic sampler's: one uniformly random up spin
exchanged with one uniformly random down spin per chain per step, accepted
with |ψ'/ψ|² > u.  The slot picks and uniforms of a whole call are drawn up
front from the state's generator as [sweeps, steps, chains] arrays.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models.base import Params
from cgs_vmc_tpu_torch.models.determinant import ProjectedBDG, up_down_sites
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState

# |ratio| at or below this counts as a numerically singular update.
_SINGULAR = 1e-30


def supports(wf) -> bool:
    """True when `wf` admits the incremental determinant fast path."""
    return isinstance(wf, ProjectedBDG)


def _build_cache(pairing: torch.Tensor, configs: torch.Tensor):
    """(up_sites, down_sites, inv) for the current configs.

    M[b, r, c] = pairing[up_sites[b, r], down_sites[b, c]]; inv = M^{-1}.
    """
    up_sites, down_sites = up_down_sites(configs)
    rows = pairing[up_sites]                                   # [B, h, n]
    m = torch.gather(rows, 2, down_sites[:, None, :].expand(
        -1, up_sites.shape[1], -1))
    return up_sites, down_sites, torch.linalg.inv(m)


def _guarded(ratio: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(ratio) > _SINGULAR, ratio,
                       torch.ones_like(ratio))


@torch.no_grad()
def run_sweeps(wf, params: Params, state: SamplerState, num_sweeps: int
               ) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on ProjectedBDG."""
    if not supports(wf):
        raise ValueError('fast_pbdg sampler requires a ProjectedBDG ansatz')
    if num_sweeps <= 0:
        return state
    configs = state.configs
    n_chains, n_sites = configs.shape
    half = n_sites // 2
    device = configs.device
    pairing = params['pairing']                                # [n, n]
    generator = state.generator

    shape = (num_sweeps, n_sites, n_chains)
    r_all = torch.randint(0, half, shape, generator=generator, device=device)
    c_all = torch.randint(0, half, shape, generator=generator, device=device)
    u_all = torch.rand(shape, generator=generator, device=device)

    slot_iota = torch.arange(half, device=device)[None, :]     # [1, h]
    site_iota = torch.arange(n_sites, device=device)[None, :]   # [1, n]
    chain_idx = torch.arange(n_chains, device=device)
    accepted = torch.zeros(n_chains, dtype=torch.float32, device=device)

    for sweep in range(num_sweeps):
        # Fresh cache each sweep: one batched inverse amortized over
        # n_sites O(h²) incremental moves.
        up_sites, down_sites, inv = _build_cache(pairing, configs)
        for step in range(n_sites):
            r, c, u = r_all[sweep, step], c_all[sweep, step], u_all[sweep,
                                                                    step]
            i = up_sites[chain_idx, r]                         # up site out
            j = down_sites[chain_idx, c]                       # down site in
            at_r = slot_iota == r[:, None]
            at_c = slot_iota == c[:, None]

            # Row replacement at slot r: new row u_r[k] = pairing[j, dn_k].
            new_row = torch.gather(pairing[j], 1, down_sites)
            inv_col_r = inv[chain_idx, :, r]                   # A⁻¹ e_r
            ratio1 = torch.sum(new_row * inv_col_r, dim=-1)    # uᵀA⁻¹e_r
            w = torch.einsum('bk,bkm->bm', new_row, inv)
            w = w - at_r.to(w.dtype)                           # uᵀA⁻¹ − e_rᵀ
            inv1 = inv - inv_col_r[:, :, None] * (
                w / _guarded(ratio1)[:, None])[:, None, :]

            # Column replacement at slot c: v[k] = pairing[up'_k, i] with
            # up' slot r already holding j.
            v = torch.gather(pairing[:, i].T, 1, up_sites)
            v = torch.where(at_r, pairing[j, i][:, None], v)
            inv1_v = torch.einsum('brc,bc->br', inv1, v)
            ratio2 = inv1_v[chain_idx, c]                      # (A₁⁻¹v)_c
            z = inv1_v - at_c.to(inv1_v.dtype)
            inv1_row_c = inv1[chain_idx, c, :]
            inv2 = inv1 - z[:, :, None] * (
                inv1_row_c / _guarded(ratio2)[:, None])[:, None, :]

            ratio = ratio1 * ratio2                            # det M'/det M
            # |ψ'/ψ|² > u, with a numerically singular intermediate taken
            # as a rejection (the per-sweep rebuild re-syncs the cache).  A
            # move whose row-replacement ratio underflows is rejected even
            # if the full rank-2 ratio would pass, an artifact of the two
            # sequential rank-1 updates; at float32 that set has no Born
            # weight to speak of (the Born-distribution test bounds it).
            acc = ((ratio * ratio > u) & torch.isfinite(ratio)
                   & (torch.abs(ratio1) > _SINGULAR))

            inv = torch.where(acc[:, None, None], inv2, inv)
            up_sites = torch.where(acc[:, None] & at_r, j[:, None], up_sites)
            down_sites = torch.where(acc[:, None] & at_c, i[:, None],
                                     down_sites)
            accf = acc.to(torch.float32)
            flip = (2.0 * (site_iota == j[:, None])
                    - 2.0 * (site_iota == i[:, None])).to(configs.dtype)
            configs = configs + accf[:, None] * flip
            accepted = accepted + accf

    # Exact signed amplitudes from the ansatz's own forward (which also
    # clears the incremental drift before any estimator reads the cache).
    amp = wf.apply(params, configs)
    return SamplerState(
        configs=configs, log_amp=amp.log, sign=amp.sign,
        generator=generator,
        num_accepted=state.num_accepted + accepted,
        num_proposed=state.num_proposed + float(num_sweeps * n_sites))
