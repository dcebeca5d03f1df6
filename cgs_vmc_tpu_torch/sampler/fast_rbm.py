"""Fused sweeps for pure-RBM wavefunctions (port of
cgs_vmc_tpu/sampler/fast_rbm.py): bridges SamplerState and the kernels of
sampler/kernels.py.  Applies to RestrictedBoltzmannNetwork with
num_layers == 0, the regime where the O(hidden) incremental update beats the
generic full-forward sampler by ~n_sites×.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models.base import Params
from cgs_vmc_tpu_torch.models.feedforward import RestrictedBoltzmannNetwork
from cgs_vmc_tpu_torch.sampler import kernels
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState


def supports(wf) -> bool:
    """True when `wf` admits the fused kernels (pure RBM, no feature MLP)."""
    return (isinstance(wf, RestrictedBoltzmannNetwork)
            and wf.num_layers == 0)


def _unpack(params: Params):
    w = params['hidden']['w'].detach()           # [n_sites, hidden]
    b = params['hidden']['b'].detach()           # [hidden]
    a = params['onsite']['w'][:, 0].detach()     # [n_sites]
    return w, b, a.contiguous()


def check_sector(configs: torch.Tensor) -> None:
    """Raises unless every chain is in the Sz=0 sector.

    The rank picks are uniform over the down/up sites only in the
    half-filled sector, so off-sector chains would silently bias detailed
    balance.  This reads the chains back to the host: call it once at the
    entry of a run (train, evaluate_operator), not per sweeps call — the
    JAX package's check, too, only ever ran on concrete arrays outside the
    compiled epoch."""
    sz = torch.sum(configs, dim=1)
    if bool((sz != 0).any()):
        raise ValueError(
            'fast_rbm sampler requires Sz=0 chains (half up, half down); '
            f'got per-chain Sz {sorted(set(sz.tolist()))}')


def run_sweeps(wf, params: Params, state: SamplerState, num_sweeps: int,
               use_kernel_prng: bool = True) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on pure-RBM ansatzes.

    One sweep = n_sites independent per-chain exchange proposals.  The
    onsite head's scalar bias adds a configuration-independent constant to
    logψ and is folded into log_amp exactly.

    use_kernel_prng: K2, all draws made in the kernel from one seed drawn
    from the state's generator (the default, as on the TPU).  False runs
    K1, with ranks and log-uniforms drawn from the generator as tensors.
    """
    if not supports(wf):
        raise ValueError('fast_rbm sampler requires a pure RBM '
                         '(RestrictedBoltzmannNetwork with num_layers=0)')
    if num_sweeps <= 0:
        return state
    n_chains, n_sites = state.configs.shape
    if n_sites % 2:
        raise ValueError(
            f'fast_rbm sampler requires the half-filled Sz=0 sector; '
            f'n_sites={n_sites} is odd')
    w, b, a = _unpack(params)
    generator = state.generator
    device = state.configs.device
    n_steps = num_sweeps * n_sites
    if use_kernel_prng:
        # Drawn on the device: no host sync per call.
        seed = torch.randint(0, 2 ** 32, (1,), generator=generator,
                             device=device, dtype=torch.int64)
        out = kernels.rbm_sweeps_prng(w, b, a, state.configs, n_steps, seed)
    else:
        picks = kernels.sample_picks(generator, n_steps, n_sites, n_chains)
        log_u = torch.log(torch.rand((n_steps, n_chains),
                                     generator=generator, device=device))
        out = kernels.rbm_sweeps(w, b, a, state.configs, picks, log_u)
    onsite_bias = params['onsite']['b'][0].detach()
    return SamplerState(
        configs=out.configs,
        log_amp=out.log_amp + onsite_bias,
        sign=torch.ones_like(out.log_amp),
        generator=generator,
        num_accepted=state.num_accepted + out.num_accepted,
        num_proposed=state.num_proposed + float(n_steps),
    )
