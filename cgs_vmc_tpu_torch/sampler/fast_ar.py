"""Exact-draw 'sweeps' adapter for autoregressive ansatzes (port of
cgs_vmc_tpu/sampler/fast_ar.py).

Replaces Metropolis sweeps with fresh ancestral samples: every call draws
one i.i.d. configuration per chain directly from |psi|^2
(models/autoregressive.py), so `num_sweeps` is irrelevant — there is no
chain to decorrelate — and the equilibration and decorrelation sweeps of
the epoch loops become exact sampling.  The acceptance counters advance by
one accepted "move" a call, so the acceptance-rate metric reads 1.0, the
exact sampler's signature.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_tpu_torch.models.base import Params
from cgs_vmc_tpu_torch.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState


def _ar_part(wf):
    """(ar_model, params_subtree_fn) when `wf` admits exact draws.

    Two shapes qualify: a bare AutoregressiveSpinModel, and a
    ComplexPhaseWavefunction whose modulus is autoregressive — since
    |psi|^2 = exp(2*Re log) = exp(2*log_modulus), ancestral draws from the
    modulus sample the full complex state exactly (the phase network never
    enters the sampler)."""
    if isinstance(wf, AutoregressiveSpinModel):
        return wf, lambda p: p
    if (isinstance(wf, ComplexPhaseWavefunction)
            and isinstance(wf._modulus, AutoregressiveSpinModel)):
        return wf._modulus, lambda p: p['modulus']
    return None, None


def supports(wf) -> bool:
    return _ar_part(wf)[0] is not None


@torch.no_grad()
def run_sweeps(wf, params: Params, state: SamplerState,
               num_sweeps: int) -> SamplerState:
    """One exact |psi|^2 draw per chain (num_sweeps ignored — i.i.d.).

    There is no ``num_sweeps <= 0`` shortcut: a fresh draw is always
    correct, and the epoch loops call sweeps between batch collections, so
    returning the state unchanged there would duplicate batches when the
    sweep counts (irrelevant here) are set to zero."""
    ar, sub = _ar_part(wf)
    if ar is None:
        raise ValueError('fast_ar requires an AutoregressiveSpinModel '
                         '(bare or as the modulus of a complex-phase '
                         'wavefunction)')
    configs = ar.sample(sub(params), state.generator, state.configs.shape[0])
    amp = wf.apply(params, configs)
    return state._replace(
        configs=configs, log_amp=amp.log, sign=amp.sign,
        num_accepted=state.num_accepted + 1.0,
        num_proposed=state.num_proposed + 1.0)
