"""Spin Jastrow pair-product ansatz (port of cgs_vmc_tpu/models/jastrow.py):

    log psi(s) = 1/2 s^T S s + b^T s,     S = (W + W^T)/2

with a trainable pair matrix W [n, n] and one-body field b [n]; sign is +1
(signful states come through the wavefunction algebra or the complex-phase
wrapper).  A pair exchange changes log psi by an O(n) expression in two
rows of S, which sampler/fast_jastrow.py uses; as a product factor
(``wavefunction_type='prod'`` with any network) it is the standard
Jastrow x network construction.
"""

from __future__ import annotations

import math

import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops import logamp
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


@register('jastrow')
class JastrowWavefunction(Wavefunction):
    """Two-body spin Jastrow factor with a one-body field."""

    def __init__(self, num_sites: int, output_activation: str = 'exp',
                 name: str = 'jastrow'):
        self.name = name
        self.num_sites = num_sites
        self.output_activation = output_activation

    def init(self, generator: torch.Generator) -> Params:
        n = self.num_sites
        # Small init keeps the initial log psi nearly flat, as the
        # linear_init(scale=0.1) heads of the other ansatzes do.
        scale = 0.1 / math.sqrt(float(n))
        device = generator.device
        return {
            'pair': {'w': scale * torch.randn(
                (n, n), generator=generator, device=device)},
            'onsite': {'b': 0.1 * scale * torch.randn(
                (n,), generator=generator, device=device)},
        }

    @staticmethod
    def symmetric_pair(params: Params) -> torch.Tensor:
        """S = (W + W^T)/2, the matrix log psi actually depends on."""
        w = params['pair']['w']
        return 0.5 * (w + w.T)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        s = configs.to(torch.float32)
        sym = self.symmetric_pair(params)
        quad = 0.5 * torch.einsum('bi,ij,bj->b', s, sym, s)
        pre = quad + s @ params['onsite']['b']
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'JastrowWavefunction':
        kwargs = dict(num_sites=config.num_sites,
                      output_activation=config.output_activation)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
