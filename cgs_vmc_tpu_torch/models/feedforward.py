"""Fully-connected and RBM wavefunction ansatzes (port of
cgs_vmc_tpu/models/feedforward.py).

FC: num_layers × (Linear + nonlinearity) → Linear(1); with output activation
'exp' the final scalar is logψ.  RBM: logψ = Linear_1(configs) +
Σ_h log cosh(Linear_h(features(configs))), sign +1.  With num_layers = 0 (no
feature MLP) the RBM is the classic one that the fused sweep kernels
sample; otherwise the generic sampler runs.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models import nn
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops import logamp
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


@register('fully_connected')
class FullyConnectedNetwork(Wavefunction):
    """MLP ansatz.  output_activation 'exp': logψ = the final scalar, sign
    +1; another activation f: ψ = f(final scalar), carried as (sign,
    log|.|)."""

    def __init__(self, num_sites: int, num_layers: int, layer_size: int,
                 nonlinearity: str = 'relu', output_activation: str = 'exp',
                 name: str = 'fully_connected_network'):
        self.name = name
        self.num_sites = num_sites
        self.num_layers = num_layers
        self.layer_size = layer_size
        self.nonlinearity = nonlinearity
        self.output_activation = output_activation

    def init(self, generator: torch.Generator) -> Params:
        params = {}
        in_dim = self.num_sites
        for i in range(self.num_layers):
            params[f'dense_{i}'] = nn.linear_init(generator, in_dim,
                                                  self.layer_size)
            in_dim = self.layer_size
        # Small head init keeps the initial logψ nearly flat.
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        params['out'] = nn.linear_init(generator, in_dim, 1,
                                       scale=head_scale)
        return params

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs
        for i in range(self.num_layers):
            h = act(nn.linear_apply(params[f'dense_{i}'], h))
        pre = nn.linear_apply(params['out'], h).squeeze(-1)
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'FullyConnectedNetwork':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_fc_layers,
            layer_size=config.fc_layer_size,
            nonlinearity=config.nonlinearity,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('rbm')
class RestrictedBoltzmannNetwork(Wavefunction):
    """Extended RBM: MLP feature stack -> log cosh hidden sum + on-site bias."""

    def __init__(self, num_sites: int, num_layers: int, layer_size: int,
                 nonlinearity: str = 'relu',
                 name: str = 'restricted_boltzmann_network'):
        self.name = name
        self.num_sites = num_sites
        self.num_layers = num_layers
        self.layer_size = layer_size
        self.nonlinearity = nonlinearity

    def init(self, generator: torch.Generator) -> Params:
        params = {}
        in_dim = self.num_sites
        for i in range(self.num_layers):
            params[f'dense_{i}'] = nn.linear_init(generator, in_dim,
                                                  self.layer_size)
            in_dim = self.layer_size
        # Small head init keeps the initial logψ nearly flat.
        params['hidden'] = nn.linear_init(generator, in_dim, self.layer_size,
                                          scale=0.1)
        params['onsite'] = nn.linear_init(generator, self.num_sites, 1,
                                          scale=0.1)
        return params

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs
        for i in range(self.num_layers):
            h = act(nn.linear_apply(params[f'dense_{i}'], h))
        hidden = nn.log_cosh(nn.linear_apply(params['hidden'], h))
        onsite = nn.linear_apply(params['onsite'], configs).squeeze(-1)
        log_psi = onsite + torch.sum(hidden, dim=-1)
        return LogAmp(torch.ones_like(log_psi), log_psi)

    @classmethod
    def from_config(cls, config, name: str = ''
                    ) -> 'RestrictedBoltzmannNetwork':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_fc_layers,
            layer_size=config.fc_layer_size,
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
