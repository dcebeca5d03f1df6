"""Determinant-based ansatzes: projected BDG pairing and neural-net
backflow (port of cgs_vmc_tpu/models/determinant.py).

The (up-row, down-column) pairing submatrix is built with sorted gathers
of static shape, and both ansatzes take ``torch.linalg.slogdet`` of it, so
the amplitude is natively (sign, log).
"""

from __future__ import annotations

import math

import torch

from cgs_vmc_tpu_torch.models import nn
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops.logamp import ACTIVATIONS, LogAmp


def up_down_sites(configs: torch.Tensor):
    """(up_sites, down_sites), each [batch, n/2] in ascending site order:
    the stable argsort puts the up (+1) sites first in ascending order,
    and likewise the down sites.  The row and column order of the pairing
    submatrix, and so the determinant's sign, rest on that stability."""
    half = configs.shape[-1] // 2
    up = torch.argsort(-configs, dim=-1, stable=True)[:, :half]
    down = torch.argsort(configs, dim=-1, stable=True)[:, :half]
    return up, down


def pairing_submatrix(pairing: torch.Tensor, configs: torch.Tensor
                      ) -> torch.Tensor:
    """Selects rows at up-spin sites and columns at down-spin sites.

    pairing: [batch, n, n] (or broadcastable), configs: [batch, n] ±1 with
    exactly n/2 up spins.  Returns [batch, n/2, n/2], rows and columns in
    ascending site index.
    """
    n = configs.shape[-1]
    up_idx, down_idx = up_down_sites(configs)
    pairing = pairing.expand(configs.shape[0], n, n)
    rows = torch.gather(pairing, 1, up_idx[:, :, None].expand(-1, -1, n))
    half = up_idx.shape[1]
    return torch.gather(rows, 2, down_idx[:, None, :].expand(-1, half, -1))


def _slogdet(sub: torch.Tensor) -> LogAmp:
    sign, logdet = torch.linalg.slogdet(sub)
    return LogAmp(sign, logdet)


@register('pbdg')
class ProjectedBDG(Wavefunction):
    """Pairing wavefunction: trainable [n, n] pairing matrix, amplitude =
    det of the (up, down) submatrix."""

    def __init__(self, num_sites: int, name: str = 'projected_bdg'):
        if num_sites % 2:
            raise ValueError('ProjectedBDG requires an even number of sites.')
        self.name = name
        self.num_sites = num_sites

    def init(self, generator: torch.Generator) -> Params:
        n = self.num_sites
        limit = math.sqrt(6.0 / (n + n))           # Glorot-uniform
        u = torch.rand((n, n), generator=generator, device=generator.device)
        return {'pairing': (2.0 * u - 1.0) * limit}

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return _slogdet(pairing_submatrix(params['pairing'][None], configs))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'ProjectedBDG':
        kwargs = dict(num_sites=config.num_sites)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('fully_connected_nnb')
class FullyConnectedNNB(Wavefunction):
    """Neural-net backflow: an MLP emits a configuration-dependent [n, n]
    pairing matrix; amplitude = det of its (up, down) submatrix."""

    def __init__(self, num_sites: int, num_layers: int, layer_size: int,
                 nonlinearity: str = 'relu', name: str = 'fully_connected_nnb'):
        if num_sites % 2:
            raise ValueError('NNB requires an even number of sites.')
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
        params['pairing_head'] = nn.linear_init(
            generator, in_dim, self.num_sites * self.num_sites)
        return params

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        act = ACTIVATIONS[self.nonlinearity]
        h = configs
        for i in range(self.num_layers):
            h = act(nn.linear_apply(params[f'dense_{i}'], h))
        pairing = nn.linear_apply(params['pairing_head'], h)
        pairing = pairing.reshape(-1, self.num_sites, self.num_sites)
        return _slogdet(pairing_submatrix(pairing, configs))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'FullyConnectedNNB':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_fc_layers,
            layer_size=config.fc_layer_size,
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
