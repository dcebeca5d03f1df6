"""Graph-convolutional wavefunction ansatz for arbitrary lattices (port of
cgs_vmc_tpu/models/graph_conv.py): neighbour features are gathered by a
static [n_sites, num_neighbors] adjacency list and contracted with a
kernel shared across sites in one einsum.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cgs_vmc_tpu_torch import lattice
from cgs_vmc_tpu_torch.models import nn
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops import logamp
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


@register('gnn')
class GraphConvNetwork(Wavefunction):

    def __init__(self, num_layers: int, num_filters: int, adj: np.ndarray,
                 nonlinearity: str = 'relu', output_activation: str = 'exp',
                 name: str = 'graph_conv_network'):
        self.name = name
        self.num_layers = num_layers
        self.num_filters = num_filters
        self.adj = np.asarray(adj, np.int32)   # host table; see _adj_on
        self.nonlinearity = nonlinearity
        self.output_activation = output_activation
        self._adj: Dict[torch.device, torch.Tensor] = {}

    def _adj_on(self, device: torch.device) -> torch.Tensor:
        """The adjacency list as an index tensor on `device`, copied there
        once."""
        if device not in self._adj:
            self._adj[device] = torch.as_tensor(self.adj.astype(np.int64),
                                                device=device)
        return self._adj[device]

    def init(self, generator: torch.Generator) -> Params:
        num_neighbors = self.adj.shape[1]
        params = {}
        in_ch = 1
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        for i in range(self.num_layers):
            scale = head_scale if i + 1 == self.num_layers else 1.0
            params[f'gconv_{i}'] = nn.graph_conv_init(
                generator, in_ch, self.num_filters, num_neighbors,
                scale=scale)
            in_ch = self.num_filters
        return params

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        adj = self._adj_on(configs.device)
        h = configs[..., None]                     # [batch, n_sites, 1]
        for i in range(self.num_layers):
            h = nn.graph_conv_apply(params[f'gconv_{i}'], h, adj)
            if i + 1 != self.num_layers:
                h = act(h)
        pre = torch.sum(h, dim=(1, 2))
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'GraphConvNetwork':
        if config.adjacency_list_path:
            adj = lattice.load_adjacency(config.adjacency_list_path)
        else:
            adj = lattice.adjacency_from_bonds(
                lattice.bonds_for_config(config), config.num_sites)
        kwargs = dict(
            num_layers=config.num_conv_layers,
            num_filters=config.num_conv_filters,
            adj=adj,
            nonlinearity=config.nonlinearity,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
