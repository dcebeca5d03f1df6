"""Matrix product state ansatz as a rescaled chain contraction (port of
cgs_vmc_tpu/models/mps.py).

 * The per-site tensors live in one stacked [n_sites-2, 2, D, D] array; the
   spin-selected matrix is a gather along the physical axis, and the chain
   is a loop of n_sites-2 batched [B, D] x [B, D, D] matvecs.
 * The running vector is renormalized by its max-abs each step with the
   log-scale accumulated separately, so the amplitude comes out directly
   in signed-log form with no overflow for any chain length.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


def spin_index(configs: torch.Tensor) -> torch.Tensor:
    """±1 spins -> {0, 1} indices of the physical axis."""
    return ((configs + 1.0) / 2.0).to(torch.int64)


@register('mps')
class MatrixProductState(Wavefunction):

    def __init__(self, num_sites: int, bond_dimension: int,
                 name: str = 'matrix_product_state'):
        if num_sites < 3:
            raise ValueError('MPS requires at least 3 sites.')
        self.name = name
        self.num_sites = num_sites
        self.bond_dimension = bond_dimension

    def init(self, generator: torch.Generator) -> Params:
        d = self.bond_dimension
        noise = 0.1

        def normal(*shape):
            return torch.randn(shape, generator=generator,
                               device=generator.device)

        # Identity-plus-noise keeps the initial chain product O(1) so the
        # log-rescaled contraction starts well-conditioned.
        first = torch.ones((2, d), device=generator.device) / d \
            + noise * normal(2, d)
        mid = torch.eye(d, device=generator.device)[None, None] \
            + noise * normal(self.num_sites - 2, 2, d, d)
        last = torch.ones((2, d), device=generator.device) \
            + noise * normal(2, d)
        return {'first': first, 'mid': mid, 'last': last}

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        spin_idx = spin_index(configs)                       # [B, N]
        vec = params['first'][spin_idx[:, 0]]                # [B, D]
        log_scale = torch.zeros(configs.shape[0], dtype=vec.dtype,
                                device=vec.device)
        mid = params['mid']
        for k in range(mid.shape[0]):
            mats = mid[k][spin_idx[:, k + 1]]                # [B, D, D]
            vec = torch.einsum('bd,bde->be', vec, mats)
            norm = torch.amax(torch.abs(vec), dim=-1, keepdim=True)
            norm = torch.where(norm > 0, norm, torch.ones_like(norm))
            vec = vec / norm
            log_scale = log_scale + torch.log(norm[:, 0])
        final = torch.einsum('bd,bd->b', vec,
                             params['last'][spin_idx[:, -1]])
        return LogAmp(torch.sign(final),
                      log_scale + torch.log(torch.abs(final)))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'MatrixProductState':
        kwargs = dict(
            num_sites=config.num_sites,
            bond_dimension=config.bond_dimension,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
