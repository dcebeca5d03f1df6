"""The symmetrized periodic 2-D conv stack: the board as a size_x × size_y
torus; num_conv_layers k × k cross-correlations with the nonlinearity
between layers and none after the last; the sum over channels and sites is
the log of one image's amplitude; ψ is the mean of the amplitudes over the
eight elements of C4v (and the global spin flip)."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_ACTIVATIONS = {'relu': torch.relu, 'tanh': torch.tanh,
                'selu': F.selu, 'sigmoid': torch.sigmoid}


def _c4v(x: torch.Tensor) -> torch.Tensor:
    """[batch, 8, L, L]: x under the four rotations and four reflections
    of the square."""
    t = x.transpose(1, 2)
    images = [torch.rot90(x, r, dims=(1, 2)) for r in range(4)]
    images += [torch.rot90(t, r, dims=(1, 2)) for r in range(4)]
    return torch.stack(images, dim=1)


def build(cfg: dict) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    lx, ly, k = cfg['size_x'], cfg['size_y'], cfg['kernel_size']
    if k % 2 == 0:
        raise ValueError('the reference conv takes an odd kernel')
    if cfg['symmetrize'] and lx != ly:
        raise ValueError('the reference symmetrizes square tori only')
    if cfg['output_activation'] != 'exp':
        raise ValueError("the reference conv has the 'exp' output only")
    act = _ACTIVATIONS[cfg['nonlinearity']]
    layers = cfg['num_conv_layers']
    pad = (k - 1) // 2

    def image_log(p: Params, images: torch.Tensor) -> torch.Tensor:
        h = images[:, None]
        for i in range(layers):
            w = p[f'conv_{i}.w'].permute(3, 2, 0, 1)     # HWIO -> OIHW
            h = F.conv2d(F.pad(h, (pad,) * 4, mode='circular'), w)
            h = h + p[f'conv_{i}.b'][:, None, None]
            if i + 1 < layers:
                h = act(h)
        return h.sum(dim=(1, 2, 3))

    def log_psi(p: Params, s: torch.Tensor) -> torch.Tensor:
        x = s.reshape(-1, lx, ly)
        orbit = _c4v(x) if cfg['symmetrize'] else x[:, None]
        if cfg['symmetrize'] and cfg['symmetrize_spin_flip']:
            orbit = torch.cat([orbit, -orbit], dim=1)
        n_ops = orbit.shape[1]
        logs = image_log(p, orbit.reshape(-1, lx, ly)).reshape(-1, n_ops)
        return torch.logsumexp(logs, dim=1) - math.log(n_ops)
    return log_psi
