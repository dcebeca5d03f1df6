"""2-D masked-convolution autoregressive ansatz, PixelCNN-style (port of
cgs_vmc_tpu/models/pixelcnn.py).

A stack of causally masked convolutions in raster order, with the same
exact properties as the MADE ansatz (models/autoregressive.py): |psi|^2
exactly normalized on the Sz=0 sector, i.i.d. ancestral sampling, one
parallel forward for evaluation.

Raster order is the package's site convention, site = x*size_y + y: "past"
means (x' < x) or (x' == x, y' < y).  A kernel tap at offset (dx, dy) is
allowed iff it points to the past; the first layer also masks the centre
tap (mask 'A': logit_i must exclude s_i itself), later layers may use the
centre feature (mask 'B': that feature already excludes the site's own
spin).  Padding is zero, not the periodic wrap of models/nn.py: a wrap
would leak future sites.  Kernels stay in the JAX layout HWIO
``[k, k, c_in, c_out]`` and are permuted at apply time, as in
models/conv.py.

Everything but the logits network (the sector-projected conditionals,
apply, ancestral sampling on the generic one-forward-a-site path, the
exact-draw sampler entry) is inherited from AutoregressiveSpinModel.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from cgs_vmc_tpu_torch.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_tpu_torch.models.base import Params, register
from cgs_vmc_tpu_torch.ops import logamp


def _causal_mask(kernel: int, c_in: int, c_out: int,
                 include_center: bool) -> np.ndarray:
    """[k, k, c_in, c_out] 0/1 mask; tap (dx, dy) allowed iff it reads a
    raster-past site (dx<0, or dx==0 and dy<0), plus the centre for
    mask 'B'."""
    half = kernel // 2
    mask = np.zeros((kernel, kernel, 1, 1), np.float32)
    for kx in range(kernel):
        for ky in range(kernel):
            dx, dy = kx - half, ky - half
            past = (dx < 0) or (dx == 0 and dy < 0)
            if past or (include_center and dx == 0 and dy == 0):
                mask[kx, ky] = 1.0
    return np.broadcast_to(mask, (kernel, kernel, c_in, c_out)).copy()


@register('pixelcnn')
class MaskedConv2DAutoregressive(AutoregressiveSpinModel):
    """Causal masked-conv conditionals over a size_x × size_y lattice."""

    def __init__(self, size_x: int, size_y: int, num_layers: int = 3,
                 num_filters: int = 16, kernel_size: int = 3,
                 nonlinearity: str = 'relu', name: str = 'pixelcnn'):
        num_sites = size_x * size_y
        if num_sites % 2:
            raise ValueError('Sz=0 sector requires even num_sites')
        if kernel_size % 2 == 0:
            raise ValueError('causal masking needs an odd kernel')
        self.name = name
        self.num_sites = num_sites
        self.size_x = size_x
        self.size_y = size_y
        self.num_layers = max(1, num_layers)
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.nonlinearity = nonlinearity
        f = num_filters
        self.masks = [_causal_mask(kernel_size, 1, f, False)]
        for _ in range(self.num_layers - 1):
            self.masks.append(_causal_mask(kernel_size, f, f, True))
        self.masks.append(_causal_mask(1, f, 1, True))  # 1x1 head
        self._device_masks: Dict[torch.device, list] = {}

    def init(self, generator: torch.Generator) -> Params:
        device = generator.device
        params = {}
        for i, mask in enumerate(self.masks):
            fan_in = max(float(mask[..., 0].sum()), 1.0)
            w = torch.randn(mask.shape, generator=generator,
                            dtype=torch.float32, device=device)
            params[f'conv_{i}'] = {
                'w': w / np.sqrt(fan_in),
                'b': torch.zeros(mask.shape[-1], dtype=torch.float32,
                                 device=device),
            }
        return params

    def _logits(self, params: Params, configs: torch.Tensor) -> torch.Tensor:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        masks = self._masks_on(configs.device)
        h = configs.to(torch.float32).reshape(
            -1, 1, self.size_x, self.size_y)
        last = len(masks) - 1
        for i, mask in enumerate(masks):
            layer = params[f'conv_{i}']
            w = (layer['w'] * mask).permute(3, 2, 0, 1)   # HWIO -> OIHW
            # Zero padding: causal, not periodic.
            h = F.conv2d(h, w, padding=mask.shape[0] // 2)
            h = h + layer['b'][:, None, None]
            if i != last:
                h = act(h)
        return h.reshape(-1, self.num_sites)

    @classmethod
    def from_config(cls, config, name: str = ''
                    ) -> 'MaskedConv2DAutoregressive':
        if config.size_x <= 1 or config.size_y <= 1 or (
                config.size_x * config.size_y != config.num_sites):
            raise ValueError('pixelcnn requires a 2-D lattice with '
                             'size_x*size_y == num_sites')
        kwargs = dict(
            size_x=config.size_x, size_y=config.size_y,
            num_layers=config.num_conv_layers,
            num_filters=config.num_conv_filters,
            kernel_size=config.kernel_size,
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
