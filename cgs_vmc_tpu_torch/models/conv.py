"""Convolutional and residual wavefunction ansatzes, 1-D and 2-D with
periodic boundaries (port of cgs_vmc_tpu/models/conv.py, all four types).

Translation-invariant periodic convs feed a site + channel sum; with the
'exp' output activation that sum is logψ.  A 2-D configuration is read as
the size_x × size_y torus with site = x·size_y + y, the JAX package's
``reshape(-1, size_x, size_y, 1)`` in NHWC, which is
``reshape(-1, 1, size_x, size_y)`` here in NCHW.

``compute_dtype='bfloat16'`` (conv_1d, conv_2d): activations and params are
cast to bf16, each conv accumulates in f32 and rounds its output to bf16,
and the final sum runs in f32, as in the JAX package.  In float32 the
convolutions must not use TF32: ``utils.device.resolve_device`` turns TF32
off for cuDNN (and cuBLAS) process-wide when it hands out a CUDA device,
so every entry point of the port runs these convs in full f32.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models import nn
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops import logamp
from cgs_vmc_tpu_torch.ops.logamp import LogAmp

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f'compute_dtype {name!r} is not supported; '
                         f'known: {sorted(_DTYPES)}')
    return _DTYPES[name]


class _ConvStack(Wavefunction):
    """num_layers periodic convs, nonlinearity between them, none after the
    last; the head layer's init is shrunk for the 'exp' output."""

    _conv = None   # (init, apply) of one layer

    def __init__(self, num_layers: int, num_filters: int, kernel_size: int,
                 nonlinearity: str, output_activation: str,
                 compute_dtype: str, name: str):
        self.name = name
        self.num_layers = num_layers
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.nonlinearity = nonlinearity
        self.output_activation = output_activation
        self.compute_dtype = _compute_dtype(compute_dtype)

    def init(self, generator: torch.Generator) -> Params:
        params = {}
        in_ch = 1
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        for i in range(self.num_layers):
            scale = head_scale if i + 1 == self.num_layers else 1.0
            params[f'conv_{i}'] = type(self)._conv[0](
                generator, in_ch, self.num_filters, self.kernel_size,
                scale=scale)
            in_ch = self.num_filters
        return params

    def _stack(self, params: Params, h: torch.Tensor) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        fused = self.nonlinearity == 'relu'   # in the conv's epilogue
        h = h.to(self.compute_dtype)
        for i in range(self.num_layers):
            layer = nn.cast_params(params[f'conv_{i}'], self.compute_dtype)
            hidden = i + 1 != self.num_layers
            h = type(self)._conv[1](layer, h, relu=hidden and fused)
            if hidden and not fused:
                h = act(h).to(self.compute_dtype)
        pre = torch.sum(h.to(torch.float32), dim=tuple(range(1, h.dim())))
        return logamp.apply_activation(pre, self.output_activation)


@register('conv_1d')
class Conv1DNetwork(_ConvStack):
    """Stacked periodic 1-D convolutions; last layer linear, sum over sites
    and channels."""

    _conv = (nn.conv1d_init, nn.conv1d_periodic_apply)

    def __init__(self, num_layers: int, num_filters: int, kernel_size: int,
                 nonlinearity: str = 'relu', output_activation: str = 'exp',
                 compute_dtype: str = 'float32',
                 name: str = 'conv_1d_network'):
        super().__init__(num_layers, num_filters, kernel_size, nonlinearity,
                         output_activation, compute_dtype, name)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return self._stack(params, configs[:, None, :])

    @classmethod
    def from_config(cls, config, name: str = '') -> 'Conv1DNetwork':
        kwargs = dict(num_layers=config.num_conv_layers,
                      num_filters=config.num_conv_filters,
                      kernel_size=config.kernel_size,
                      nonlinearity=config.nonlinearity,
                      output_activation=config.output_activation,
                      compute_dtype=config.compute_dtype)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('conv_2d')
class Conv2DNetwork(_ConvStack):
    """2-D periodic conv stack over the size_x × size_y torus."""

    _conv = (nn.conv2d_init, nn.conv2d_periodic_apply)

    def __init__(self, num_layers: int, num_filters: int, kernel_size: int,
                 size_x: int, size_y: int, nonlinearity: str = 'relu',
                 output_activation: str = 'exp',
                 compute_dtype: str = 'float32',
                 name: str = 'conv_2d_network'):
        super().__init__(num_layers, num_filters, kernel_size, nonlinearity,
                         output_activation, compute_dtype, name)
        self.size_x = size_x
        self.size_y = size_y

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return self._stack(params,
                           configs.reshape(-1, 1, self.size_x, self.size_y))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'Conv2DNetwork':
        kwargs = dict(num_layers=config.num_conv_layers,
                      num_filters=config.num_conv_filters,
                      kernel_size=config.kernel_size,
                      size_x=config.size_x, size_y=config.size_y,
                      nonlinearity=config.nonlinearity,
                      output_activation=config.output_activation,
                      compute_dtype=config.compute_dtype)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


class _ResNet(Wavefunction):
    """Initial periodic conv (the stem) + num_blocks residual or bottleneck
    blocks, then the site + channel sum; always float32."""

    _conv = _block = _bottleneck = None   # (init, apply) pairs

    def __init__(self, num_blocks: int, num_filters: int, kernel_size: int,
                 conv_stride: int, bottleneck: bool, output_activation: str,
                 name: str):
        self.name = name
        self.num_blocks = num_blocks
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.conv_stride = conv_stride
        self.bottleneck = bottleneck
        self.output_activation = output_activation

    def init(self, generator: torch.Generator) -> Params:
        stem_scale = 0.1 if self.output_activation == 'exp' else 1.0
        cls = type(self)
        params = {'stem': cls._conv[0](
            generator, 1, self.num_filters, self.kernel_size,
            scale=stem_scale)}
        block = cls._bottleneck if self.bottleneck else cls._block
        for i in range(self.num_blocks):
            params[f'block_{i}'] = block[0](generator, self.num_filters,
                                            self.kernel_size)
        return params

    def _blocks(self, params: Params, h: torch.Tensor) -> LogAmp:
        cls = type(self)
        h = cls._conv[1](params['stem'], h)
        block = cls._bottleneck if self.bottleneck else cls._block
        for i in range(self.num_blocks):
            h = block[1](params[f'block_{i}'], h, self.conv_stride)
        pre = torch.sum(h, dim=tuple(range(1, h.dim())))
        return logamp.apply_activation(pre, self.output_activation)


@register('res_net_1d')
class ResNet1D(_ResNet):
    """1-D residual ansatz."""

    _conv = (nn.conv1d_init, nn.conv1d_periodic_apply)
    _block = (nn.resblock1d_init, nn.resblock1d_apply)
    _bottleneck = (nn.bottleneck1d_init, nn.bottleneck1d_apply)

    def __init__(self, num_blocks: int, num_filters: int, kernel_size: int,
                 conv_stride: int = 1, bottleneck: bool = False,
                 output_activation: str = 'exp', name: str = 'res_net_1d'):
        super().__init__(num_blocks, num_filters, kernel_size, conv_stride,
                         bottleneck, output_activation, name)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return self._blocks(params, configs[:, None, :])

    @classmethod
    def from_config(cls, config, name: str = '') -> 'ResNet1D':
        kwargs = dict(num_blocks=config.num_resnet_blocks,
                      num_filters=config.num_conv_filters,
                      kernel_size=config.kernel_size,
                      conv_stride=config.conv_strides,
                      bottleneck=config.resnet_bottleneck,
                      output_activation=config.output_activation)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('res_net_2d')
class ResNet2D(_ResNet):
    """2-D residual ansatz over the size_x × size_y torus."""

    _conv = (nn.conv2d_init, nn.conv2d_periodic_apply)
    _block = (nn.resblock2d_init, nn.resblock2d_apply)
    _bottleneck = (nn.bottleneck2d_init, nn.bottleneck2d_apply)

    def __init__(self, num_blocks: int, num_filters: int, kernel_size: int,
                 size_x: int, size_y: int, conv_stride: int = 1,
                 bottleneck: bool = False, output_activation: str = 'exp',
                 name: str = 'res_net_2d'):
        super().__init__(num_blocks, num_filters, kernel_size, conv_stride,
                         bottleneck, output_activation, name)
        self.size_x = size_x
        self.size_y = size_y

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        return self._blocks(params,
                            configs.reshape(-1, 1, self.size_x, self.size_y))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'ResNet2D':
        kwargs = dict(num_blocks=config.num_resnet_blocks,
                      num_filters=config.num_conv_filters,
                      kernel_size=config.kernel_size,
                      conv_stride=config.conv_strides,
                      bottleneck=config.resnet_bottleneck,
                      size_x=config.size_x, size_y=config.size_y,
                      output_activation=config.output_activation)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
