"""Layer primitives (port of cgs_vmc_tpu/models/nn.py: Dense, periodic
convolutions, residual blocks, graph convolution, cast_params, log_cosh).

Parameters are nested dicts of tensors with the JAX key names and the JAX
layouts: a Dense kernel is ``[in, out]``, a 1-D conv kernel ``[k, in, out]``
(WIO) and a 2-D one ``[k, k, in, out]`` (HWIO), exactly as the committed
``.msgpack`` artifacts store them, so weights carry over without a
transpose.  The apply functions permute a kernel to torch's OIW/OIHW at
call time.

Activations are channels-first (``[batch, ch, width]``, ``[batch, ch, x,
y]``); the JAX package's are channels-last.  Periodic boundaries are wrap
padding built with ``torch.cat``, as in the JAX code (and safe under
``torch.func.vmap``), feeding an unpadded convolution.  Padding follows the
reference: odd k pads (k-1)/2 on both sides; even k pads left k/2, right
k/2-1 in 1-D, and lo k/2-1, hi k/2 on both axes in 2-D (mirrored).  Both
packages compute cross-correlations, so no kernel is flipped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _trunc_normal(generator: torch.Generator, shape, stddev: float
                  ) -> torch.Tensor:
    """Truncated normal at ±2 stddev, on the generator's device."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, std=stddev, a=-2.0 * stddev,
                                b=2.0 * stddev, generator=generator)
    return w


def _zeros(n: int, generator: torch.Generator) -> torch.Tensor:
    return torch.zeros(n, dtype=torch.float32, device=generator.device)


# ----------------------------------------------------------------------
# Dense.
# ----------------------------------------------------------------------

def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                scale: float = 1.0) -> dict:
    """Dense layer params; fan-in truncated-normal init (±2 stddev).

    `scale` shrinks the init for log-amplitude output heads, so that logψ
    starts nearly flat and Metropolis acceptance does not start at zero.
    Tensors are made on the generator's device.
    """
    stddev = scale / math.sqrt(max(in_dim, 1))
    return {'w': _trunc_normal(generator, (in_dim, out_dim), stddev),
            'b': _zeros(out_dim, generator)}


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params['w'] + params['b']


# ----------------------------------------------------------------------
# Periodic convolutions.
# ----------------------------------------------------------------------

def _pad_widths_1d(kernel: int):
    if kernel % 2 == 1:
        return (kernel - 1) // 2, (kernel - 1) // 2
    return kernel // 2, kernel // 2 - 1


def _pad_widths_2d(kernel: int):
    if kernel % 2 == 1:
        return (kernel - 1) // 2, (kernel - 1) // 2
    return kernel // 2 - 1, kernel // 2


def _wrap(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """Periodic padding of `x` along `dim`: lo wrapped entries before,
    hi after."""
    size = x.shape[dim]
    return torch.cat([x.narrow(dim, size - lo, lo), x,
                      x.narrow(dim, 0, hi)], dim=dim)


def conv1d_init(generator: torch.Generator, in_channels: int,
                out_channels: int, kernel: int, scale: float = 1.0) -> dict:
    stddev = scale / math.sqrt(max(in_channels * kernel, 1))
    return {'w': _trunc_normal(generator, (kernel, in_channels, out_channels),
                               stddev),
            'b': _zeros(out_channels, generator)}


def conv1d_periodic_apply(params: dict, x: torch.Tensor, stride: int = 1
                          ) -> torch.Tensor:
    """Periodic 1-D conv; x: [batch, in_ch, width] -> [batch, out_ch,
    ceil(width / stride)].  The output dtype follows the input's (one
    rounding per layer in bf16; the convolution accumulates in f32), and
    the bias is added after that rounding, as in the JAX package."""
    w = params['w']
    padded = _wrap(x, 2, *_pad_widths_1d(w.shape[0]))
    out = F.conv1d(padded, w.permute(2, 1, 0), stride=stride)
    return out + params['b'][:, None]


def conv2d_init(generator: torch.Generator, in_channels: int,
                out_channels: int, kernel: int, scale: float = 1.0) -> dict:
    stddev = scale / math.sqrt(max(in_channels * kernel * kernel, 1))
    return {'w': _trunc_normal(
                generator, (kernel, kernel, in_channels, out_channels),
                stddev),
            'b': _zeros(out_channels, generator)}


def conv2d_periodic_apply(params: dict, x: torch.Tensor, stride: int = 1
                          ) -> torch.Tensor:
    """Periodic 2-D conv; x: [batch, in_ch, x, y] -> [batch, out_ch,
    ceil(x / stride), ceil(y / stride)].  Dtypes as conv1d_periodic_apply."""
    w = params['w']
    lo, hi = _pad_widths_2d(w.shape[0])
    padded = _wrap(_wrap(x, 3, lo, hi), 2, lo, hi)
    out = F.conv2d(padded, w.permute(3, 2, 0, 1), stride=stride)
    return out + params['b'][:, None, None]


# ----------------------------------------------------------------------
# Residual blocks: batch-norm-free, selu between the two convs, identity
# shortcut (subsampled to match a strided first conv); bottleneck blocks
# reduce with a 1x1 conv, apply the kxk conv, expand back with a 1x1 conv.
# ----------------------------------------------------------------------

def resblock1d_init(generator: torch.Generator, channels: int,
                    kernel: int) -> dict:
    return {'conv1': conv1d_init(generator, channels, channels, kernel),
            'conv2': conv1d_init(generator, channels, channels, kernel)}


def resblock1d_apply(params: dict, x: torch.Tensor, stride: int = 1
                     ) -> torch.Tensor:
    h = F.selu(conv1d_periodic_apply(params['conv1'], x, stride))
    h = conv1d_periodic_apply(params['conv2'], h)
    return h + x[:, :, ::stride]


def resblock2d_init(generator: torch.Generator, channels: int,
                    kernel: int) -> dict:
    return {'conv1': conv2d_init(generator, channels, channels, kernel),
            'conv2': conv2d_init(generator, channels, channels, kernel)}


def resblock2d_apply(params: dict, x: torch.Tensor, stride: int = 1
                     ) -> torch.Tensor:
    h = F.selu(conv2d_periodic_apply(params['conv1'], x, stride))
    h = conv2d_periodic_apply(params['conv2'], h)
    return h + x[:, :, ::stride, ::stride]


def bottleneck1d_init(generator: torch.Generator, channels: int,
                      kernel: int, bottleneck_ratio: int = 2) -> dict:
    narrow = max(channels // bottleneck_ratio, 1)
    return {'reduce': conv1d_init(generator, channels, narrow, 1),
            'conv': conv1d_init(generator, narrow, narrow, kernel),
            'expand': conv1d_init(generator, narrow, channels, 1)}


def bottleneck1d_apply(params: dict, x: torch.Tensor, stride: int = 1
                       ) -> torch.Tensor:
    h = torch.relu(conv1d_periodic_apply(params['reduce'], x))
    h = torch.relu(conv1d_periodic_apply(params['conv'], h, stride))
    h = conv1d_periodic_apply(params['expand'], h)
    return h + x[:, :, ::stride]


def bottleneck2d_init(generator: torch.Generator, channels: int,
                      kernel: int, bottleneck_ratio: int = 2) -> dict:
    narrow = max(channels // bottleneck_ratio, 1)
    return {'reduce': conv2d_init(generator, channels, narrow, 1),
            'conv': conv2d_init(generator, narrow, narrow, kernel),
            'expand': conv2d_init(generator, narrow, channels, 1)}


def bottleneck2d_apply(params: dict, x: torch.Tensor, stride: int = 1
                       ) -> torch.Tensor:
    h = torch.relu(conv2d_periodic_apply(params['reduce'], x))
    h = torch.relu(conv2d_periodic_apply(params['conv'], h, stride))
    h = conv2d_periodic_apply(params['expand'], h)
    return h + x[:, :, ::stride, ::stride]


# ----------------------------------------------------------------------
# Graph convolution: gather neighbour features by adjacency list, contract
# with a [num_neighbors, in, out] kernel shared across sites.
# ----------------------------------------------------------------------

def graph_conv_init(generator: torch.Generator, in_channels: int,
                    out_channels: int, num_neighbors: int,
                    scale: float = 1.0) -> dict:
    stddev = scale / math.sqrt(max(in_channels * num_neighbors, 1))
    return {'w': _trunc_normal(
                generator, (num_neighbors, in_channels, out_channels),
                stddev),
            'b': _zeros(out_channels, generator)}


def graph_conv_apply(params: dict, x: torch.Tensor, adj: torch.Tensor
                     ) -> torch.Tensor:
    """x: [batch, n_sites, in_ch]; adj: [n_sites, num_neighbors] int64 on
    x's device.  Channels stay last here, as in the JAX package."""
    gathered = x[:, adj, :]        # [batch, n_sites, num_neighbors, in_ch]
    out = torch.einsum('bsnc,nco->bso', gathered, params['w'])
    return out + params['b']


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Casts a layer's params for reduced-precision compute at apply time
    (the stored params, the optimizer and checkpoints stay float32)."""
    if dtype == torch.float32:
        return params
    return {k: cast_params(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in params.items()}


def log_cosh(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable log(cosh(x)): |x| + log1p(exp(-2|x|)) - log 2,
    the formula of the JAX package and of the CUDA sweep kernels."""
    ax = torch.abs(x)
    return ax + torch.log1p(torch.exp(-2.0 * ax)) - math.log(2.0)
