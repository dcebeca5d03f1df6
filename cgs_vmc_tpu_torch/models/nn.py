"""Dense layer primitives (port of cgs_vmc_tpu/models/nn.py:30-52, :273).

Parameters are nested dicts of tensors with the JAX key names; a Dense
kernel is stored ``[in, out]`` as in the JAX package, so weights carry over
without a transpose.
"""

from __future__ import annotations

import math

import torch


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                scale: float = 1.0) -> dict:
    """Dense layer params; fan-in truncated-normal init (±2 stddev).

    `scale` shrinks the init for log-amplitude output heads, so that logψ
    starts nearly flat and Metropolis acceptance does not start at zero.
    Tensors are made on the generator's device.
    """
    stddev = scale / math.sqrt(max(in_dim, 1))
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, std=stddev, a=-2.0 * stddev,
                                b=2.0 * stddev, generator=generator)
    return {'w': w, 'b': torch.zeros(out_dim, dtype=torch.float32,
                                     device=generator.device)}


def linear_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params['w'] + params['b']


def log_cosh(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable log(cosh(x)): |x| + log1p(exp(-2|x|)) - log 2,
    the formula of the JAX package and of the CUDA sweep kernels."""
    ax = torch.abs(x)
    return ax + torch.log1p(torch.exp(-2.0 * ax)) - math.log(2.0)
