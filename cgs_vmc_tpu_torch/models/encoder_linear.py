"""The encoder's fused linear kernel (``csrc/encoder_linear.cu``, design
notes there), its plain PyTorch version, and the rule that decides which
calls of ``models/attention.py``'s four block linears take the kernel
(`linear`).

Both compute, over the rows of a [..., K] tensor,

    y = epilogue(prologue(x) @ w + b)

with the prologue either none or the block's LayerNorm (`layernorm`: the
biased variance, eps inside the root) and the epilogue either none, the
tanh GELU (``F.gelu(approximate='tanh')``) or ``residual + ·``.  The
kernel does it in one launch, with the normalised rows and the
pre-activation never in device memory; the plain version (`plain`) is the
composition the transformer ran before the kernel, which
``torch.func.vmap(grad)`` (SR's Jacobian rows) passes through.  The kernel
has no backward, so it takes only the calls that need no gradient, and
only the (K, N, prologue, epilogue) instances it is built with
(`VARIANTS`, a block at width 64); every other call, and every call on the
CPU, keeps the plain version, which is also what the tests hold the kernel
to.  A call that `route` sends to the kernel launches it or raises.

One library holds the four instances (`library`).

Counters (``utils/profiling.py``): ``encoder_linear.launches``, one a
kernel launch, and ``encoder_linear.plain``, one a CUDA call that took the
plain version.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cgs_vmc_tpu_torch.models import nn
from cgs_vmc_tpu_torch.utils import cuda_build, profiling

# The kernel's epilogues, by their code in the C entry point.
EPILOGUES = {'none': 0, 'gelu': 1, 'residual': 2}
# (K, N, LayerNorm prologue, epilogue): qkv, attn_out, mlp_in and mlp_out
# of a transformer block at width 64, the instances the library holds.
VARIANTS = ((64, 192, True, 'none'), (64, 64, False, 'residual'),
            (64, 256, True, 'gelu'), (256, 64, False, 'residual'))


def layernorm_init(dim: int, generator: torch.Generator) -> dict:
    """`layernorm`'s params at the identity: the scale 1, the shift 0, on
    the generator's device."""
    device = generator.device
    return {'g': torch.ones(dim, dtype=torch.float32, device=device),
            'b': torch.zeros(dim, dtype=torch.float32, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: the biased variance, eps inside the
    root, then the scale `p['g']` and the shift `p['b']`."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return p['g'] * (x - mean) * torch.rsqrt(var + eps) + p['b']


def _epilogue(gelu: bool, residual: Optional[torch.Tensor]) -> str:
    if gelu and residual is not None:
        raise ValueError('the epilogue is the GELU or the residual add, '
                         'not both')
    return 'gelu' if gelu else 'none' if residual is None else 'residual'


def route(layer: dict, x: torch.Tensor, norm: Optional[dict] = None,
          gelu: bool = False,
          residual: Optional[torch.Tensor] = None) -> Optional[str]:
    """None when the call takes the kernel, else why it keeps the plain
    version: 'shape' (an instance the library does not hold, or a residual
    not of the output's shape) or a reason of `cuda_build.forward_only`."""
    w = layer['w']
    k, n = (w.shape if w.dim() == 2 else (None, None))
    if ((k, n, norm is not None, _epilogue(gelu, residual)) not in VARIANTS
            or x.dim() < 2 or x.shape[-1] != k
            or (residual is not None
                and residual.shape != (*x.shape[:-1], n))):
        return 'shape'
    tensors = [x, w, layer['b']]
    if norm is not None:
        tensors += [norm['g'], norm['b']]
    if residual is not None:
        tensors.append(residual)
    return cuda_build.forward_only(*tensors)


def linear(layer: dict, x: torch.Tensor, norm: Optional[dict] = None,
           gelu: bool = False,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel (`encoder_linear`) when `route` lets it take the call,
    else `plain`, counted on a card: [..., K] -> [..., N]."""
    if route(layer, x, norm, gelu, residual) is None:
        return encoder_linear(layer, x, norm, gelu, residual)
    if x.is_cuda:
        profiling.count('encoder_linear.plain')
    return plain(layer, x, norm, gelu, residual)


def plain(layer: dict, x: torch.Tensor, norm: Optional[dict] = None,
          gelu: bool = False,
          residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """epilogue(prologue(x) @ w + b) by PyTorch's operators:
    [..., K] -> [..., N]."""
    _epilogue(gelu, residual)
    if norm is not None:
        x = layernorm(norm, x)
    y = nn.linear_apply(layer, x)
    if gelu:
        y = F.gelu(y, approximate='tanh')
    if residual is not None:
        y = residual + y
    return y


def encoder_linear(layer: dict, x: torch.Tensor, norm: Optional[dict] = None,
                   gelu: bool = False,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel: [..., K] float32 on a card -> [..., N], as `plain`.
    Launches on the current stream and does not synchronise; raises on
    what the kernel does not take (an instance it does not hold, or x, the
    residual or the output not 16-byte aligned, fail the launch)."""
    if x.dim() < 2 or not x.is_cuda or x.dtype != torch.float32:
        raise ValueError(f'x must be a float32 CUDA tensor of at least 2 '
                         f'axes, got {tuple(x.shape)} {x.dtype} on '
                         f'{x.device}')
    epilogue = _epilogue(gelu, residual)
    w = layer['w'].contiguous()
    k, n = w.shape
    shape = (*x.shape[:-1], n)
    if x.shape[-1] != k or (residual is not None
                            and residual.shape != shape):
        raise ValueError(f'x {tuple(x.shape)}, w {tuple(w.shape)} and the '
                         f'residual do not make a linear layer')
    x = x.contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    if residual is not None:
        residual = residual.contiguous()
    g, beta = ((None, None) if norm is None
               else (norm['g'].contiguous(), norm['b'].contiguous()))
    library().launch(
        'encoder_linear_f32', x, w, layer['b'].contiguous(), g, beta,
        residual, out, x.numel() // max(k, 1), k, n, int(norm is not None),
        EPILOGUES[epilogue], counter='encoder_linear.launches')
    return out


def library() -> cuda_build.Library:
    """csrc/encoder_linear.cu: the four instances of `VARIANTS` in one
    build."""
    return cuda_build.load('encoder_linear', 'encoder_linear.cu')
