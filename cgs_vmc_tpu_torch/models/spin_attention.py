"""The attention kernel (``csrc/spin_attention.cu``, design notes there), its
plain PyTorch version, and the rule that decides which calls of
``models/attention.py::SpinTransformer._attention`` take the kernel
(`attention`).

Both compute, for every image of a batch and every head, the attention core
between the qkv and attn_out projections,

    out[b, q, h·d_h + j] = Σ_k softmax_k(q·k / √d_h) v[b, k, h, j],

reading q, k and v from the qkv projection's output as it stands, [B, n,
3·d], each token row laid out 3 × heads × d_h, and returning [B, n, d] in
the layout the attn_out projection takes.  The kernel does it in one launch
with no logits tensor and no permute copy; the plain version (`plain`) is
the einsums, which ``torch.func.vmap(grad)`` (SR's Jacobian rows) passes
through.  The kernel has no backward, so it takes only the calls that need
no gradient (`route`); every other call, and every call on the CPU, keeps
the plain version, which is also what the tests hold the kernel to.  A call
that `route` sends to the kernel launches it or raises.

The kernel is built once for each (n, heads, d_h) it meets.

Counters (``utils/profiling.py``): ``attention.launches``, one a kernel
launch, and ``attention.plain``, one a CUDA call that took the plain
version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from cgs_vmc_tpu_torch.utils import cuda_build, profiling

MAX_TOKENS = 64
HEAD_DIMS = (4, 8, 16)


def route(qkv: torch.Tensor, num_heads: int) -> Optional[str]:
    """None when the call takes the kernel, else why it keeps the plain
    version: 'shape' (not [batch, n, 3·d], more than MAX_TOKENS tokens, or
    a head width outside HEAD_DIMS) or a reason of
    `cuda_build.forward_only`."""
    if (qkv.dim() != 3 or qkv.shape[1] > MAX_TOKENS
            or qkv.shape[2] % (3 * num_heads)
            or qkv.shape[2] // (3 * num_heads) not in HEAD_DIMS):
        return 'shape'
    return cuda_build.forward_only(qkv)


def attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The kernel (`spin_attention`) when `route` lets it take the call,
    else `plain`, counted on a card: [batch, n, 3·d] -> [batch, n, d]."""
    if route(qkv, num_heads) is None:
        return spin_attention(qkv, num_heads)
    if qkv.is_cuda:
        profiling.count('attention.plain')
    return plain(qkv, num_heads)


def plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The attention core by einsums: [batch, n, 3·d] -> [batch, n, d]."""
    batch, n, width = qkv.shape
    d = width // 3
    dh = d // num_heads
    # [B, n, 3, nh, dh], split on axis 2: the order the weights were
    # trained in.
    q, k, v = qkv.reshape(batch, n, 3, num_heads, dh).unbind(dim=2)
    # One [B, heads, n, n] tensor less alive at the softmax than with the
    # logits kept (a connected-board chunk's are GBs).
    attn = torch.softmax(
        torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(dh), dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', attn, v)
    return out.reshape(batch, n, d)


def spin_attention(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The kernel: [batch, n, 3·d] float32 on a card -> [batch, n, d], as
    `plain`.  Launches on the current stream and does not synchronise;
    raises on what the kernel does not take (n > MAX_TOKENS or a head width
    outside HEAD_DIMS fail its build; a slab over the shared memory or a
    qkv not 16-byte aligned fails the launch)."""
    if qkv.dim() != 3 or not qkv.is_cuda or qkv.dtype != torch.float32:
        raise ValueError(f'qkv must be a 3-D float32 CUDA tensor, got '
                         f'{tuple(qkv.shape)} {qkv.dtype} on {qkv.device}')
    batch, n, width = qkv.shape
    if width % (3 * num_heads):
        raise ValueError(f'qkv width {width} is not 3 × {num_heads} heads')
    dh = width // (3 * num_heads)
    qkv = qkv.contiguous()
    out = torch.empty((batch, n, num_heads * dh), dtype=torch.float32,
                      device=qkv.device)
    library(n, num_heads, dh).launch(
        'spin_attention_f32', qkv, out, batch, n, num_heads, dh,
        counter='attention.launches')
    return out


def library(n: int, heads: int, head_dim: int) -> cuda_build.Library:
    """csrc/spin_attention.cu for n tokens, `heads` heads and `head_dim`
    floats a head."""
    return cuda_build.load(
        f'spin_attention_n{n}_h{heads}_d{head_dim}', 'spin_attention.cu',
        (f'SPIN_ATTENTION_N={n}', f'SPIN_ATTENTION_HEADS={heads}',
         f'SPIN_ATTENTION_HEAD_DIM={head_dim}'))
