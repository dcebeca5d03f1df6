"""The attention kernel (``csrc/spin_attention.cu``, design notes there), its
plain PyTorch version, and the rule that decides which calls of
``models/attention.py::SpinTransformer._attention`` take the kernel.

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
launch, and ``attention.plain``, one a CUDA call that took the plain version
(counted by the caller).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from cgs_vmc_tpu_torch.utils import cuda_build, profiling

KERNEL = 'kernel'
MAX_TOKENS = 64
HEAD_DIMS = (4, 8, 16)


def route(qkv: torch.Tensor, num_heads: int) -> str:
    """'kernel' when the call takes the kernel, else why it keeps the plain
    version: 'dtype' (not float32), 'torch.func' (inside a torch.func
    transform, such as SR's vmap(grad) rows), 'grad' (grad mode on and qkv
    requires grad), 'shape' (not [batch, n, 3·d], more than MAX_TOKENS
    tokens, or a head width outside HEAD_DIMS) or 'device' (not a CUDA
    tensor)."""
    if qkv.dtype != torch.float32:
        return 'dtype'
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return 'torch.func'
    if torch.is_grad_enabled() and qkv.requires_grad:
        return 'grad'
    if (qkv.dim() != 3 or qkv.shape[1] > MAX_TOKENS
            or qkv.shape[2] % (3 * num_heads)
            or qkv.shape[2] // (3 * num_heads) not in HEAD_DIMS):
        return 'shape'
    if qkv.device.type != 'cuda':
        return 'device'
    return KERNEL


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
    lib = _lib(n, num_heads, dh)
    qkv = qkv.contiguous()
    out = torch.empty((batch, n, num_heads * dh), dtype=torch.float32,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.spin_attention_f32(
            qkv.data_ptr(), out.data_ptr(), batch, n, num_heads, dh,
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.spin_attention_error_string(err).decode()
        raise RuntimeError(f'spin_attention launch failed: CUDA error {err} '
                           f'({msg}) at qkv {tuple(qkv.shape)}, '
                           f'{num_heads} heads')
    profiling.count('attention.launches')
    return out


@functools.cache
def _lib(n: int, heads: int, head_dim: int) -> ctypes.CDLL:
    """Builds (at first use) and loads csrc/spin_attention.cu for n tokens,
    `heads` heads and `head_dim` floats a head."""
    lib = ctypes.CDLL(str(cuda_build.build_library(
        f'spin_attention_n{n}_h{heads}_d{head_dim}',
        [cuda_build.CSRC_DIR / 'spin_attention.cu'],
        [f'SPIN_ATTENTION_N={n}', f'SPIN_ATTENTION_HEADS={heads}',
         f'SPIN_ATTENTION_HEAD_DIM={head_dim}'])))
    voidp, c_int = ctypes.c_void_p, ctypes.c_int
    lib.spin_attention_f32.argtypes = [voidp] * 2 + [c_int] * 4 + [voidp]
    lib.spin_attention_f32.restype = c_int
    lib.spin_attention_error_string.argtypes = [c_int]
    lib.spin_attention_error_string.restype = ctypes.c_char_p
    return lib
