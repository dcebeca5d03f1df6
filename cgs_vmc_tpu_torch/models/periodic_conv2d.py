"""The periodic 2-D convolution kernel (``csrc/periodic_conv2d.cu``, design
notes there), its plain PyTorch route, and the rule that decides which
calls of ``models/nn.py::conv2d_periodic_apply`` take the kernel (`apply`).

The kernel computes the periodic k×k cross-correlation of an unpadded NCHW
input with an HWIO weight, plus the bias and, if asked, the ReLU, in one
launch: it wraps the indices while it loads, and no padded tensor is made.
It has no backward, so it takes only the calls that need no gradient
(`route`); every other call, and every call on the CPU, keeps the plain
route (`plain`: wrap padding by ``torch.cat`` + an unpadded ``F.conv2d`` +
the bias), which is also what the tests hold the kernel to.  A call that
`route` sends to the kernel launches it or raises.

The kernel is built once for each (k, size_y) it meets, with the padding
before (lo, from ``nn._pad_widths_2d``) as a build constant.

Counters (``utils/profiling.py``): ``periodic_conv.launches``, one a kernel
launch, and ``periodic_conv.plain``, one a CUDA call that took the plain
route.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cgs_vmc_tpu_torch.utils import cuda_build, profiling


def route(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int) -> Optional[str]:
    """None when the call takes the kernel, else why it keeps the plain
    route: 'stride' (not 1) or a reason of `cuda_build.forward_only`."""
    if stride != 1:
        return 'stride'
    return cuda_build.forward_only(x, w, b)


def apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, lo: int,
          hi: int, stride: int, relu: bool) -> torch.Tensor:
    """The kernel (`periodic_conv2d`) when `route` lets it take the call,
    else `plain`, counted on a card."""
    if route(x, w, b, stride) is None:
        return periodic_conv2d(x, w, b, lo, hi, relu)
    if x.is_cuda:
        profiling.count('periodic_conv.plain')
    return plain(x, w, b, lo, hi, stride, relu)


def plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, lo: int,
          hi: int, stride: int, relu: bool) -> torch.Tensor:
    """The plain route: `x` wrap-padded (lo, hi) on both axes, an unpadded
    ``F.conv2d`` with w [k, k, c_in, c_out] at `stride`, + b, then ReLU if
    `relu`."""
    padded = wrap(wrap(x, 3, lo, hi), 2, lo, hi)
    out = F.conv2d(padded, w.permute(3, 2, 0, 1), stride=stride)
    out = out + b[:, None, None]
    return torch.relu(out) if relu else out


def wrap(x: torch.Tensor, dim: int, lo: int, hi: int) -> torch.Tensor:
    """Periodic padding of `x` along `dim`: lo wrapped entries before,
    hi after."""
    size = x.shape[dim]
    return torch.cat([x.narrow(dim, size - lo, lo), x,
                      x.narrow(dim, 0, hi)], dim=dim)


def periodic_conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    lo: int, hi: int, relu: bool) -> torch.Tensor:
    """The kernel: [batch, c_in, size_x, size_y] float32 on a card ->
    [batch, c_out, size_x, size_y], the periodic cross-correlation with w
    [k, k, c_in, c_out] padded (lo, hi) on both axes, + b, then ReLU if
    `relu`.  Launches on the current stream and does not synchronise;
    raises on what the kernel does not take (k > 8 or size_y > 32 fail its
    build; size_x > 256, more than 512 items of 4 channels × a few rows an
    image, or a weight that does not fit the shared memory fail the
    launch)."""
    if x.dim() != 4 or not x.is_cuda:
        raise ValueError(f'x must be a 4-D CUDA tensor, got '
                         f'{tuple(x.shape)} on {x.device}')
    batch, c_in, size_x, size_y = x.shape
    k = w.shape[0]
    c_out = w.shape[-1]
    if tuple(w.shape) != (k, k, c_in, c_out) or tuple(b.shape) != (c_out,):
        raise ValueError(f'w {tuple(w.shape)} and b {tuple(b.shape)} do not '
                         f'fit x {tuple(x.shape)}')
    for name, t in (('x', x), ('w', w), ('b', b)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f'{name} must be float32 on {x.device}, got '
                             f'{t.dtype} on {t.device}')
    if lo + hi + 1 != k:
        raise ValueError(f'padding ({lo}, {hi}) does not fit k={k}')
    lib = library(k, size_y, lo)
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty((batch, c_out, size_x, size_y), dtype=torch.float32,
                      device=x.device)
    lib.launch('periodic_conv2d_f32', x, w, b, out, batch, c_in, c_out,
               size_x, size_y, k, int(relu),
               counter='periodic_conv.launches')
    return out


def library(kernel: int, size_y: int, lo: int) -> cuda_build.Library:
    """csrc/periodic_conv2d.cu for k = `kernel`, L_y = `size_y` and `lo`
    wrapped entries before each row and column."""
    return cuda_build.load(
        f'periodic_conv2d_k{kernel}_y{size_y}', 'periodic_conv2d.cu',
        (f'PERIODIC_CONV_K={kernel}', f'PERIODIC_CONV_SIZE_Y={size_y}',
         f'PERIODIC_CONV_LO={lo}'))
