"""The periodic 2-D convolution kernel (``csrc/periodic_conv2d.cu``, design
notes there) and the rule that decides which calls of
``models/nn.py::conv2d_periodic_apply`` take it.

The kernel computes the periodic k×k cross-correlation of an unpadded NCHW
input with an HWIO weight, plus the bias and, if asked, the ReLU, in one
launch: it wraps the indices while it loads, and no padded tensor is made.
It has no backward, so it takes only the calls that need no gradient
(`route`); every other call, and every call on the CPU, keeps the plain
route of ``nn.conv2d_periodic_apply`` (wrap padding by ``torch.cat`` + an
unpadded ``F.conv2d`` + the bias), which is also what the tests hold the
kernel to.  A call that `route` sends to the kernel launches it or raises.

The kernel is built once for each (k, size_y) it meets, with the padding
before (lo, from ``nn._pad_widths_2d``) as a build constant.

Counters (``utils/profiling.py``): ``periodic_conv.launches``, one a kernel
launch, and ``periodic_conv.plain``, one a CUDA call that took the plain
route (counted by the caller).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cgs_vmc_tpu_torch.utils import cuda_build, profiling

KERNEL = 'kernel'


def route(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          stride: int) -> str:
    """'kernel' when the call takes the kernel, else why it keeps the plain
    route: 'dtype' (not all float32, e.g. a bf16 compute_dtype), 'stride'
    (not 1), 'torch.func' (inside a torch.func transform, such as SR's
    vmap(grad) rows), 'grad' (grad mode on and the input or a param
    requires grad) or 'device' (not a CUDA tensor)."""
    if not (x.dtype == w.dtype == b.dtype == torch.float32):
        return 'dtype'
    if stride != 1:
        return 'stride'
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return 'torch.func'
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return 'grad'
    if x.device.type != 'cuda':
        return 'device'
    return KERNEL


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
    lib = _lib(k, size_y, lo)
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty((batch, c_out, size_x, size_y), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = lib.periodic_conv2d_f32(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), batch,
            c_in, c_out, size_x, size_y, k, int(relu),
            torch.cuda.current_stream().cuda_stream)
    if err:
        msg = lib.periodic_conv2d_error_string(err).decode()
        raise RuntimeError(f'periodic_conv2d launch failed: CUDA error {err} '
                           f'({msg}) at x {tuple(x.shape)}, k={k}, '
                           f'c_out={c_out}')
    profiling.count('periodic_conv.launches')
    return out


@functools.cache
def _lib(kernel: int, size_y: int, lo: int) -> ctypes.CDLL:
    """Builds (at first use) and loads csrc/periodic_conv2d.cu for k =
    `kernel`, L_y = `size_y` and `lo` wrapped entries before each row and
    column."""
    lib = ctypes.CDLL(str(cuda_build.build_library(
        f'periodic_conv2d_k{kernel}_y{size_y}',
        [cuda_build.CSRC_DIR / 'periodic_conv2d.cu'],
        [f'PERIODIC_CONV_K={kernel}', f'PERIODIC_CONV_SIZE_Y={size_y}',
         f'PERIODIC_CONV_LO={lo}'])))
    voidp, c_int = ctypes.c_void_p, ctypes.c_int
    lib.periodic_conv2d_f32.argtypes = [voidp] * 4 + [c_int] * 7 + [voidp]
    lib.periodic_conv2d_f32.restype = c_int
    lib.periodic_conv2d_error_string.argtypes = [c_int]
    lib.periodic_conv2d_error_string.restype = ctypes.c_char_p
    return lib
