"""Per-sample Jacobian rows of (symmetrized) conv ansatzes as batched GEMMs
(port of cgs_vmc_tpu/optim/fast_jacobian.py).

SR's generic rows (``optim/sr.py::jacobian_rows``) take vmap(grad) of a
batch-1 forward; on the card the per-sample conv weight gradient then runs
through cuDNN's grouped weight-gradient path.  This module writes the same
network as periodic padding + im2col patches + matmuls with a per-sample
copy of every weight: each conv becomes one ``torch.bmm`` of [c, rows,
k·k·ci] patches by [c, k·k·ci, co] weights, and one backward pass with a
ones cotangent gives every sample's weight gradient as the transposed
batched GEMM (dW_c = cols_cᵀ·δ_c, db_c = Σ δ_c).  The numerics are the
generic path's: the same wrap padding (``models/nn.py::_wrap``), the same
activations and signed-logsumexp orbit average (``ops/logamp.py``), the
same dtype casts.  Params keep the JAX layouts (HWIO / WIO), so the
(kh, kw, ci) im2col order matches ``w.reshape(k·k·ci, co)`` as it is.
Rows come back in ``optim/sr.py::flatten_params`` order.

Supported: Conv1DNetwork, Conv2DNetwork, ResNet1D and ResNet2D (plain and
bottleneck blocks) at stride 1, each optionally inside
SymmetrizedWavefunction (site orbit × spin flip), and the masked-conv
autoregressive model (zero padding, the sector-projected chain-rule head).
``rows_fn_for`` returns None for anything else, and SR takes the vmap rows.

SR uses these rows when ``config.sr_fast_jacobian`` is set (default off, as
in the JAX package, whose TPU measurement found them slower than its
vmap rows inside the epoch); the card's times both ways are in PERF.md
(chip_smoke.py phase 37).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from cgs_vmc_tpu_torch.models import nn
from cgs_vmc_tpu_torch.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_tpu_torch.models.base import tree_leaves, tree_unflatten
from cgs_vmc_tpu_torch.models.conv import (Conv1DNetwork, Conv2DNetwork,
                                           ResNet1D, ResNet2D)
from cgs_vmc_tpu_torch.models.pixelcnn import MaskedConv2DAutoregressive
from cgs_vmc_tpu_torch.models.symmetry import SymmetrizedWavefunction
from cgs_vmc_tpu_torch.ops import logamp


def _slabs_2d(padded: torch.Tensor, kernel: int, h: int, w: int
              ) -> torch.Tensor:
    return torch.cat([padded[:, dh:dh + h, dw:dw + w, :]
                      for dh in range(kernel) for dw in range(kernel)],
                     dim=-1)


def _patches_2d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Periodic padding + im2col.  x: [N, H, W, C] channels-last ->
    [N, H, W, k·k·C] in the (kh, kw, ci) order of an HWIO kernel reshaped
    to [k·k·ci, co]."""
    lo, hi = nn._pad_widths_2d(kernel)
    padded = nn._wrap(nn._wrap(x, 2, lo, hi), 1, lo, hi)
    return _slabs_2d(padded, kernel, x.shape[1], x.shape[2])


def _patches_2d_zero(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Zero padding (odd kernel, 'SAME') + im2col in the same order: the
    causal conv's counterpart of `_patches_2d` (a wrap would leak
    raster-future sites)."""
    half = kernel // 2
    padded = F.pad(x, (0, 0, half, half, half, half))
    return _slabs_2d(padded, kernel, x.shape[1], x.shape[2])


def _patches_1d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Periodic padding + im2col, 1-D.  x: [N, L, C] -> [N, L, k·C] in the
    (k, ci) order of a WIO kernel reshaped to [k·ci, co]."""
    padded = nn._wrap(x, 1, *nn._pad_widths_1d(kernel))
    length = x.shape[1]
    return torch.cat([padded[:, d:d + length, :] for d in range(kernel)],
                     dim=-1)


def _orbit_of(configs: torch.Tensor, perms: Optional[torch.Tensor],
              spin_flip: bool) -> torch.Tensor:
    """[c, n_sites] -> [c, n_ops, n_sites]: the symmetry orbit (or the
    configs alone)."""
    if perms is None:
        return configs[:, None, :]
    orbit = configs[:, perms]
    return torch.cat([orbit, -orbit], dim=1) if spin_flip else orbit


def _symmetrized_head(pre: torch.Tensor, output_activation: str
                      ) -> torch.Tensor:
    """[c, n_ops] pre-activations -> log|ψ| [c]: the signed-logsumexp
    orbit average of SymmetrizedWavefunction.apply."""
    n_ops = pre.shape[-1]
    amp = logamp.apply_activation(pre, output_activation)
    if n_ops == 1:
        return amp.log[:, 0]
    avg = logamp.sum_terms(amp.sign, amp.log, axis=-1)
    return avg.log - math.log(float(n_ops))


def _ps_conv(patches_fn: Callable, layer: dict, h: torch.Tensor, c: int,
             dtype=torch.float32, mask=None) -> torch.Tensor:
    """Stride-1 conv with a per-sample weight copy, as one batched GEMM.

    layer['w']: [c, *kernel_dims, cin, cout] (a leading per-sample axis),
    layer['b']: [c, cout]; h: [c·n, *spatial, cin] channels-last.  `mask`,
    [k·k·cin, cout], multiplies the reshaped weights (the masked conv)."""
    w, b = layer['w'], layer['b']
    x = patches_fn(h, w.shape[1])
    cols = x.reshape(c, -1, x.shape[-1])
    w2 = w.reshape(c, -1, w.shape[-1]).to(dtype)
    if mask is not None:
        w2 = w2 * mask
    out = torch.bmm(cols, w2) + b.to(dtype)[:, None, :]
    return out.reshape(*h.shape[:-1], w.shape[-1])


def _channels_last_input(base, orbit: torch.Tensor, two_d: bool
                         ) -> torch.Tensor:
    c, n_ops = orbit.shape[0], orbit.shape[1]
    if two_d:
        return orbit.reshape(c * n_ops, base.size_x, base.size_y, 1)
    return orbit.reshape(c * n_ops, orbit.shape[-1], 1)


def _conv_forward_per_sample(base, ps, orbit: torch.Tensor, two_d: bool
                             ) -> torch.Tensor:
    """log|ψ| [c] of Conv1DNetwork / Conv2DNetwork with per-sample weights
    (their apply term for term: dtype casts, activations, the f32 sum, the
    orbit average)."""
    c, n_ops = orbit.shape[0], orbit.shape[1]
    act = logamp.ACTIVATIONS[base.nonlinearity]
    dtype = base.compute_dtype
    patches_fn = _patches_2d if two_d else _patches_1d
    h = _channels_last_input(base, orbit, two_d).to(dtype)
    for i in range(base.num_layers):
        h = _ps_conv(patches_fn, ps[f'conv_{i}'], h, c, dtype)
        if i + 1 != base.num_layers:
            h = act(h).to(dtype)
    pre = torch.sum(h.to(torch.float32),
                    dim=tuple(range(1, h.dim()))).reshape(c, n_ops)
    return _symmetrized_head(pre, base.output_activation)


def _resnet_forward_per_sample(base, ps, orbit: torch.Tensor, two_d: bool
                               ) -> torch.Tensor:
    """log|ψ| [c] of ResNet1D / ResNet2D at stride 1 with per-sample
    weights: the stem conv, then selu two-conv residual blocks or relu
    1-k-1 bottleneck blocks with identity shortcuts, f32 throughout."""
    c, n_ops = orbit.shape[0], orbit.shape[1]
    patches_fn = _patches_2d if two_d else _patches_1d
    h = _channels_last_input(base, orbit, two_d).to(torch.float32)
    h = _ps_conv(patches_fn, ps['stem'], h, c)
    for i in range(base.num_blocks):
        bp = ps[f'block_{i}']
        if base.bottleneck:
            t = torch.relu(_ps_conv(patches_fn, bp['reduce'], h, c))
            t = torch.relu(_ps_conv(patches_fn, bp['conv'], t, c))
            t = _ps_conv(patches_fn, bp['expand'], t, c)
        else:
            t = F.selu(_ps_conv(patches_fn, bp['conv1'], h, c))
            t = _ps_conv(patches_fn, bp['conv2'], t, c)
        h = t + h
    pre = torch.sum(h, dim=tuple(range(1, h.dim()))).reshape(c, n_ops)
    return _symmetrized_head(pre, base.output_activation)


def _pixelcnn_forward_per_sample(model: MaskedConv2DAutoregressive,
                                 masks, ps, configs: torch.Tensor
                                 ) -> torch.Tensor:
    """log|ψ| [c] of the masked-conv autoregressive model with per-sample
    weights: its `_logits` (zero padding, the activation between layers,
    f32) and the sector-projected chain rule, term for term."""
    c = configs.shape[0]
    act = logamp.ACTIVATIONS[model.nonlinearity]
    h = configs.to(torch.float32).reshape(c, model.size_x, model.size_y, 1)
    last = len(masks) - 1
    for i, mask in enumerate(masks):
        h = _ps_conv(_patches_2d_zero, ps[f'conv_{i}'], h, c, mask=mask)
        if i != last:
            h = act(h)
    log_p = AutoregressiveSpinModel.conditional_log_p_from_logits(
        h.reshape(c, model.num_sites), configs)
    return 0.5 * torch.sum(log_p, dim=-1)


def _tree_rows(forward_fn: Callable) -> Callable:
    """one_chunk(params, configs) -> [c, P] rows from a forward with
    per-sample params.

    forward_fn(ps, configs) -> log|ψ| [c], ps the params' tree with a
    leading per-sample axis on every leaf.  Each copy is a leaf of its own,
    so one backward pass with a ones cotangent gives each sample's
    gradient (a gradient through `expand` would sum over the copies); the
    rows concatenate the leaves in tree_leaves order."""
    def one_chunk(params, configs):
        c = configs.shape[0]
        copies = [leaf.detach().expand(c, *leaf.shape).contiguous()
                  .requires_grad_() for leaf in tree_leaves(params)]
        with torch.enable_grad():
            out = forward_fn(tree_unflatten(params, copies), configs)
            grads = torch.autograd.grad(out, copies,
                                        grad_outputs=torch.ones_like(out))
        return torch.cat([g.reshape(c, -1).to(torch.float32)
                          for g in grads], dim=1)
    return one_chunk


def _chunked(one_chunk: Callable) -> Callable:
    """rows(params, configs, chunk): `chunk` samples at a time when chunk
    > 0, the last chunk padded with the first config and the padding's
    rows dropped."""
    def rows(params, configs, chunk: int) -> torch.Tensor:
        batch = configs.shape[0]
        if not chunk or batch <= chunk:
            return one_chunk(params, configs)
        pad = -batch % chunk
        if pad:
            configs = torch.cat([configs, configs[:1].expand(pad, -1)])
        return torch.cat([one_chunk(params, part)
                          for part in configs.split(chunk)])[:batch]
    return rows


def rows_fn_for(wf) -> Optional[Callable]:
    """The fast per-sample Jacobian of `wf`, or None if unsupported.

    Returns fn(params, configs, chunk) -> [batch, P] f32 rows of ∂log|ψ|
    in flatten_params order, on the configs' device.  Supported: the
    (symmetrized) conv_1d / conv_2d and res_net_1d / res_net_2d ansatzes at
    stride 1, and the masked-conv autoregressive model."""
    if isinstance(wf, MaskedConv2DAutoregressive):
        def pixelcnn_fwd(ps, configs):
            # The model's masks on the device, copied there once (a copy
            # from the host a call would stop a CUDA graph capture).
            masks = [m.reshape(-1, m.shape[-1])
                     for m in wf._masks_on(configs.device)]
            return _pixelcnn_forward_per_sample(wf, masks, ps, configs)
        return _chunked(_tree_rows(pixelcnn_fwd))
    symmetrized = isinstance(wf, SymmetrizedWavefunction)
    base = wf._wf if symmetrized else wf

    def orbit(configs):
        if not symmetrized:
            return _orbit_of(configs, None, False)
        return _orbit_of(configs, wf._device_perms(configs.device),
                         wf.spin_flip)

    out_act = getattr(base, 'output_activation', None)
    if out_act not in logamp.ACTIVATIONS:
        return None
    if isinstance(base, (Conv1DNetwork, Conv2DNetwork)):
        two_d = isinstance(base, Conv2DNetwork)
        return _chunked(_tree_rows(
            lambda ps, configs: _conv_forward_per_sample(
                base, ps, orbit(configs), two_d)))
    if isinstance(base, (ResNet1D, ResNet2D)):
        if base.conv_stride != 1:
            return None                 # a strided shortcut: vmap rows
        two_d = isinstance(base, ResNet2D)
        return _chunked(_tree_rows(
            lambda ps, configs: _resnet_forward_per_sample(
                base, ps, orbit(configs), two_d)))
    return None
