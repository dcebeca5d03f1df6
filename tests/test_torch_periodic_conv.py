"""The periodic 2-D conv kernel (models/periodic_conv2d.py,
csrc/periodic_conv2d.cu) and the rule that routes
``nn.conv2d_periodic_apply``'s calls to it.

On the CPU: the kernel's wrap rule (source row (p − lo) mod L of padded
row p, lo from ``_pad_widths_2d``), applied by a plain gather and an im2col
GEMM over the HWIO weight (the kernel's arithmetic), against the plain
route (``_wrap`` + unpadded ``F.conv2d``) in float64; the route rule's
reasons for the calls that keep the plain route; and the 2-D bottleneck's
fused ReLUs against torch.relu after the conv.

On a card (marked ``gpu``; they skip without one): the kernel against the
plain route at the main path's shapes, bit-for-bit repeats, a captured
graph's replay, shapes it does not take raising, the launch counter of a
flagship forward, and the symmetrized flagship logψ.  Tolerance rtol = atol = 1e-5 against a float64
plain route: the kernel sums up to k²·C_in = 288 f32 products of O(0.1) in
its own order.  The file imports no jax:

    python -m pytest --noconftest tests/test_torch_periodic_conv.py -q
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models import nn, periodic_conv2d
from cgs_vmc_tpu_torch.utils import profiling
from cgs_vmc_tpu_torch.utils.device import resolve_device

REPO = os.path.join(os.path.dirname(__file__), '..')
FLAGSHIP = os.path.join(REPO, 'configs', 'square66_conv_sr.json')


def _layer(rng, k, c_in, c_out, dtype=torch.float64, device='cpu'):
    w = rng.standard_normal((k, k, c_in, c_out)) / np.sqrt(k * k * c_in)
    return {'w': torch.tensor(w, dtype=dtype, device=device),
            'b': torch.tensor(0.1 * rng.standard_normal(c_out), dtype=dtype,
                              device=device)}


def _plain(params, x, relu=False):
    """The plain route, whatever the tensors: wrap padding, F.conv2d, bias."""
    w = params['w']
    lo, hi = nn._pad_widths_2d(w.shape[0])
    padded = nn._wrap(nn._wrap(x, 3, lo, hi), 2, lo, hi)
    out = F.conv2d(padded, w.permute(3, 2, 0, 1)) + params['b'][:, None, None]
    return torch.relu(out) if relu else out


# ----------------------------------------------------------------------
# CPU.
# ----------------------------------------------------------------------

@pytest.mark.parametrize('size', [(4, 4), (6, 6), (3, 5), (10, 10)])
@pytest.mark.parametrize('k', [1, 2, 3, 4])
def test_wrap_index_gather_matches_wrap_and_conv(k, size):
    rng = np.random.default_rng(k * 100 + size[0] * 10 + size[1])
    x = torch.tensor(rng.standard_normal((3, 2, *size)))
    params = _layer(rng, k, 2, 5)
    lo, hi = nn._pad_widths_2d(k)
    assert lo + hi + 1 == k
    # The kernel's rule, with the lo its build is given: padded row p reads
    # row (p - lo) mod L_x, padded column q column (q - lo) mod L_y.
    rows = (torch.arange(size[0] + k - 1) - lo) % size[0]
    cols = (torch.arange(size[1] + k - 1) - lo) % size[1]
    padded = x[:, :, rows][:, :, :, cols]
    torch.testing.assert_close(
        padded, nn._wrap(nn._wrap(x, 3, lo, hi), 2, lo, hi), rtol=0, atol=0)
    # im2col over the taps in (dx, dy, ci) order times w as [k·k·C_in,
    # C_out]: the GEMM the kernel computes.
    cols_x = torch.stack([padded[:, :, dx:dx + size[0], dy:dy + size[1]]
                          for dx in range(k) for dy in range(k)], dim=1)
    gemm = torch.einsum('btcxy,tco->boxy', cols_x,
                        params['w'].reshape(k * k, 2, 5))
    gemm = gemm + params['b'][:, None, None]
    torch.testing.assert_close(gemm, nn.conv2d_periodic_apply(params, x),
                               rtol=1e-12, atol=1e-12)


def _route_inside_vmap(x, params):
    seen = []

    def fn(xi):
        seen.append(periodic_conv2d.route(xi[None], params['w'], params['b'],
                                          1))
        return xi

    torch.func.vmap(fn)(x)
    return seen[0]


@pytest.mark.parametrize('case,reason', [
    ('cpu', 'device'), ('grad', 'grad'), ('torch.func', 'torch.func'),
    ('bfloat16', 'dtype'), ('stride2', 'stride')])
def test_route_keeps_plain_calls(case, reason):
    """Each call the kernel must not take names its reason, and its output
    is the plain route's (relu fused or not)."""
    rng = np.random.default_rng(7)
    dtype = torch.bfloat16 if case == 'bfloat16' else torch.float32
    params = _layer(rng, 3, 4, 8, dtype=dtype)
    x = torch.tensor(rng.standard_normal((2, 4, 6, 6)), dtype=dtype)
    stride = 2 if case == 'stride2' else 1
    if case == 'grad':
        params = {n: p.requires_grad_() for n, p in params.items()}
    if case == 'torch.func':
        got = _route_inside_vmap(x, params)
    else:
        got = periodic_conv2d.route(x, params['w'], params['b'], stride)
    assert got == reason
    out = nn.conv2d_periodic_apply(params, x, stride, relu=True)
    padded = nn._wrap(nn._wrap(x, 3, 1, 1), 2, 1, 1)
    ref = torch.relu(F.conv2d(padded, params['w'].permute(3, 2, 0, 1),
                              stride=stride) + params['b'][:, None, None])
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize('stride', [1, 2])
def test_bottleneck2d_fused_relu_is_relu_after_conv(stride):
    """The 2-D bottleneck passes relu=True to its first two convs; on the
    plain route that is torch.relu after the conv, bit for bit."""
    gen = torch.Generator().manual_seed(stride)
    params = nn.bottleneck2d_init(gen, 8, 3)
    for layer in params.values():
        layer['b'] = 0.1 * torch.randn(layer['b'].shape, generator=gen)
    x = torch.randn(3, 8, 6, 6, generator=gen)
    h = torch.relu(nn.conv2d_periodic_apply(params['reduce'], x))
    h = torch.relu(nn.conv2d_periodic_apply(params['conv'], h, stride))
    ref = nn.conv2d_periodic_apply(params['expand'], h) + x[:, :, ::stride,
                                                            ::stride]
    torch.testing.assert_close(nn.bottleneck2d_apply(params, x, stride), ref,
                               rtol=0, atol=0)


# ----------------------------------------------------------------------
# On a card.
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return resolve_device('cuda')


# (images, C_in, C_out, size_x, size_y, k): the flagship's sampler call
# (1,024 chains × 16 images) at its first and inner layers, square44's and
# square1010's inner layers, even k, Config's default k = 5 (weights loaded
# at their use) on 4×4, and size_y past 16.
KERNEL_SHAPES = [
    (16384, 1, 32, 6, 6, 3), (16384, 32, 32, 6, 6, 3),
    (8192, 8, 8, 4, 4, 3), (2048, 16, 16, 10, 10, 3),
    (1024, 32, 32, 6, 6, 2), (512, 8, 8, 4, 4, 4), (300, 3, 5, 3, 5, 4),
    (512, 4, 4, 4, 4, 5), (256, 4, 8, 20, 20, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize('relu', [False, True])
@pytest.mark.parametrize('shape', KERNEL_SHAPES)
def test_kernel_matches_plain_route(cuda, shape, relu):
    batch, c_in, c_out, sx, sy, k = shape
    rng = np.random.default_rng(sum(shape) + relu)
    params = _layer(rng, k, c_in, c_out, device=cuda)
    x = torch.tensor(rng.standard_normal((batch, c_in, sx, sy)),
                     device=cuda)
    ref = _plain(params, x, relu)
    x32 = x.float()
    p32 = {n: t.float() for n, t in params.items()}
    assert periodic_conv2d.route(x32, p32['w'], p32['b'], 1) is None
    profiling.reset_counters('periodic_conv.launches')
    with torch.no_grad():
        out = nn.conv2d_periodic_apply(p32, x32, relu=relu)
    torch.cuda.synchronize()
    assert profiling.counter('periodic_conv.launches') == 1
    torch.testing.assert_close(out, ref.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit(cuda):
    rng = np.random.default_rng(3)
    params = _layer(rng, 3, 32, 32, torch.float32, cuda)
    x = torch.relu(torch.randn(4096, 32, 6, 6, device=cuda))
    with torch.no_grad():
        first = nn.conv2d_periodic_apply(params, x, relu=True)
        second = nn.conv2d_periodic_apply(params, x, relu=True)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_graph_replay_equals_eager(cuda):
    rng = np.random.default_rng(4)
    params = _layer(rng, 3, 32, 32, torch.float32, cuda)
    x = torch.relu(torch.randn(2048, 32, 6, 6, device=cuda))
    with torch.no_grad():
        eager = nn.conv2d_periodic_apply(params, x, relu=True)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            nn.conv2d_periodic_apply(params, x, relu=True)   # warm-up
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            captured = nn.conv2d_periodic_apply(params, x, relu=True)
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize('shape,error', [
    ((2, 4, 300, 6, 3), 'launch failed'),     # size_x > 256
    ((2, 256, 6, 6, 3), 'launch failed'),     # weight over shared memory
    ((2, 4, 6, 6, 9), 'nvcc failed')])        # k > 8: no such build
def test_kernel_raises_on_shapes_it_does_not_take(cuda, shape, error):
    """A call the route sends to the kernel launches it or raises: no
    shape falls back to the plain route."""
    batch, channels, sx, sy, k = shape
    params = _layer(np.random.default_rng(9), k, channels, channels,
                    torch.float32, cuda)
    x = torch.randn(batch, channels, sx, sy, device=cuda)
    profiling.reset_counters('periodic_conv.launches', 'periodic_conv.plain')
    with torch.no_grad(), pytest.raises(RuntimeError, match=error):
        nn.conv2d_periodic_apply(params, x)
    assert profiling.counter('periodic_conv.launches') == 0
    assert profiling.counter('periodic_conv.plain') == 0


def _flagship(device):
    config = Config.load(FLAGSHIP)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator(device=device).manual_seed(5))
    rng = np.random.default_rng(5)
    template = np.repeat([1.0, -1.0], 18)
    configs = torch.tensor(np.stack([rng.permutation(template)
                                     for _ in range(1024)]),
                           dtype=torch.float32, device=device)
    return wf, params, configs


@pytest.mark.gpu
def test_flagship_forward_counts_five_launches(cuda):
    wf, params, configs = _flagship(cuda)
    profiling.reset_counters('periodic_conv.launches', 'periodic_conv.plain')
    with torch.no_grad():
        wf.apply(params, configs)
    assert profiling.counter('periodic_conv.launches') == 5
    assert profiling.counter('periodic_conv.plain') == 0


@pytest.mark.gpu
def test_flagship_logpsi_matches_plain_route(cuda):
    """The symmetrized 5×32 logψ of 1,024 boards by the kernel (no grad)
    against the plain route (params requiring grad)."""
    wf, params, configs = _flagship(cuda)
    with torch.no_grad():
        fast = wf.apply(params, configs)
    profiling.reset_counters('periodic_conv.plain')
    grad_params = {name: {k: t.detach().clone().requires_grad_()
                          for k, t in layer.items()}
                   for name, layer in params.items()}
    plain = wf.apply(grad_params, configs)
    assert profiling.counter('periodic_conv.plain') == 5
    torch.testing.assert_close(fast.log, plain.log.detach(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(fast.sign, plain.sign.detach())
