"""The encoder's fused linear kernel (models/encoder_linear.py,
csrc/encoder_linear.cu) and the rule that routes the transformer block's
four linears to it.

On the CPU: the plain version against the composition the transformer ran
before the kernel (LayerNorm, ``nn.linear_apply``, the tanh GELU, the
residual add, written out here) bit for bit for each of the four
instances; the route rule's reasons for the calls that keep the plain
version; and the transformer's forward on the CPU, which keeps that
composition bit for bit and launches nothing.

On a card (marked ``gpu``; they skip without one): each instance against
the plain version at a small batch, a proposal's 4,096 images and a
connected-board chunk's 147,456, bit-for-bit repeats, a captured graph's
replay, a weight that is not 16-byte aligned, calls it does not take
raising, the launch counter of the 6×6 transformer's forward, and its
symmetrized log ψ against the plain route.  Tolerance rtol = atol = 1e-5
against a float64 plain version (the kernel's K products a sum in its own
order, its LayerNorm's sums by shuffles), 2e-5 against the float32 plain
version at the chunk's size, where the float64 tensors would take ~30 GB
(both sides round).  The file imports no jax:

    python -m pytest --noconftest tests/test_torch_encoder_linear.py -q
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models import encoder_linear, nn
from cgs_vmc_tpu_torch.models.attention import SpinTransformer
from cgs_vmc_tpu_torch.models.base import tree_map
from cgs_vmc_tpu_torch.utils import profiling
from cgs_vmc_tpu_torch.utils.device import resolve_device

REPO = os.path.join(os.path.dirname(__file__), '..')
CELL_CONFIG = os.path.join(REPO, 'configs', 'square66_transformer_sr.json')
COUNTERS = ('encoder_linear.launches', 'encoder_linear.plain')
N_TOKENS = 36

# name: (K, N, LayerNorm prologue, GELU, residual): a block's linears at
# width 64, the library's instances.
VARIANTS = {'qkv': (64, 192, True, False, False),
            'attn_out': (64, 64, False, False, True),
            'mlp_in': (64, 256, True, True, False),
            'mlp_out': (256, 64, False, False, True)}


def _layernorm_before(p, x, eps=1e-5):
    """models/attention.py's LayerNorm as it was before the kernel."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return p['g'] * (x - mean) * torch.rsqrt(var + eps) + p['b']


def _composition(name, layer, x, norm, residual):
    """Each linear of `SpinTransformer.apply` before the kernel."""
    if name == 'qkv':
        return nn.linear_apply(layer, _layernorm_before(norm, x))
    if name == 'mlp_in':
        return F.gelu(nn.linear_apply(layer, _layernorm_before(norm, x)),
                      approximate='tanh')
    return residual + nn.linear_apply(layer, x)


def _inputs(name, images, seed, dtype=torch.float64, device='cpu'):
    """(layer, x, norm, gelu, residual) of instance `name` on `images`
    images of N_TOKENS tokens; weights at the init's fan-in scale, a
    LayerNorm and a bias away from their init."""
    k, n, ln, gelu, res = VARIANTS[name]
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0, shift=0.0):
        return torch.tensor(shift + scale * rng.standard_normal(shape),
                            dtype=dtype, device=device)

    layer = {'w': t((k, n), k ** -0.5), 'b': t((n,), 0.1)}
    norm = {'g': t((k,), 0.1, 1.0), 'b': t((k,), 0.1)} if ln else None
    x = t((images, N_TOKENS, k), 1.0, 0.3)
    residual = t((images, N_TOKENS, n)) if res else None
    return layer, x, norm, gelu, residual


# ----------------------------------------------------------------------
# CPU.
# ----------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_plain_is_the_composition_before_the_kernel(name, dtype):
    layer, x, norm, gelu, residual = _inputs(name, 5, 1, dtype)
    got = encoder_linear.plain(layer, x, norm, gelu, residual)
    assert torch.equal(got, _composition(name, layer, x, norm, residual))
    assert torch.equal(encoder_linear.linear(layer, x, norm, gelu, residual),
                       got)


def test_plain_refuses_gelu_and_residual_together():
    layer, x, norm, _, residual = _inputs('attn_out', 2, 2)
    with pytest.raises(ValueError, match='not both'):
        encoder_linear.plain(layer, x, norm, True, residual)


def _route_inside_vmap(layer, x, norm, gelu, residual):
    seen = []

    def fn(xi):
        seen.append(encoder_linear.route(layer, xi, norm, gelu, residual))
        return xi

    torch.func.vmap(fn)(x[None])
    return seen[0]


@pytest.mark.parametrize('case,reason', [
    ('cpu', 'device'), ('grad', 'grad'), ('torch.func', 'torch.func'),
    ('bfloat16', 'dtype'), ('width', 'shape'), ('instance', 'shape'),
    ('residual', 'shape'), ('rank', 'shape')])
def test_route_keeps_plain_calls(case, reason):
    """Each call the kernel must not take names its reason, and the
    wrapper then gives the plain version's output."""
    name = 'mlp_out' if case in ('residual', 'torch.func') else 'qkv'
    dtype = torch.bfloat16 if case == 'bfloat16' else torch.float32
    layer, x, norm, gelu, residual = _inputs(name, 3, 5, dtype)
    if case == 'grad':
        layer['w'].requires_grad_()
    elif case == 'width':
        layer = {'w': layer['w'][:, :96], 'b': layer['b'][:96]}
    elif case == 'instance':
        norm = None
    elif case == 'residual':
        residual = residual[:, :1]
    elif case == 'rank':
        x = x[0, 0]
    if case == 'torch.func':
        got = _route_inside_vmap(layer, x, norm, gelu, residual)
    else:
        got = encoder_linear.route(layer, x, norm, gelu, residual)
    assert got == reason
    if case not in ('torch.func', 'residual'):
        want = encoder_linear.plain(layer, x, norm, gelu, residual)
        assert torch.equal(
            encoder_linear.linear(layer, x, norm, gelu, residual), want)


def _apply_before_the_kernel(self, params, configs):
    """`SpinTransformer.apply` before the kernel, written out."""
    from cgs_vmc_tpu_torch.models import spin_attention
    from cgs_vmc_tpu_torch.ops import logamp
    x = configs.to(torch.float32)
    h = x[..., None] * params['spin_embed'] + params['pos_embed']
    for i in range(self.num_layers):
        block = params[f'block_{i}']
        qkv = nn.linear_apply(block['qkv'],
                              _layernorm_before(block['ln1'], h))
        h = h + nn.linear_apply(block['attn_out'],
                                spin_attention.plain(qkv, self.num_heads))
        m = F.gelu(nn.linear_apply(block['mlp_in'],
                                   _layernorm_before(block['ln2'], h)),
                   approximate='tanh')
        h = h + nn.linear_apply(block['mlp_out'], m)
    pooled = torch.mean(_layernorm_before(params['ln_f'], h), dim=-2)
    pre = nn.linear_apply(params['head'], pooled).squeeze(-1)
    return logamp.apply_activation(pre, self.output_activation)


def test_transformer_on_the_cpu_keeps_the_composition_and_launches_nothing(
        monkeypatch):
    """The cell's symmetrized transformer (width 64, the kernel's
    instances) on the CPU, with and without grad, gives the composition
    before the kernel bit for bit, and no counter of the kernel moves."""
    config = Config.load(CELL_CONFIG)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator().manual_seed(11))
    rng = np.random.default_rng(11)
    configs = torch.tensor(np.stack([rng.permutation(np.repeat([1.0, -1.0],
                                                               18))
                                     for _ in range(3)]),
                           dtype=torch.float32)
    profiling.reset_counters(*COUNTERS)
    with torch.no_grad():
        got = wf.apply(params, configs)
    got_grad = wf.apply(
        tree_map(lambda t: t.clone().requires_grad_(), params), configs)
    assert [profiling.counter(c) for c in COUNTERS] == [0, 0]
    monkeypatch.setattr(SpinTransformer, 'apply', _apply_before_the_kernel)
    with torch.no_grad():
        want = wf.apply(params, configs)
    assert torch.equal(got.log, want.log)
    assert torch.equal(got_grad.log.detach(), want.log)


# ----------------------------------------------------------------------
# On a card.
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return resolve_device('cuda')


def _f32(layer, x, norm, residual):
    def cast(t):
        return None if t is None else t.float()
    return ({k: cast(v) for k, v in layer.items()}, cast(x),
            None if norm is None else {k: cast(v) for k, v in norm.items()},
            cast(residual))


# A small batch whose last block of 256 rows is part-empty, a proposal's
# 4,096 images (256 boards × 16 images) and a connected-board chunk's
# 147,456 (9,216 boards × 16).
IMAGES = (37, 4096, 147456)


@pytest.mark.gpu
@pytest.mark.parametrize('images', IMAGES)
@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_kernel_matches_plain(cuda, name, images):
    ref_dtype = torch.float64 if images <= 4096 else torch.float32
    layer, x, norm, gelu, residual = _inputs(name, images, images, ref_dtype,
                                             cuda)
    ref = encoder_linear.plain(layer, x, norm, gelu, residual)
    layer, x, norm, residual = _f32(layer, x, norm, residual)
    assert encoder_linear.route(layer, x, norm, gelu, residual) is None
    profiling.reset_counters(*COUNTERS)
    out = encoder_linear.linear(layer, x, norm, gelu, residual)
    torch.cuda.synchronize()
    assert [profiling.counter(c) for c in COUNTERS] == [1, 0]
    tol = 1e-5 if ref_dtype == torch.float64 else 2e-5
    torch.testing.assert_close(out, ref.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_kernel_repeats_bit_for_bit(cuda, name):
    layer, x, norm, gelu, residual = _inputs(name, 4096, 3, torch.float32,
                                             cuda)
    first = encoder_linear.encoder_linear(layer, x, norm, gelu, residual)
    second = encoder_linear.encoder_linear(layer, x, norm, gelu, residual)
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_graph_replay_equals_eager(cuda, name):
    layer, x, norm, gelu, residual = _inputs(name, 2048, 4, torch.float32,
                                             cuda)

    def call():
        return encoder_linear.encoder_linear(layer, x, norm, gelu, residual)

    eager = call()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()   # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


def _offset(values, offset):
    """A contiguous copy of `values` `offset` floats into its storage."""
    out = torch.empty(values.numel() + offset, dtype=values.dtype,
                      device=values.device)[offset:].view(values.shape)
    out.copy_(values)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize('name', ['qkv', 'mlp_out'])
def test_kernel_takes_a_weight_off_16_bytes(cuda, name):
    """A weight 4 bytes off a 16-byte boundary (a view into a flat
    parameter vector) is copied by 4-byte cp.async: the same output."""
    layer, x, norm, gelu, residual = _inputs(name, 301, 6, torch.float32,
                                             cuda)
    aligned = encoder_linear.encoder_linear(layer, x, norm, gelu, residual)
    layer = {'w': _offset(layer['w'], 1), 'b': _offset(layer['b'], 3)}
    assert layer['w'].data_ptr() % 16 == 4
    assert torch.equal(
        encoder_linear.encoder_linear(layer, x, norm, gelu, residual),
        aligned)


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['instance', 'width', 'x_offset',
                                  'residual_offset'])
def test_kernel_raises_on_calls_it_does_not_take(cuda, case):
    """A call sent to the kernel launches it or raises: nothing falls back
    to the plain version."""
    name = 'attn_out' if case == 'residual_offset' else 'qkv'
    layer, x, norm, gelu, residual = _inputs(name, 9, 9, torch.float32,
                                             cuda)
    if case == 'instance':
        norm = None                               # no (64, 192, none, none)
    elif case == 'width':
        layer = {'w': layer['w'][:, :128].contiguous(),
                 'b': layer['b'][:128]}           # no 64 -> 128
    elif case == 'x_offset':
        x = _offset(x, 1)
    else:
        residual = _offset(residual, 2)
    profiling.reset_counters(*COUNTERS)
    with pytest.raises(RuntimeError, match='launch failed'):
        encoder_linear.encoder_linear(layer, x, norm, gelu, residual)
    assert profiling.counter('encoder_linear.launches') == 0


def _cell_model(device, boards=256):
    config = Config.load(CELL_CONFIG)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator(device=device).manual_seed(5))
    rng = np.random.default_rng(5)
    template = np.repeat([1.0, -1.0], 18)
    configs = torch.tensor(np.stack([rng.permutation(template)
                                     for _ in range(boards)]),
                           dtype=torch.float32, device=device)
    return config, wf, params, configs


@pytest.mark.gpu
def test_cell_forward_counts_four_launches_a_layer(cuda):
    config, wf, params, configs = _cell_model(cuda)
    profiling.reset_counters(*COUNTERS)
    with torch.no_grad():
        wf.apply(params, configs)
    assert profiling.counter('encoder_linear.launches') == \
        4 * config.num_attention_layers
    assert profiling.counter('encoder_linear.plain') == 0


@pytest.mark.gpu
def test_cell_logpsi_matches_plain_route(cuda):
    """The symmetrized 6×6 transformer's log ψ of 256 boards by the kernels
    (no grad) against the plain route (params requiring grad)."""
    config, wf, params, configs = _cell_model(cuda)
    with torch.no_grad():
        fast = wf.apply(params, configs)
    profiling.reset_counters(*COUNTERS)
    plain = wf.apply(
        tree_map(lambda t: t.detach().clone().requires_grad_(), params),
        configs)
    assert profiling.counter('encoder_linear.plain') == \
        4 * config.num_attention_layers
    assert profiling.counter('encoder_linear.launches') == 0
    torch.testing.assert_close(fast.log, plain.log.detach(), rtol=1e-5,
                               atol=1e-5)
