"""The attention kernel (models/spin_attention.py, csrc/spin_attention.cu)
and the rule that routes ``SpinTransformer._attention``'s calls to it.

On the CPU: the plain version's layout contract (q, k, v read from the qkv
projection's [B, n, 3·d] output as 3 × heads × d_h, the output written as
h·d_h + j) against a per-head loop in float64; the route rule's reasons for
the calls that keep the plain version; and the transformer's forward on the
CPU, which keeps the einsums bit for bit and launches nothing.

On a card (marked ``gpu``; they skip without one): the kernel against the
plain version, bit-for-bit repeats, a captured graph's replay, shapes it
does not take raising, the launch counter of the 6×6 transformer's forward,
and its symmetrized log ψ against the plain route.  Tolerance rtol = atol =
1e-5 against a float64 plain version: the kernel sums d_h f32 products a
score and n weighted values an output, each in its own order, and its
softmax's sum in another order than torch's warp reduction.  The file
imports no jax:

    python -m pytest --noconftest tests/test_torch_attention_kernel.py -q
"""

import math
import os

import numpy as np
import pytest
import torch

from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models import nn, spin_attention
from cgs_vmc_tpu_torch.models.attention import SpinTransformer
from cgs_vmc_tpu_torch.models.encoder_linear import layernorm
from cgs_vmc_tpu_torch.models.base import tree_map
from cgs_vmc_tpu_torch.utils import profiling
from cgs_vmc_tpu_torch.utils.device import resolve_device

REPO = os.path.join(os.path.dirname(__file__), '..')
CELL_CONFIG = os.path.join(REPO, 'configs', 'square66_transformer_sr.json')
COUNTERS = ('attention.launches', 'attention.plain')


def _qkv(rng, batch, n, heads, dh, dtype=torch.float64, device='cpu'):
    return torch.tensor(rng.standard_normal((batch, n, 3 * heads * dh)),
                        dtype=dtype, device=device)


def _per_head(qkv, heads):
    """softmax(q kᵀ / √d_h) v by explicit indexing, one head at a time."""
    batch, n, width = qkv.shape
    d = width // 3
    dh = d // heads
    out = torch.empty(batch, n, d, dtype=qkv.dtype)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        q = qkv[:, :, cols]
        k = qkv[:, :, d:][:, :, cols]
        v = qkv[:, :, 2 * d:][:, :, cols]
        p = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(dh), dim=-1)
        out[:, :, cols] = p @ v
    return out


# ----------------------------------------------------------------------
# CPU.
# ----------------------------------------------------------------------

@pytest.mark.parametrize('shape', [(3, 36, 8, 8), (2, 16, 4, 8),
                                   (5, 5, 3, 4), (2, 64, 2, 16)])
def test_plain_reads_the_qkv_layout(shape):
    """The layout the kernel implements: token row q | k | v, each heads ×
    d_h; output column h·d_h + j."""
    batch, n, heads, dh = shape
    qkv = _qkv(np.random.default_rng(sum(shape)), batch, n, heads, dh)
    torch.testing.assert_close(spin_attention.plain(qkv, heads),
                               _per_head(qkv, heads), rtol=1e-12, atol=1e-12)


def _route_inside_vmap(qkv, heads):
    seen = []

    def fn(xi):
        seen.append(spin_attention.route(xi, heads))
        return xi

    torch.func.vmap(fn)(qkv[None])
    return seen[0]


@pytest.mark.parametrize('case,reason', [
    ('cpu', 'device'), ('grad', 'grad'), ('torch.func', 'torch.func'),
    ('bfloat16', 'dtype'), ('tokens', 'shape'), ('head_dim', 'shape'),
    ('rank', 'shape')])
def test_route_keeps_plain_calls(case, reason):
    """Each call the kernel must not take names its reason, and the
    transformer's attention sub-block (with its residual) then gives the
    plain version's output."""
    rng = np.random.default_rng(7)
    dtype = torch.bfloat16 if case == 'bfloat16' else torch.float32
    n = 65 if case == 'tokens' else 16
    heads, dh = (2, 2) if case == 'head_dim' else (4, 8)
    qkv = _qkv(rng, 3, n, heads, dh, dtype)
    if case == 'grad':
        qkv.requires_grad_()
    if case == 'torch.func':
        got = _route_inside_vmap(qkv, heads)
    elif case == 'rank':
        got = spin_attention.route(qkv[0], heads)
    else:
        got = spin_attention.route(qkv, heads)
    assert got == reason

    d = heads * dh
    wf = SpinTransformer(n, num_layers=1, model_dim=d, num_heads=heads)
    block = wf.init(torch.Generator().manual_seed(3))['block_0']
    block = {name: {k: t.to(dtype) for k, t in layer.items()}
             for name, layer in block.items()}
    h = torch.tensor(rng.standard_normal((3, n, d)), dtype=dtype)
    qkv_h = nn.linear_apply(block['qkv'], layernorm(block['ln1'], h))
    want = h + nn.linear_apply(block['attn_out'],
                               spin_attention.plain(qkv_h, heads))
    torch.testing.assert_close(wf._attention(block, h), want, rtol=0,
                               atol=0)


def test_transformer_on_the_cpu_keeps_the_einsums_and_launches_nothing(
        monkeypatch):
    """The 4×4 test model's symmetrized log ψ on the CPU, with and without
    grad, is the einsum route's bit for bit (the route before the kernel,
    written out here), and no counter of the kernel moves."""
    config = Config(num_sites=16, size_x=4, size_y=4,
                    wavefunction_type='transformer', num_attention_layers=2,
                    attention_dim=32, num_attention_heads=4, symmetrize=True)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator().manual_seed(11))
    rng = np.random.default_rng(11)
    configs = torch.tensor(np.stack([rng.permutation(np.repeat([1.0, -1.0],
                                                               8))
                                     for _ in range(6)]), dtype=torch.float32)

    def einsum_attention(self, block, h):
        batch, n, d = h.shape
        nh, dh = self.num_heads, d // self.num_heads
        qkv = nn.linear_apply(block['qkv'], layernorm(block['ln1'], h))
        q, k, v = qkv.reshape(batch, n, 3, nh, dh).unbind(dim=2)
        attn = torch.softmax(
            torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(dh), dim=-1)
        out = torch.einsum('bhqk,bkhd->bqhd', attn, v)
        return h + nn.linear_apply(block['attn_out'],
                                   out.reshape(batch, n, d))

    profiling.reset_counters(*COUNTERS)
    with torch.no_grad():
        got = wf.apply(params, configs)
    got_grad = wf.apply(
        tree_map(lambda t: t.clone().requires_grad_(), params), configs)
    assert [profiling.counter(c) for c in COUNTERS] == [0, 0]
    monkeypatch.setattr(SpinTransformer, '_attention', einsum_attention)
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


# (images, n, heads, d_h): the 6×6 transformer's proposal call (256 boards
# × 16 images) and an odd batch of it, the 4×4 test models' shape at a
# batch that leaves its last block of 4 images part-empty, and the other
# head widths at the most tokens.
KERNEL_SHAPES = [(4096, 36, 8, 8), (37, 36, 8, 8), (1023, 16, 4, 8),
                 (301, 64, 2, 16), (77, 64, 3, 4), (9, 5, 3, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize('shape', KERNEL_SHAPES)
def test_kernel_matches_plain(cuda, shape):
    batch, n, heads, dh = shape
    qkv = _qkv(np.random.default_rng(sum(shape)), batch, n, heads, dh,
               device=cuda)
    ref = spin_attention.plain(qkv, heads)
    qkv32 = qkv.float()
    assert spin_attention.route(qkv32, heads) is None
    profiling.reset_counters(*COUNTERS)
    out = spin_attention.spin_attention(qkv32, heads)
    torch.cuda.synchronize()
    assert profiling.counter('attention.launches') == 1
    torch.testing.assert_close(out, ref.float(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_repeats_bit_for_bit(cuda):
    qkv = _qkv(np.random.default_rng(3), 4096, 36, 8, 8, torch.float32,
               cuda)
    first = spin_attention.spin_attention(qkv, 8)
    second = spin_attention.spin_attention(qkv, 8)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_graph_replay_equals_eager(cuda):
    qkv = _qkv(np.random.default_rng(4), 2048, 36, 8, 8, torch.float32,
               cuda)
    eager = spin_attention.spin_attention(qkv, 8)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        spin_attention.spin_attention(qkv, 8)   # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        captured = spin_attention.spin_attention(qkv, 8)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize('shape,offset,error', [
    ((2, 65, 2, 8), 0, 'nvcc failed'),       # n > 64: no such build
    ((2, 16, 4, 2), 0, 'nvcc failed'),       # d_h 2: no such build
    ((2, 64, 20, 16), 0, 'launch failed'),   # a slab over the shared memory
    ((2, 36, 8, 8), 1, 'launch failed')])    # qkv not 16-byte aligned
def test_kernel_raises_on_shapes_it_does_not_take(cuda, shape, offset,
                                                  error):
    """A call sent to the kernel launches it or raises: nothing falls back
    to the plain version."""
    batch, n, heads, dh = shape
    values = _qkv(np.random.default_rng(9), batch, n, heads, dh,
                  torch.float32, cuda)
    # A contiguous view `offset` floats into its storage.
    qkv = torch.empty(values.numel() + offset, device=cuda)[offset:].view(
        values.shape)
    qkv.copy_(values)
    profiling.reset_counters(*COUNTERS)
    with pytest.raises(RuntimeError, match=error):
        spin_attention.spin_attention(qkv, heads)
    assert profiling.counter('attention.launches') == 0


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
def test_cell_forward_counts_a_launch_a_layer(cuda):
    config, wf, params, configs = _cell_model(cuda)
    profiling.reset_counters(*COUNTERS)
    with torch.no_grad():
        wf.apply(params, configs)
    assert profiling.counter('attention.launches') == \
        config.num_attention_layers
    assert profiling.counter('attention.plain') == 0


@pytest.mark.gpu
def test_cell_logpsi_matches_plain_route(cuda):
    """The symmetrized 6×6 transformer's log ψ of 256 boards by the kernel
    (no grad) against the plain route (params requiring grad)."""
    config, wf, params, configs = _cell_model(cuda)
    with torch.no_grad():
        fast = wf.apply(params, configs)
    profiling.reset_counters(*COUNTERS)
    plain = wf.apply(
        tree_map(lambda t: t.detach().clone().requires_grad_(), params),
        configs)
    assert profiling.counter('attention.plain') == \
        config.num_attention_layers
    assert profiling.counter('attention.launches') == 0
    torch.testing.assert_close(fast.log, plain.log.detach(), rtol=1e-5,
                               atol=1e-5)
