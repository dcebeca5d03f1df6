"""The trace arithmetic and the operation counts against hand counts."""

import math

import pytest

from benchmark.harness import check, spec, trace

BENCH = spec.load_benchmark()


def _flops(cell_name, step=None):
    c = spec.cell(cell_name, BENCH)
    return (c.config, spec.flops(c, c.config['wavefunction_type']),
            spec.flops(c, step or c.traffic['flops']))


def test_union_counts_overlaps_once():
    spans = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 41)]
    assert trace.union_seconds(spans) == 15 + 10 + 1
    assert trace.gaps(spans) == [(15, 20), (30, 40)]
    assert trace.union_seconds([]) == 0.0


def test_kernels_are_told_from_copies():
    assert trace.is_kernel('void rbm_sweep_kernel<16, 2, 10, PhiloxDraws>')
    assert not trace.is_kernel('Memcpy DtoH (Device -> Pinned)')
    assert not trace.is_kernel('Memset (Device)')


def test_rbm_counts():
    cfg, rbm, sr = _flops('chain40_rbm.train_sr')
    n, h = 40, 160
    assert rbm.params(cfg) == n * h + h + n + 1 == 6601
    assert rbm.forward(cfg) == 2 * n * h + 2 * n
    assert rbm.proposal(cfg) == 11 * h
    # 10 equilibration sweeps + 4 batches x 1 sweep, 40 proposals a
    # sweep, 2048 chains.
    assert sr.sweeps(cfg) == 14
    assert rbm.k2_ops(cfg, 14) == 11 * h * 14 * n * 2048
    m, anti = 8192, 20.0
    want = (14 * n * 2048 * 11 * h + m * 21 * (2 * n * h + 2 * n)
            + m * 2 * (2 * n * h + 2 * n)
            + 2 * m * m * 6601 + m ** 3 / 3 + 2 * m * m)
    assert sr.unit(cfg, rbm, anti) == pytest.approx(want, rel=1e-12)


def test_conv_counts():
    cfg, conv, sr = _flops('square66_conv.train_sr')
    assert conv.images(cfg) == 16
    assert conv.params(cfg) == (9 * 32 + 32) + 4 * (9 * 32 * 32 + 32)
    per_image = 2 * 9 * 1 * 32 * 36 + 4 * 2 * 9 * 32 * 32 * 36
    assert conv.forward(cfg) == 16 * per_image
    assert conv.proposal(cfg) == conv.forward(cfg)
    # 10 + 4 x 2 sweeps of 36 proposals on 1024 chains.
    assert sr.sweeps(cfg) == 18


def test_itswo_counts():
    fwd = 2 * 40 * 160 + 80
    cfg, rbm, it = _flops('chain40_rbm.train_itswo')
    assert it.unit(cfg, rbm, 10.0) == pytest.approx(
        14 * 40 * 2048 * 1760 + 8192 * 11 * fwd + 8192 * 3 * fwd)


def test_leaf_gap_rules():
    import torch
    base = {'a': torch.zeros(3), 'b': torch.zeros(2), 'c': torch.zeros(1)}
    ref = {'a': torch.tensor([3., 4., 0.]), 'b': torch.tensor([1., 0.]),
           'c': torch.tensor([1e-9])}
    prog = {'a': torch.tensor([3., 4., 0.]), 'b': torch.tensor([1.1, 0.]),
            'c': torch.tensor([5.0])}
    # 'c' moves by under a thousandth of the median leaf (1.0): left out.
    assert check.leaf_gap(prog, ref, base) == pytest.approx(0.1)
    still = {k: torch.zeros_like(v) for k, v in base.items()}
    assert check.leaf_gap(still, ref, base) == pytest.approx(1.0)
    assert check.rel_gap(1.0, math.nan) == math.inf


def test_sector_violations():
    import torch
    good = torch.tensor([[1., -1., 1., -1.]])
    bad = torch.tensor([[1., 1., 1., -1.], [1., -1., 0.5, -0.5]])
    assert check.sector_violations([good]) == 0
    assert check.sector_violations([good, bad]) == 2


def test_a_frozen_state_thaws_to_equal_tensors_and_generators():
    import collections

    import torch
    Sampler = collections.namedtuple('Sampler', 'configs generator')
    gen = torch.Generator().manual_seed(3)
    state = {'params': {'w': torch.arange(3.0)},
             'sampler': Sampler(torch.ones(2, 4), gen), 'steps': [1, 2]}
    frozen = check.freeze(state)
    assert sorted(frozen) == ['.params.w', '.sampler.configs',
                              '.sampler.generator']
    drawn = torch.rand(2, generator=gen)
    state['params']['w'].add_(1.0)
    back = check.thaw(state, frozen)
    assert torch.equal(back['params']['w'], torch.arange(3.0))
    assert back['sampler'].generator is gen and back['steps'] == [1, 2]
    assert torch.equal(torch.rand(2, generator=gen), drawn)
    assert check.mismatch(frozen, check.freeze(back)) == 1   # the generator
    again = check.thaw(back, frozen)
    assert check.mismatch(frozen, check.freeze(again)) == 0


def test_mismatch_is_bit_for_bit_and_skips_the_params():
    import torch
    a = {'.params.w': torch.zeros(2), '.x': torch.tensor([0.0, 1.0])}
    b = {'.params.w': torch.ones(2), '.x': torch.tensor([-0.0, 1.0])}
    assert check.mismatch(a, b) == 1
    assert check.mismatch(a, dict(a)) == 0
    assert check.mismatch(a, {'.params.w': a['.params.w']}) == 1
    nan = {'.x': torch.tensor([math.nan])}
    assert check.mismatch(nan, {'.x': nan['.x'].clone()}) == 0
