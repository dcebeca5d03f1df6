"""The 6×6 self-attention wavefunction as the benchmark runs it
(`square66_transformer.train_sr`), on the CPU: the port's symmetrized log ψ
and one SR step against the benchmark's plain reference
(benchmark/reference/, which imports nothing of the port), the SR rows in
blocks against one block and the choice of the block, the counters
`encoder.images` and `sr.row_blocks` against the traffic's arithmetic
over replays of the static-buffer body (``replay='plain'``, what a CUDA
graph captures), the encoder's spans, the operation counts and the cell's
harness end to end at a tiny size.

Weights are the port's init from a seed, every leaf then moved by seeded
noise (so that the LayerNorm gains and biases and every bias count).
log ψ agrees to rtol 1e-5: the same float32 equations, with sums in
another order (the reference's orbit by rot90 and transposes, its own
einsums and LayerNorm).
"""

import json
import math
import time

import pytest
import torch

from benchmark import run as run_py
from benchmark.harness import check, spec
from benchmark.reference import lattice as ref_lattice
from benchmark.reference import steps
from benchmark.reference.ansatz import transformer as ref_transformer
from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.optim import sr as sr_lib
from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import profiling

BENCH = spec.load_benchmark()
CELL = 'square66_transformer.train_sr'
PUBLISHED = spec.cell(CELL, BENCH).config
SMALL = dict(num_sites=16, size_x=4, size_y=4, attention_dim=16,
             num_attention_heads=2, num_attention_layers=2)
TINY = dict(SMALL, batch_size=8, energy_chunk_samples=8,
            num_equilibration_sweeps=1, num_monte_carlo_sweeps=1)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """These tensors are small: with several test workers on one machine,
    torch's intra-op thread pools only fight each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _values(**fields):
    values = dict(PUBLISHED)
    values.update(fields)
    return values


def _config(values) -> Config:
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in values.items()})


def _params(wf, seed):
    """The port's init, every leaf moved by noise of 0.5 from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    params = wf.init(gen)
    noise = torch.Generator().manual_seed(seed + 1)

    def move(tree):
        return {k: move(v) if isinstance(v, dict)
                else v + 0.5 * torch.randn(v.shape, generator=noise)
                for k, v in tree.items()}
    return move(params)


def _boards(n_sites, count, seed):
    gen = torch.Generator().manual_seed(seed)
    template = torch.tensor([1.0, -1.0]).repeat(n_sites // 2)
    return torch.stack([template[torch.randperm(n_sites, generator=gen)]
                        for _ in range(count)])


@pytest.mark.parametrize('fields,count', [(SMALL, 32), ({}, 8)],
                         ids=['4x4-d16-2heads-2layers', 'published-6x6'])
def test_log_psi_equals_the_plain_reference(fields, count):
    values = _values(**fields)
    wf = models.build_wavefunction(_config(values))
    params = _params(wf, 3)
    boards = _boards(values['num_sites'], count, 4)
    with torch.no_grad():
        port = wf.apply(params, boards)
        ref = ref_transformer.build(values)(check.flat_params(params), boards)
    assert torch.equal(port.sign, torch.ones_like(port.sign))
    assert float(port.log.std()) > 0.1        # the boards differ in ψ
    torch.testing.assert_close(port.log, ref, rtol=1e-5, atol=1e-6)


def test_sr_step_equals_the_reference_sr_epoch():
    """One dense minSR step from the same params and boards: every leaf's
    change within 1e-3 of the reference's (the harness's leaf gap, the
    same f32 rows and solve in another order), and the same energy."""
    values = _values(**TINY)
    config = _config(values)
    opt = StochasticReconfiguration(models.build_wavefunction(config),
                                    build_hamiltonian(config), config)
    params = _params(opt.wf, 5)
    positions = [_boards(16, 8, 6 + b) for b in range(4)]
    boards = torch.cat(positions)
    opt_state = opt.sgd.init(params)
    with torch.no_grad():
        e_loc = opt.hamiltonian.local_value(opt.wf, params, boards)
    new, _, _, _ = opt.update_from_samples(params, opt_state,
                                           torch.tensor(0), boards, e_loc)
    side = steps.Sides(values, ref_lattice.bonds(values), 1024)
    base = check.flat_params(params)
    ref, metrics, _ = steps.sr_epoch(side, base, 0, positions, {})
    assert check.leaf_gap(check.flat_params(new), ref, base) < 1e-3
    assert check.rel_gap(float(e_loc.mean()), metrics['energy']) < 1e-6


def _rows_fn(values):
    wf = models.build_wavefunction(_config(values))
    flat, unflatten = sr_lib.flatten_params(_params(wf, 7))

    def single_log(p_flat, board):
        return wf.apply(unflatten(p_flat), board[None, :]).log[0]
    return single_log, flat


def test_rows_in_blocks_equal_one_block_and_are_counted():
    fn, flat = _rows_fn(_values(**SMALL))
    boards = _boards(16, 10, 8)
    profiling.reset_counters('sr.row_blocks', 'encoder.images')
    whole = sr_lib.jacobian_rows(fn, flat, boards, 0)
    assert profiling.counter('sr.row_blocks') == 1
    assert profiling.counter('encoder.images') == 10 * 16
    blocks = sr_lib.jacobian_rows(fn, flat, boards, 4)
    assert profiling.counter('sr.row_blocks') == 1 + 3
    assert profiling.counter('encoder.images') == 2 * 10 * 16
    assert whole.shape == blocks.shape == (10, flat.numel())
    torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-7)
    # A set chunk is obeyed as vmap's own chunks are: the same numbers.
    chunked = torch.func.vmap(torch.func.grad(fn), in_dims=(None, 0),
                              chunk_size=4)(flat, boards)
    assert torch.equal(blocks, chunked)


GIB = 2.0 ** 30


def _probe(fixed, per_board, seen):
    def probe(b):
        seen.append(b)
        return fixed + per_board * b
    return probe


def test_choose_row_block_takes_one_block_where_all_rows_fit():
    """A quarter of an 80 GB card's free memory: the flagship conv's 4,096
    rows (~1.5 MB a board beside a 1 GiB fixed workspace, which the probes,
    doubling from 16 boards, amortize) and the RBM's 8,192 small rows at
    the first probe, each one block."""
    budget = 0.25 * 79 * GIB
    seen = []
    assert sr_lib.choose_row_block(4096, _probe(GIB, 1.5e6, seen),
                                   4 * 37_216, budget) == 4096
    assert seen[0] == 16 and all(b == 2 * a for a, b in zip(seen, seen[1:]))
    seen.clear()
    assert sr_lib.choose_row_block(8192, _probe(0.0, 30e3, seen), 26404,
                                   budget) == 8192
    assert seen == [16]


@pytest.mark.parametrize('m', [1024, 4096])
def test_choose_row_block_cuts_equal_blocks_that_fit(m):
    """The transformer at the published widths (P = 202,497, ~37.6 MB a
    board): the cell's 1,024 boards and the shipped file's 4,096 in equal
    blocks, each with the whole Jacobian twice beside it within the
    budget; the probes double while twice the probe fits."""
    seen = []
    row = 4 * 202497
    budget = 0.25 * 79 * GIB
    block = sr_lib.choose_row_block(m, _probe(0.3 * GIB, 37.6e6, seen),
                                    row, budget)
    count = math.ceil(m / block)
    assert count > 1 and math.ceil(m / count) == block
    per_board = (0.3 * GIB + 37.6e6 * seen[-1]) / seen[-1]
    assert block * per_board + 2 * m * row <= budget
    assert seen[0] == 16 and all(b == 2 * a for a, b in zip(seen, seen[1:]))
    assert 2 * seen[-1] > block
    with pytest.raises(RuntimeError, match='do not fit'):
        sr_lib.choose_row_block(m, _probe(0.0, 50 * GIB, []), row, budget)


def test_peak_probe_reads_the_largest_allocation(monkeypatch):
    """The probe's dispatch mode reads the allocator after every
    operation, and leaves no count behind."""
    reads = iter(range(100, 10 ** 6, 7))
    monkeypatch.setattr(torch.cuda, 'memory_allocated',
                        lambda device=None: next(reads))
    fn, flat = _rows_fn(_values(**SMALL))
    before = profiling.counters()
    peak = sr_lib._row_peak_bytes(fn, flat, _boards(16, 2, 9))
    assert peak > 7 * 10 and peak % 7 == 0
    assert profiling.counters() == before


class _Counts:
    """A logger that keeps the counters at each epoch's end."""

    def __init__(self):
        self.rows = []

    def log(self, epoch, metrics):
        del metrics
        self.rows.append({n: profiling.counter(n)
                          for n in ('encoder.images', 'sr.row_blocks')})


def test_encoder_images_an_epoch_are_the_traffics_arithmetic():
    """Three epochs: the eager warm-up, then two calls of the static-buffer
    body.  An epoch's images are 16 a board of the amplitude refresh
    (chains), the proposals ((equilibration + batches × sweeps) × N ×
    chains), the boards, their 2N connected boards (every bond, masked)
    and the rows' forward (M); one block of rows an epoch."""
    values = _values(**TINY, num_epochs=3)
    logger = _Counts()
    train(_config(values), 'cpu', logger=logger, replay='plain')
    chains, m, n = 8, 32, 16
    boards = chains * (1 + (1 + 4 * 1) * n) + m * (1 + 2 * n + 1)
    steps_ = [{k: b[k] - a[k] for k in a}
              for a, b in zip(logger.rows, logger.rows[1:])]
    assert steps_ == [{'encoder.images': 16 * boards,
                       'sr.row_blocks': 1}] * 2


def test_spans_on_time_the_encoders_branches():
    values = _values(**TINY, num_epochs=2)
    profiling.reset()
    profiling.spans(True)
    try:
        train(_config(values), 'cpu', replay='plain')
    finally:
        profiling.spans(False)
    report = profiling.span_report()
    names = {s['name'] for s in report['spans']}
    assert {'attention', 'mlp'} <= names
    layers = values['num_attention_layers']
    for s in report['spans']:
        if s['name'] in ('attention', 'mlp'):
            parent = next(p for p in report['spans']
                          if p['id'] == s['parent'])
            assert parent['name'] in ('sampler', 'local_energy', 'epoch')
    last = [s for s in report['spans'] if s['epoch'] == 2]
    assert (sum(s['name'] == 'attention' for s in last)
            == sum(s['name'] == 'mlp' for s in last))
    assert sum(s['name'] == 'mlp' for s in last) % layers == 0
    assert {'attention', 'mlp'} <= set(report['epochs'][-1]['host_ms'])
    profiling.reset()


@pytest.mark.parametrize('fields', [SMALL, {}],
                         ids=['4x4-d16-2heads-2layers', 'published-6x6'])
def test_flops_params_are_the_ports_count(fields):
    values = _values(**fields)
    wf = models.build_wavefunction(_config(values))
    count = sum(t.numel() for t in
                check.flat_params(wf.init(torch.Generator())).values())
    flops = spec.flops(spec.cell(CELL, BENCH), 'transformer')
    assert flops.params(values) == count
    if not fields:
        assert count == 202497
        assert flops.forward(values) == 16 * 36 * 4 * 107520


def test_the_cell_runs_correct_through_the_harness():
    """The cell end to end at a tiny size through run.py's measure (the
    card's look skipped): the check holds, and a traced run reads the
    encoder's share from the program's counter."""
    cell = spec.cell(CELL, BENCH)
    line = run_py.measure(cell, 2 ** 31 + 9, 0.0, True, device='cpu',
                          started=time.perf_counter(), overrides=TINY,
                          replay='plain')
    assert line['correct'] is True, line['checks']
    assert set(line['checks']) == set(cell.limits)
    json.dumps(line, allow_nan=False)
    reader = spec.metric_reader(cell, 'encoder_flops_share.train')
    assert reader.read(_FakeRun(cell, busy=None)) is None


class _FakeRun:
    """What the reader reads of a run: a trace of 2 epochs."""

    def __init__(self, cell, busy):
        self.kind = 'train'
        self.cell = cell
        self.units = 3
        self.setup_parts = {'to_train': 0.1, 'epoch1': 1.0, 'epoch2': 2.0}

        class Trace:
            units = 2
            busy_s = busy
        self.trace = Trace()


def test_the_encoder_share_reads_the_loops_counter(monkeypatch):
    """images an epoch × one image's operations × traced epochs over the
    f32 peak × busy seconds; None without the counter."""
    cell = spec.cell(CELL, BENCH)
    reader = spec.metric_reader(cell, 'encoder_flops_share.train')
    per_image = 36 * 4 * (24 * 64 ** 2 + 4 * 36 * 64)
    loop = {'encoder.images': 7 * 1000}
    monkeypatch.setattr(profiling, 'span_report',
                        lambda: {'loop_counters': loop})
    share = reader.read(_FakeRun(cell, busy=0.5))
    assert share == pytest.approx(
        100.0 * 1000 * per_image * 2 / (67e12 * 0.5))
    loop.clear()
    assert reader.read(_FakeRun(cell, busy=0.5)) is None
