"""The Vision-Transformer wavefunction as the benchmark runs it
(`square1010_vit.train_sr`), on the CPU: the port's complex log ψ and one
SR step against the benchmark's plain reference (benchmark/reference/,
which imports nothing of the port), its translation invariance by one
patch, the operation counts, the counter `vit.boards` against the
traffic's arithmetic over replays of the static-buffer body
(``replay='plain'``, what a CUDA graph captures), the cell's harness end
to end at a tiny size with planted faults, and every port-only
configuration file.

Weights are the port's init from a seed, every leaf then moved by seeded
noise (so that the LayerNorm gains and biases and every bias count).
log|ψ| agrees to rtol 1e-5 and the phase, wrapped to (−π, π], to 1e-5:
the same float32 equations, with sums in another order (the reference's
own patch gather, mixing einsum and LayerNorm, and the complex log cosh
where the port takes it in real arithmetic).
"""

import json
import math
import pathlib
import time

import pytest
import torch

from benchmark import run as run_py
from benchmark.harness import check, spec
from benchmark.reference import lattice as ref_lattice
from benchmark.reference import steps
from benchmark.reference.ansatz import vit as ref_vit
from cgs_vmc_tpu_torch import lattice as port_lattice
from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models import vit
from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
BENCH = spec.load_benchmark()
CELL = 'square1010_vit.train_sr'
PUBLISHED = spec.cell(CELL, BENCH).config
SMALL = dict(num_sites=16, size_x=4, size_y=4, attention_dim=12,
             num_attention_heads=2, num_attention_layers=2)
TINY = dict(SMALL, batch_size=8, energy_chunk_samples=8,
            num_equilibration_sweeps=1, num_monte_carlo_sweeps=1)
TORCH_ONLY = sorted(str(p.relative_to(REPO))
                    for p in (REPO / 'configs' / 'torch_only').glob('*.json'))


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


def _wrapped(turn: torch.Tensor) -> torch.Tensor:
    return math.pi - torch.remainder(math.pi - turn, 2.0 * math.pi)


@pytest.mark.parametrize('fields,count', [(SMALL, 32), ({}, 8)],
                         ids=['4x4-d12-2heads-2layers', 'published-10x10'])
def test_log_psi_equals_the_plain_reference(fields, count):
    values = _values(**fields)
    wf = models.build_wavefunction(_config(values))
    params = _params(wf, 3)
    boards = _boards(values['num_sites'], count, 4)
    with torch.no_grad():
        port = wf.apply(params, boards)
        ref = ref_vit.build(values)(check.flat_params(params), boards)
    assert torch.equal(port.sign, torch.ones_like(port.sign))
    assert port.log.dtype == torch.complex64
    assert float(port.log.real.std()) > 0.1     # the boards differ in ψ
    assert float(port.log.imag.std()) > 0.1
    torch.testing.assert_close(port.log.real, ref.real, rtol=1e-5, atol=1e-6)
    assert float(_wrapped(port.log.imag - ref.imag).abs().max()) < 1e-5


@pytest.mark.parametrize('axis', [1, 2], ids=['x', 'y'])
def test_a_shift_by_one_patch_leaves_log_psi_unchanged(axis):
    """The mixing depends only on the patches' displacement and the pool
    sums the tokens: moving the board by 2 sites permutes the tokens."""
    values = _values(**SMALL)
    wf = models.build_wavefunction(_config(values))
    params = _params(wf, 11)
    boards = _boards(16, 16, 12)
    moved = boards.reshape(-1, 4, 4).roll(2, dims=axis).reshape(-1, 16)
    with torch.no_grad():
        before, after = wf.apply(params, boards), wf.apply(params, moved)
    assert not torch.equal(moved, boards)
    torch.testing.assert_close(after.log.real, before.log.real, rtol=1e-5,
                               atol=1e-5)
    assert float(_wrapped(after.log.imag - before.log.imag).abs().max()
                 ) < 1e-5


def test_the_head_is_log_cosh_of_a_complex_number():
    """`vit.log_cosh` against torch's complex log(cosh(·)), over a grid of
    (u, v) that holds large |u| (where cosh overflows in float32 beyond
    |u| ≈ 89) and v around the half turns."""
    u = torch.linspace(-30.0, 30.0, 241)[:, None].expand(-1, 64)
    v = torch.linspace(-7.0, 7.0, 64)[None, :].expand(241, -1)
    modulus, phase = vit.log_cosh(u, v)
    exact = torch.log(torch.cosh(torch.complex(u, v).to(torch.complex128)))
    torch.testing.assert_close(modulus.double(), exact.real, rtol=1e-6,
                               atol=1e-5)
    assert float(_wrapped(phase.double() - exact.imag).abs().max()) < 1e-5
    huge = vit.log_cosh(torch.tensor([200.0]), torch.tensor([1.0]))
    assert torch.isfinite(huge[0]).all() and torch.isfinite(huge[1]).all()


def test_sr_step_equals_the_reference_sr_epoch():
    """One dense minSR step on the stacked complex system from the same
    params and boards: every leaf's change within 1e-3 of the reference's
    (the harness's leaf gap, the same f32 rows and solve in another
    order), and the same energy to 1e-5 of the mean |E_loc| (the noised
    weights make ratios of tens, whose f32 rounding the mean keeps)."""
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
    assert e_loc.is_complex()
    new, _, _, _ = opt.update_from_samples(params, opt_state,
                                           torch.tensor(0), boards, e_loc)
    side = steps.Sides(values, ref_lattice.bonds(values), 1024)
    assert side.complex
    base = check.flat_params(params)
    ref, metrics, _ = steps.sr_epoch(side, base, 0, positions, {})
    assert check.leaf_gap(check.flat_params(new), ref, base) < 1e-3
    scale = float(e_loc.abs().mean())
    assert abs(float(e_loc.mean().real) - metrics['energy']) < 1e-5 * scale


@pytest.mark.parametrize('fields', [SMALL, {}],
                         ids=['4x4-d12-2heads-2layers', 'published-10x10'])
def test_flops_params_are_the_ports_count(fields):
    values = _values(**fields)
    wf = models.build_wavefunction(_config(values))
    count = sum(t.numel() for t in
                check.flat_params(wf.init(torch.Generator())).values())
    flops = spec.flops(spec.cell(CELL, BENCH), 'vit')
    assert flops.params(values) == count
    assert flops.COMPLEX_LOG is True
    if not fields:
        assert count == 267720
        assert flops.forward(values) == 8 * (12 * 25 * 72 ** 2
                                             + 2 * 25 ** 2 * 72)


class _Counts:
    """A logger that keeps the counter at each epoch's end."""

    def __init__(self):
        self.rows = []

    def log(self, epoch, metrics):
        del metrics
        self.rows.append(profiling.counter('vit.boards'))


def test_vit_boards_an_epoch_are_the_traffics_arithmetic():
    """Three epochs: the eager warm-up, then two calls of the static-buffer
    body.  An epoch's boards are the amplitude refresh (chains), the
    proposals ((equilibration + batches × sweeps) × N × chains), the
    sampled boards, their connected boards (the 2N J1 and 2N J2 bonds,
    masked) and the rows' forwards (2M: log|ψ| and the phase)."""
    values = _values(**TINY, num_epochs=3)
    logger = _Counts()
    train(_config(values), 'cpu', logger=logger, replay='plain')
    chains, m, n = 8, 32, 16
    boards = chains * (1 + (1 + 4 * 1) * n) + m * (1 + 4 * n + 2)
    assert [b - a for a, b in zip(logger.rows, logger.rows[1:])] == [
        boards] * 2


def test_the_cell_runs_correct_through_the_harness():
    """The cell end to end at a tiny size through run.py's measure (the
    card's look skipped): the check holds with the cell's limits."""
    cell = spec.cell(CELL, BENCH)
    line = run_py.measure(cell, 2 ** 31 + 9, 0.0, False, device='cpu',
                          started=time.perf_counter(), overrides=TINY,
                          replay='plain')
    assert line['correct'] is True, line['checks']
    assert set(line['checks']) == set(cell.limits)
    json.dumps(line, allow_nan=False)


def _phase_dropped(monkeypatch):
    """The head keeps log|cosh| and loses the argument."""
    orig = vit.log_cosh

    def log_cosh(u, v):
        modulus, phase = orig(u, v)
        return modulus, torch.zeros_like(phase)
    monkeypatch.setattr(vit, 'log_cosh', log_cosh)


def _j2_dropped(monkeypatch):
    """The program's J1–J2 torus without its diagonal bonds."""
    def square(size_x, size_y):
        nearest = port_lattice.square_lattice_bonds(size_x, size_y)
        return nearest, torch.zeros(len(nearest)).numpy()
    monkeypatch.setattr(port_lattice, 'j1j2_square_bonds', square)


@pytest.mark.parametrize('fault,caught', [
    (_phase_dropped, 'cache_gap'), (_j2_dropped, 'energy_gap')],
    ids=['phase_dropped', 'j2_dropped'])
def test_a_planted_fault_fails_the_check(fault, caught, monkeypatch):
    fault(monkeypatch)
    cell = spec.cell(CELL, BENCH)
    line = run_py.measure(cell, 2 ** 31 + 9, 0.0, False, device='cpu',
                          started=time.perf_counter(), overrides=TINY,
                          replay='plain')
    assert line['correct'] is False
    assert line['checks'][caught]['value'] > line['checks'][caught]['limit']


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


def test_the_vit_share_reads_the_loops_counter(monkeypatch):
    """boards an epoch × one board's operations × traced epochs over the
    f32 peak × busy seconds; None without the counter or the trace."""
    cell = spec.cell(CELL, BENCH)
    reader = spec.metric_reader(cell, 'vit_flops_share.train')
    per_board = 8 * (12 * 25 * 72 ** 2 + 2 * 25 ** 2 * 72)
    loop = {'vit.boards': 7 * 1000}
    monkeypatch.setattr(profiling, 'span_report',
                        lambda: {'loop_counters': loop})
    share = reader.read(_FakeRun(cell, busy=0.5))
    assert share == pytest.approx(
        100.0 * 1000 * per_board * 2 / (67e12 * 0.5))
    assert reader.read(_FakeRun(cell, busy=None)) is None
    loop.clear()
    assert reader.read(_FakeRun(cell, busy=0.5)) is None


def test_the_benchmarks_copy_is_the_torch_only_file():
    """The benchmark runs the repository's file as it is (nothing
    reduced), at the published widths."""
    entry = spec.cell(CELL, BENCH).config_file
    assert entry['copied_from'] == 'configs/torch_only/square1010_vit_sr.json'
    assert entry['reduced'] == []
    assert entry['config'] == json.loads(
        (REPO / entry['copied_from']).read_text())


@pytest.mark.parametrize('path', TORCH_ONLY)
def test_torch_only_configs_load_and_build(path):
    """Every port-only configuration file loads and builds its ansatz and
    Hamiltonian in the port (the JAX package has no such ansatz, so these
    files live apart from configs/*.json, which it builds)."""
    config = Config.load(str(REPO / path))
    wf = models.build_wavefunction(config)
    build_hamiltonian(config)
    params = wf.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = wf.apply(params, _boards(config.num_sites, 2, 0))
    assert torch.isfinite(out.log.real).all()
