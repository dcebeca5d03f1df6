"""The port's spans and counters (utils/profiling.py): the switch off
records nothing and changes nothing, on changes no number; the spans'
names, nesting, parent ids and epoch numbers under SR, ITSWO and
``epochs_per_call`` 3; the per-epoch arithmetic; a capture's counts added
back once a replay; the connected-board counters against a direct count.
The tests marked ``gpu`` time the phases of replayed epochs on a card.

The file imports no jax:

    python -m pytest tests/test_torch_tracing.py -q
    python -m pytest --noconftest tests/test_torch_tracing.py -m gpu  # card
"""

import os

import numpy as np
import pytest
import torch

from cgs_vmc_tpu_torch import lattice, models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.ops.ising import TransverseFieldIsingHamiltonian
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_tpu_torch.train import _scan_epochs, build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import cuda_graph, profiling, tree
from cgs_vmc_tpu_torch.utils.tree import flatten

N = 8
CHAIN40 = os.path.join(os.path.dirname(__file__), '..', 'configs',
                       'chain40_sr.json')


def _config(**overrides):
    values = dict(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                  fc_layer_size=8, batch_size=32, num_batches_per_epoch=2,
                  num_equilibration_sweeps=2, heisenberg_jx=-1.0,
                  optimizer='adam', learning_rates=[1e-2],
                  learning_rate_stops=[], num_epochs=4, sr_diag_shift=1e-2,
                  wavefunction_optimizer_type='SR', seed=5)
    values.update(overrides)
    return Config(**values)


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, epoch, metrics):
        self.rows.append((epoch, {k: v.clone() for k, v in metrics.items()}))


@pytest.fixture(autouse=True)
def _clean():
    profiling.spans(False)
    profiling.reset()
    profiling.reset_counters()
    yield
    profiling.spans(False)
    profiling.reset()


def _run(replay, on, **overrides):
    profiling.spans(on)
    logger = _Rows()
    state = train(_config(**overrides), 'cpu', logger=logger, replay=replay)
    profiling.spans(False)
    return state, logger.rows


def _assert_same(a, b):
    """Every tensor and every generator's state equal."""
    (skel_a, leaves_a), (skel_b, leaves_b) = flatten(a), flatten(b)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y)
    for g, h in zip(tree.generators(skel_a), tree.generators(skel_b)):
        assert torch.equal(g.get_state(), h.get_state())


def _assert_same_rows(a, b):
    assert [e for e, _ in a] == [e for e, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert torch.equal(x[key], y[key]), key


def test_spans_off_are_one_shared_no_op():
    spans = {profiling.span(name, torch.device('cpu'), 0)
             for name in profiling.DEVICE_SPANS + profiling.HOST_SPANS}
    assert len(spans) == 1
    with profiling.loop():
        assert profiling.span('epoch') is spans.pop()


@pytest.mark.parametrize('optimizer', ['SR', 'ITSWO'])
def test_spans_off_record_nothing_and_plain_equals_eager(optimizer):
    eager, eager_rows = _run('eager', False,
                             wavefunction_optimizer_type=optimizer)
    plain, plain_rows = _run('plain', False,
                             wavefunction_optimizer_type=optimizer)
    report = profiling.span_report()
    assert report['epochs'] == [] and report['spans'] == []
    assert 'connected.needed' not in report['counters']
    _assert_same(eager, plain)
    _assert_same_rows(eager_rows, plain_rows)


@pytest.mark.parametrize('replay', ['eager', 'plain'])
@pytest.mark.parametrize('optimizer', ['SR', 'ITSWO'])
def test_spans_on_change_no_number(replay, optimizer):
    off, off_rows = _run(replay, False, wavefunction_optimizer_type=optimizer)
    on, on_rows = _run(replay, True, wavefunction_optimizer_type=optimizer)
    assert len(profiling.span_report()['epochs']) == 4
    _assert_same(off, on)
    _assert_same_rows(off_rows, on_rows)


@pytest.mark.parametrize('optimizer,k,replay', [
    ('SR', 1, 'eager'), ('SR', 1, 'plain'), ('ITSWO', 1, 'plain'),
    ('SR', 3, 'plain')])
def test_span_tree(optimizer, k, replay):
    """Epochs 1..7: the first block eager, the later blocks of k through
    the static-buffer body (graph.replay), the remainder epoch by epoch."""
    _run(replay, True, wavefunction_optimizer_type=optimizer,
         epochs_per_call=k, num_epochs=7)
    report = profiling.span_report()
    spans = report['spans']
    by_id = {s['id']: s for s in spans}
    assert len(by_id) == len(spans)
    assert {s['name'] for s in spans} <= set(profiling.DEVICE_SPANS
                                             + profiling.HOST_SPANS)
    epochs = [s for s in spans if s['name'] == 'epoch']
    assert [s['epoch'] for s in epochs] == list(range(1, 8))
    blocks = [s for s in spans if s['name'] == 'train.block']
    want_blocks = [1, 4, 7] if k == 3 else list(range(1, 8))
    assert [s['epoch'] for s in blocks] == want_blocks
    for s in spans:
        parent = by_id.get(s['parent'])
        if s['name'] == 'train.block':
            assert s['parent'] is None
        elif s['name'] in ('train.wait', 'train.log', 'train.checkpoint',
                           'graph.replay'):
            assert parent['name'] == 'train.block'
            assert parent['epoch'] == s['epoch']
        elif s['name'] == 'epoch':
            first = s['epoch'] <= k
            assert parent['name'] == ('train.block' if first or replay ==
                                      'eager' else 'graph.replay')
            assert s['epoch'] - parent['epoch'] in range(k)
        else:
            assert s['name'] in profiling.PHASES
            assert parent['name'] == 'epoch'
            assert parent['epoch'] == s['epoch']
        assert s['start_ns'] <= s['end_ns']
    # Each epoch: one refresh, the equilibration and one batch's sweeps
    # under SR (2 batches: 4 sampler spans), one local_energy span (SR) or
    # one a batch (ITSWO).
    phases = {n: [s for s in spans if s['name'] == n and s['epoch'] == 5]
              for n in profiling.PHASES}
    assert len(phases['sampler']) == (4 if optimizer == 'SR' else 6)
    assert len(phases['local_energy']) == (1 if optimizer == 'SR' else 2)
    rows = report['epochs']
    assert [r['epoch'] for r in rows] == list(range(1, 8))
    for row in rows:
        assert {'train.block', 'train.wait', 'train.log', 'epoch',
                'sampler', 'local_energy'} <= set(row['host_ms'])
        assert row['device_ms'] == {}


def test_collect_and_phase_ms_on_hand_made_spans():
    """A block of two epochs: the block's host span shared equally, each
    epoch's own spans its own; a phase inside a phase is the outer's;
    the optimizer's time the self time of `epoch`."""
    with profiling.loop(on=True):
        with profiling.span('train.block'):
            for j in range(2):
                with profiling.span('epoch', index=j):
                    with profiling.span('sampler'):
                        assert profiling.span('local_energy') is \
                            profiling.span('sampler')
                    with profiling.span('local_energy'):
                        pass
        profiling.collect(10, 2)
    rows = profiling.span_report()['epochs']
    assert [r['epoch'] for r in rows] == [11, 12]
    block = [s for s in profiling.span_report()['spans']
             if s['name'] == 'train.block'][0]
    whole = (block['end_ns'] - block['start_ns']) / 1e6
    assert rows[0]['host_ms']['train.block'] == pytest.approx(whole / 2)
    assert rows[1]['host_ms']['train.block'] == pytest.approx(whole / 2)
    assert all('epoch' in r['host_ms'] and 'sampler' in r['host_ms']
               for r in rows)
    assert profiling.phase_ms(
        {'device_ms': {'epoch': 10.0, 'sampler': 6.0, 'local_energy': 3.0}}
    ) == {'sampler': 6.0, 'local_energy': 3.0, 'optimizer': 1.0}
    assert profiling.phase_ms(
        {'device_ms': {'epoch': 2.5, 'sampler': 2.0}}
    ) == {'sampler': 2.0, 'local_energy': 0.0, 'optimizer': 0.5}
    assert profiling.phase_ms({'device_ms': {}}) == {}


class _NoGraph:
    """Stands in for a captured graph: its replay runs nothing."""

    def replay(self):
        pass


@pytest.mark.parametrize('optimizer', ['SR', 'ITSWO'])
def test_a_capture_counts_once_and_each_replay_adds_it(optimizer):
    """The body run inside `capturing` (as a capture runs it) leaves every
    counter as it was and keeps what it counted, equal to one eager
    epoch's counts; each replay adds it once and, with spans on, replays
    the captured spans under graph.replay."""
    config = _config(wavefunction_optimizer_type=optimizer)
    wf = models.build_wavefunction(config)
    opt = GROUND_STATE_OPTIMIZERS[optimizer](wf, build_hamiltonian(config),
                                             config)
    state = opt.init_state(config.seed, 'cpu', config.batch_size)
    before = profiling.counters()
    opt.epoch(state)
    eager = {k: v - before.get(k, 0)
             for k, v in profiling.counters().items()}
    # SR's rows come in one block (sr.row_blocks); ITSWO has none.
    assert eager == {'connected.evaluated': 64 * N,
                     **({'sr.row_blocks': 1} if optimizer == 'SR' else {})}
    with profiling.loop(on=True):
        block = cuda_graph._Block(lambda k: _scan_epochs(opt.epoch, k), 1,
                                  state, [], torch.device('cpu'))
        profiling.reset_counters()
        with profiling.capturing() as block.captured:
            block._body()
        assert profiling.counters() == {}
        assert block.captured.counts == eager
        names = [s['name'] for s in block.captured.spans]
        assert names.count('epoch') == 1 and 'sampler' in names
        block.graph = _NoGraph()
        for n in range(1, 4):
            block.replay(unflatten_state(block), [])
            assert profiling.counters() == {k: n * v
                                            for k, v in eager.items()}
        profiling.collect(0, 1)
    spans = profiling.span_report()['spans']
    replays = [s for s in spans if s['name'] == 'graph.replay']
    launches = [s for s in spans if s['name'] == 'graph.launch']
    epochs = [s for s in spans if s['name'] == 'epoch']
    assert len(replays) == len(launches) == len(epochs) == 3
    assert [e['parent'] for e in epochs] == [r['id'] for r in replays]
    assert [e['parent'] for e in launches] == [r['id'] for r in replays]
    assert all(e['start_ns'] is None and e['epoch'] == 1 for e in epochs)


def unflatten_state(block):
    return tree.unflatten(block.skeleton, block.buffers)


def _antiparallel(configs, bonds):
    return int((configs[:, bonds[:, 0]] != configs[:, bonds[:, 1]]).sum())


@pytest.mark.parametrize('family,chunk', [('heisenberg', 0),
                                          ('heisenberg', 5), ('ising', 0)])
def test_connected_counters_equal_a_direct_count(family, chunk):
    bonds, _ = lattice.bonds_and_couplings_for_config(_config())
    bonds = np.asarray(bonds)
    generator = torch.Generator().manual_seed(3)
    if family == 'heisenberg':
        ham = HeisenbergHamiltonian(bonds, -1.0, 1.0, sample_chunk=chunk)
        configs = torch.stack([
            torch.tensor([1.0, -1.0] * (N // 2))[torch.randperm(
                N, generator=generator)] for _ in range(23)])
        needed = _antiparallel(configs, bonds)
        evaluated = 23 * len(bonds)
    else:
        ham = TransverseFieldIsingHamiltonian(bonds, h_x=0.7, j_zz=1.0)
        configs = torch.randint(0, 2, (23, N), generator=generator) * 2.0 - 1
        needed = evaluated = 23 * N
    wf = models.build_wavefunction(_config())
    params = wf.init(torch.Generator().manual_seed(0))
    ham.local_value(wf, params, configs)
    assert profiling.counters() == {'connected.evaluated': evaluated}
    with profiling.loop(on=True):
        ham.local_value(wf, params, configs)
    assert profiling.span_report()['loop_counters'] == {
        'connected.evaluated': evaluated, 'connected.needed': needed}
    assert 0 < needed <= evaluated


# ----------------------------------------------------------------------
# On a card.
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: device spans time CUDA events')
    return torch.device('cuda')


@pytest.mark.gpu
def test_timing_events_inside_a_capture_time_each_replay(cuda):
    """Three GEMMs between four timing events, captured; each replay's
    three in-graph times sum to within 5% of events around the replay."""
    a = torch.randn(2048, 2048, device=cuda)
    bs = [torch.randn(2048, 2048, device=cuda) for _ in range(3)]
    outs = [torch.empty_like(a) for _ in range(3)]
    events = [torch.cuda.Event(enable_timing=True, external=True)
              for _ in range(4)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for b, out in zip(bs, outs):
            torch.matmul(a, b, out=out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        events[0].record()
        for i, (b, out) in enumerate(zip(bs, outs)):
            torch.matmul(a, b, out=out)
            events[i + 1].record()
    outer = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(20):
        outer[0].record()
        graph.replay()
        outer[1].record()
        torch.cuda.synchronize()
        parts = [events[i].elapsed_time(events[i + 1]) for i in range(3)]
        assert min(parts) > 0
        assert sum(parts) == pytest.approx(
            outer[0].elapsed_time(outer[1]), rel=0.05)


@pytest.mark.gpu
def test_replayed_itswo_epochs_time_their_phases(cuda, monkeypatch):
    """chain40 ITSWO, one epoch a replay: in each replayed epoch the
    sampler, the local energies and the optimizer read above zero and
    together lie within 5% of the replay timed around it; spans on add
    event nodes to the graph and change no number."""
    replays = []
    real = torch.cuda.CUDAGraph.replay

    def timed(self):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        real(self)
        pair[1].record()
        replays.append(pair)

    monkeypatch.setattr(torch.cuda.CUDAGraph, 'replay', timed)
    config = Config.load(CHAIN40).override_from_dict(
        {'wavefunction_optimizer_type': 'ITSWO', 'num_epochs': 6})
    profiling.spans(True)
    on = train(config, cuda, logger=_Rows())
    profiling.spans(False)
    torch.cuda.synchronize()
    rows = profiling.span_report()['epochs']
    assert [r['epoch'] for r in rows] == list(range(1, 7))
    for row, pair in zip(rows[1:], replays):
        phases = profiling.phase_ms(row)
        assert min(phases.values()) > 0, phases
        assert sum(phases.values()) == pytest.approx(
            pair[0].elapsed_time(pair[1]), rel=0.05)
    counts = profiling.span_report()['loop_counters']
    assert 0 < counts['connected.needed'] < counts['connected.evaluated']
    off = train(config, cuda, logger=_Rows())
    _assert_same(on, off)


@pytest.mark.gpu
def test_a_device_counter_is_not_made_inside_a_capture(cuda):
    """A counter kept on the card is made before any capture (the eager
    epoch makes it); a capture that finds none raises."""
    x = torch.ones(16, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with profiling.loop(on=True):
        with torch.cuda.stream(side):
            profiling.count_nonzero('test.made_before', x)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            profiling.count_nonzero('test.made_before', x)
        graph.replay()
        with pytest.raises(RuntimeError, match='test.made_inside'):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                profiling.count_nonzero('test.made_inside', x)
    assert profiling.counter('test.made_before') == 32
    assert profiling.counter('test.made_inside') == 0
