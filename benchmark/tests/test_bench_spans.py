"""The reader of the program's spans (metrics/loop_host_ms.train.py) on a
fixture run and report, against a program without spans, and through the
train driver on the CPU: an untraced run records no span, a traced one
exactly its traced epochs."""

import time

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import TraceSummary
from benchmark.harness.window import Run
from cgs_vmc_tpu_torch.utils import profiling

BENCH = spec.load_benchmark()
CELL = spec.cell('chain40_rbm.train_itswo', BENCH)
READER = spec.metric_reader(CELL, 'loop_host_ms.train')
TINY = {'num_sites': 8, 'fc_layer_size': 16, 'batch_size': 32,
        'num_equilibration_sweeps': 2}


def _run(units):
    run = Run('train', CELL, 64)
    run.trace = TraceSummary(units=units, window_s=1.0, busy_s=0.5,
                             kernels=10, device_events=12, by_name={},
                             idle_gaps=[])
    return run


def _report(*blocks):
    """Epoch records of blocks of one epoch, 1, 2, ...: for each, the end
    of its wait and the start of its launch (ms)."""
    spans = []
    for n, (launch, wait) in enumerate(blocks, 1):
        for name, key, ms in (('graph.launch', 'start_ns', launch),
                              ('train.wait', 'end_ns', wait)):
            if ms is not None:
                spans.append({'name': name, 'epoch': n,
                              key: int(ms * 1e6)})
    rows = [{'epoch': n, 'device_ms': {}, 'host_ms': {}}
            for n in range(1, len(blocks) + 1)]
    return lambda: {'epochs': rows, 'spans': spans, 'counters': {},
                    'loop_counters': {}}


def test_reads_the_turn_between_a_wait_and_the_next_launch(monkeypatch):
    """Blocks 2-4 traced (after an untraced block 1): the turns from the
    end of 2's wait to 3's launch (2 ms) and from 3's to 4's (4 ms)."""
    monkeypatch.setattr(profiling, 'span_report', _report(
        (None, 5.0), (100.0, 110.0), (112.0, 120.0), (124.0, 900.0)))
    assert READER.read(_run(3)) == pytest.approx((2.0 + 4.0) / 2)
    assert READER.read(_run(2)) == pytest.approx(4.0)


def test_reads_nothing_where_there_is_nothing(monkeypatch):
    monkeypatch.setattr(profiling, 'span_report', _report(
        (1.0, 2.0), (3.0, 4.0)))
    assert READER.read(_run(3)) is None          # fewer epochs than traced
    assert READER.read(_run(1)) is None          # no turn to read
    untraced = _run(2)
    untraced.trace = None
    assert READER.read(untraced) is None
    monkeypatch.setattr(profiling, 'span_report', _report(
        (None, 2.0), (None, 4.0)))
    assert READER.read(_run(2)) is None          # no launch, no epoch
    monkeypatch.delattr(profiling, 'span_report')
    assert READER.read(_run(2)) is None          # a program without spans


@pytest.mark.parametrize('trace', [False, True])
def test_the_driver_records_spans_only_while_it_traces(monkeypatch, trace):
    """Nothing of the harness turns the spans on; the profiler of a
    traced run makes the program record exactly the traced epochs."""
    profiling.reset()
    calls = []
    monkeypatch.setattr(profiling, 'spans', calls.append)
    run, numbers, _ = spec.driver(CELL).run(
        CELL, 2 ** 31 + 5, 0.2, trace, time.perf_counter(), 'cpu',
        overrides=TINY, replay='plain')
    assert calls == [] and numbers['epochs_missed'] == 0
    rows = profiling.span_report()['epochs']
    if not trace:
        assert rows == [] and READER.read(run) is None
        return
    assert len(rows) == run.trace.units >= 2
    assert all(row['device_ms'] == {} for row in rows)
    assert READER.read(run) > 0
