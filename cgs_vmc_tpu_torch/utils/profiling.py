"""The port's tracing: spans at its layer boundaries, one registry of
counters, and a ``torch.profiler`` trace of a training run's second call
(the trace ports cgs_vmc_tpu/utils/profiling.py; the spans and counters
are the port's own).

Spans.  ``span(name, device)`` marks one layer boundary; the names are
fixed (`DEVICE_SPANS`, `HOST_SPANS`).  A span records only inside
``train()``'s loop (`loop`), and only when something asks for it:

 * off, the default, and no profiler running: `span` returns one shared
   no-op context manager; nothing is recorded, allocated or sent to the
   profiler;
 * off while a ``torch.profiler`` runs: the spans record their host times
   and nothing else, so a profiled window of the loop has them and its
   trace is the one it would be without them (a ``record_function`` range
   around work on a card is a device event of the trace too);
 * ``spans(True)``, or a run with ``profile_dir``: inside the loop every
   span records its host times, is a ``record_function`` range while a
   profiler runs and, on a card, a span of `DEVICE_SPANS` records a pair
   of CUDA timing events on the current stream.  Inside a capture these
   become event-record nodes of the graph, so every replay of it times
   each phase again (`replayed`); the counter ``connected.needed`` is kept
   on the device (`count_nonzero`).

A host record holds the span's name, id, parent id, the epoch it belongs
to and its start and end by ``time.perf_counter_ns()``.  The phases
(`PHASES`) do not nest: a phase opened inside another is the outer one's
time.  The encoder's spans ``attention`` and ``mlp`` (models/attention.py,
around each block's two residual branches) are not phases: they lie inside
the phases, and their device ms an epoch are reported beside them.  After
each block of epochs the loop calls `collect`, which reads
the block's event pairs and keeps one record an epoch, ``{'epoch': n,
'device_ms': {span: ms}, 'host_ms': {span: ms}}``, for the last
`KEEP_EPOCHS` epochs; a block-level host span (``train.*``,
``graph.*``) gives each of the block's epochs an equal share.  The
optimizer's own device time is the self time of ``epoch``: ``epoch``
less its phases (`phase_ms`).

Counters.  ``count(name, n)`` adds to one registry of host integers,
always on: the sweep kernels' launches (``k1.launches``,
``k2.launches``), the collectives over a chains group (``collectives``),
the connected boards the local energy evaluates
(``connected.evaluated``), the images through the transformer's encoder
(``encoder.images``), the blocks of SR's Jacobian rows
(``sr.row_blocks``), and the hand-written kernels' launches and the CUDA
calls that kept their plain versions (``periodic_conv.*``,
``attention.launches`` / ``attention.plain``,
``encoder_linear.launches`` / ``encoder_linear.plain``).  A captured graph adds what its capture counted at
every replay (`capturing`, utils/cuda_graph.py).  Inside a
``torch.func.vmap`` call Python runs the function once for all its
samples: `count_samples` counts for each sample of the calls open
(`vmapped`).  Work that is not the run's own (SR's memory probe) runs
inside `capturing`, which drops its counts and spans.

`maybe_trace` writes a Chrome trace of a block of epochs into a
directory (``<host>_<pid>.<time>.pt.trace.json``, read by TensorBoard's
profiler plugin and chrome://tracing): the host's operators, the program's
spans and, on a card, the CUDA kernels each launched.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, Iterator, List, Optional

import torch

from cgs_vmc_tpu_torch.utils.tree import leaves

DEVICE_SPANS = ('epoch', 'sampler', 'local_energy', 'attention', 'mlp')
HOST_SPANS = ('train.block', 'train.wait', 'train.log', 'train.checkpoint',
              'graph.replay', 'graph.launch', 'graph.capture')
PHASES = ('sampler', 'local_energy')
KEEP_EPOCHS = 4096
KEEP_SPANS = 65536

_NULL = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_VMAPPED: List[int] = []        # the samples of each vmap call open now


class _Recorder:
    """What the spans hold between a block's start and its `collect`."""

    def __init__(self):
        self.on = False
        self.in_loop = False
        self.next_id = 0
        self.stack: List[dict] = []
        self.pending: List[dict] = []
        self.epochs: collections.deque = collections.deque(
            maxlen=KEEP_EPOCHS)
        self.spans: collections.deque = collections.deque(maxlen=KEEP_SPANS)
        self.on_device: Dict[tuple, torch.Tensor] = {}
        self.loop_counts: Dict[str, int] = {}


_R = _Recorder()


def spans(on: bool) -> None:
    """Turns the spans' records and device timing on or off."""
    _R.on = bool(on)


def _recording() -> bool:
    return _R.in_loop and (_R.on or torch.autograd._profiler_enabled())


class _Span:
    __slots__ = ('device', 'record', 'events', 'prof')

    def __init__(self, name, device, index, traced):
        self.device = device
        self.prof = (torch.autograd.profiler.record_function(name)
                     if traced else None)
        self.events = None
        parent = _R.stack[-1] if _R.stack else None
        self.record = {'name': name, 'id': _R.next_id,
                       'parent': parent['id'] if parent else None,
                       'index': (index if index is not None
                                 else parent['index'] if parent else None),
                       'epoch': None, 'start_ns': None, 'end_ns': None,
                       'device_ms': None}
        _R.next_id += 1

    def __enter__(self):
        if self.prof is not None:
            self.prof.__enter__()
        if _R.on and self.device is not None and self.device.type == 'cuda':
            self.events = (torch.cuda.Event(enable_timing=True,
                                            external=True),
                           torch.cuda.Event(enable_timing=True,
                                            external=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
            self.record['_events'] = self.events
        _R.stack.append(self.record)
        _R.pending.append(self.record)
        self.record['start_ns'] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record['end_ns'] = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        _R.stack.pop()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None,
         index: Optional[int] = None):
    """A context manager around one layer boundary (see the module doc).

    device: where a span of DEVICE_SPANS runs its work (None for a host
    span); index: the epoch's place in its block, given by ``epoch``
    spans and taken by the spans inside them."""
    if not _recording():
        return _NULL
    if name in PHASES and any(r['name'] in PHASES for r in _R.stack):
        return _NULL
    return _Span(name, device, index,
                 _R.on and torch.autograd._profiler_enabled())


# ----------------------------------------------------------------------
# Counters.
# ----------------------------------------------------------------------

def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counter(name: str) -> int:
    """The counter `name` (0 if nothing counted it)."""
    return _COUNTS.get(name, 0)


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_COUNTS)


def reset_counters(*names: str) -> None:
    """Sets the counters `names` (every counter, if none) to 0."""
    for name in names or list(_COUNTS):
        _COUNTS.pop(name, None)


@contextlib.contextmanager
def vmapped(samples: int) -> Iterator[None]:
    """Around one ``torch.func.vmap`` call over `samples` samples, whose
    function Python runs once for all of them (`count_samples`)."""
    _VMAPPED.append(samples)
    try:
        yield
    finally:
        _VMAPPED.pop()


def count_samples(name: str, n: int) -> None:
    """Adds `n` to the counter `name` for each sample of the `vmapped`
    calls open now (`n` once outside any)."""
    for samples in _VMAPPED:
        n *= samples
    count(name, n)


def add_counts(counts: Dict[str, int]) -> None:
    for name, n in counts.items():
        count(name, n)


def count_nonzero(name: str, values: torch.Tensor) -> None:
    """Adds the non-zero entries of `values` to the counter `name`, with
    spans on and inside the loop only: the sum stays on `values`' device
    (no host sync) until the loop ends (`loop`).  The accumulator is made
    at the first call, which must not be inside a graph capture."""
    if not (_R.on and _R.in_loop):
        return
    key = (name, values.device)
    total = _R.on_device.get(key)
    if total is None:
        if values.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f'no device counter {name!r} before this capture: the '
                'eager epoch before it makes one')
        total = _R.on_device[key] = torch.zeros(
            (), dtype=torch.int64, device=values.device)
    total.add_(torch.count_nonzero(values))


def _read_device_counts() -> None:
    """Moves the device counters into the registry (reads each back).  An
    accumulator outlives the loop that made it; one that counted nothing
    adds no counter, so a loop with spans off leaves the registry as it
    was."""
    for (name, _), total in _R.on_device.items():
        n = int(total.item())
        if n:
            count(name, n)
            total.zero_()


class Captured:
    """What a graph capture counted and the device spans it recorded: a
    replay adds the first (`add_counts`) and times the second
    (`replayed`)."""

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.spans: List[dict] = []


@contextlib.contextmanager
def capturing() -> Iterator[Captured]:
    """Around a graph capture (or work that is not the run's own): the
    counters' change during it is taken back (the capture ran no work) and
    kept in the Captured yielded, with the spans recorded inside it."""
    out = Captured()
    before = dict(_COUNTS)
    mark = len(_R.pending)
    yield out
    out.counts = {name: n - before.get(name, 0)
                  for name, n in _COUNTS.items() if n != before.get(name, 0)}
    _COUNTS.clear()
    _COUNTS.update(before)
    out.spans = _R.pending[mark:]
    del _R.pending[mark:]


def replayed(captured: List[dict]) -> None:
    """One replay of a graph whose capture recorded the spans `captured`:
    their event pairs have timed this replay's phases.  New records, under
    the span open now, with no host times."""
    if not captured or not _recording():
        return
    parent = _R.stack[-1]['id'] if _R.stack else None
    ids: Dict[int, int] = {}
    for template in captured:
        ids[template['id']] = _R.next_id
        _R.pending.append({
            'name': template['name'], 'id': _R.next_id,
            'parent': ids.get(template['parent'], parent),
            'index': template['index'], 'epoch': None, 'start_ns': None,
            'end_ns': None, 'device_ms': None,
            '_events': template.get('_events')})
        _R.next_id += 1


# ----------------------------------------------------------------------
# The loop's side: collection and the report.
# ----------------------------------------------------------------------

@contextlib.contextmanager
def loop(on: bool = False) -> Iterator[None]:
    """Around train()'s loop: spans record inside it (`on` turns them on
    for its length); on leaving, the device counters are read back and
    the change of every counter over the loop is kept for the report."""
    was = _R.on
    _R.on = was or on
    _R.in_loop = True
    before = dict(_COUNTS)
    try:
        yield
    finally:
        _R.in_loop = False
        _R.stack.clear()
        _R.pending.clear()
        _read_device_counts()
        _R.on = was
        _R.loop_counts = {name: n - before.get(name, 0)
                          for name, n in _COUNTS.items()
                          if n != before.get(name, 0)}


def collect(epoch: int, k: int) -> None:
    """Reads the spans of the block of `k` epochs after `epoch` that just
    ran (the caller has synchronized) into one record an epoch."""
    if not _R.pending:
        return
    block, _R.pending = _R.pending, []
    rows = [{'epoch': epoch + j + 1, 'device_ms': {}, 'host_ms': {}}
            for j in range(k)]
    for record in block:
        events = record.pop('_events', None)
        if events is not None:
            record['device_ms'] = events[0].elapsed_time(events[1])
        host = (None if record['start_ns'] is None
                else (record['end_ns'] - record['start_ns']) / 1e6)
        index = record['index']
        record['epoch'] = epoch + 1 + (index or 0)
        if index is None:
            targets, share = rows, 1.0 / k
        else:
            targets, share = [rows[index]], 1.0
        for row in targets:
            for key, value in (('device_ms', record['device_ms']),
                               ('host_ms', host)):
                if value is not None:
                    row[key][record['name']] = (
                        row[key].get(record['name'], 0.0) + value * share)
        del record['index']
        _R.spans.append(record)
    _R.epochs.extend(rows)


def phase_ms(row: dict) -> Dict[str, float]:
    """Device ms of one epoch record by phase: the sampler, the local
    energies and the optimizer (the self time of ``epoch``: the epoch
    less its phases); {} for an epoch with no device times."""
    device = row['device_ms']
    if 'epoch' not in device:
        return {}
    out = {name: device.get(name, 0.0) for name in PHASES}
    out['optimizer'] = device['epoch'] - sum(out.values())
    return out


def span_report() -> dict:
    """The recorded epochs (oldest first), the recent span records, every
    counter, and each counter's change over the last loop."""
    return {'epochs': [dict(row) for row in _R.epochs],
            'spans': [dict(record) for record in _R.spans],
            'counters': counters(),
            'loop_counters': dict(_R.loop_counts)}


def reset() -> None:
    """Forgets the recorded epochs and spans."""
    _R.epochs.clear()
    _R.spans.clear()
    _R.loop_counts = {}


def write_spans(path: str, epochs: int) -> None:
    """`path` (JSON): the last `epochs` epoch records, each with its
    `phase_ms` where it has device times, their span records and every
    counter, the device counters read back first."""
    _read_device_counts()
    rows = [{**row, 'phase_ms': phase_ms(row)}
            for row in list(_R.epochs)[-epochs:]]
    first = rows[0]['epoch'] if rows else None
    with open(path, 'w') as f:
        json.dump({'epochs': rows,
                   'spans': [r for r in _R.spans
                             if first is not None and r['epoch'] >= first],
                   'counters': counters()}, f, indent=1)


# ----------------------------------------------------------------------
# The profiler trace and the host's wait.
# ----------------------------------------------------------------------

def synchronize(result) -> None:
    """Waits for the devices of every tensor in `result` (a tree of
    utils/tree.py)."""
    for device in {t.device for t in leaves(result) if t.is_cuda}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` trace of the CPU and, when CUDA is available,
    the card into `trace_dir`; a no-op when it is empty.  The caller
    synchronizes before leaving the block, so the kernels it launched are
    in the trace."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
