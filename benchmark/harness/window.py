"""The measured window of a run, and what the metric readers read.

A training window is whole epochs of the normal ``train()`` loop: the
`EpochClock` is its logger.  The loop synchronizes before it logs, so the
logger's host clock marks each epoch's end.  The first `warm` epochs (the
eager warm-up and the epoch that captures the CUDA graph) are set-up; the
window runs from the end of the last of them until the first epoch end at
or past the run's seconds.  With tracing, the profiler then covers whole
epochs for `trace_seconds` more.  The clock ends the loop by lowering the
configuration's ``num_epochs``, which the loop reads before every block,
and fails the run if the loop goes on regardless.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

from benchmark.harness import spec
from benchmark.harness.trace import TraceSummary, Tracer
from benchmark.reference import energy, lattice


@dataclasses.dataclass
class Run:
    """What one run measured; the metric readers read it."""
    kind: str                      # the driver's: 'train' (units: epochs)
    cell: Any                      # spec.Cell
    samples_per_unit: int
    setup_s: float = math.nan
    window_s: float = math.nan
    unit_s: List[float] = dataclasses.field(default_factory=list)
    failed: int = 0                # units whose energy is not finite
    trace: Optional[TraceSummary] = None
    flops_per_unit: Optional[float] = None
    k2_ops_per_unit: Optional[float] = None
    memory_peak_bytes: int = 0
    # Seconds from the process's start to each step of set-up
    # ('to_train', 'epoch1', ...), and the graph capture's own seconds.
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    check_s: float = math.nan      # the check's seconds, after the window

    @property
    def units(self) -> int:
        return len(self.unit_s)

    def count_operations(self, cell, values: dict, boards) -> None:
        """Model and K2 operations a unit (benchmark/flops/), with the
        antiparallel bonds (J2 bonds included, lattice.py) counted on
        `boards`, the boards the run returned."""
        bonds = lattice.bonds(values).to(boards.device)
        anti = float(energy.antiparallel(boards, bonds).sum(1).float().mean())
        model = spec.flops(cell, values['wavefunction_type'])
        step = spec.flops(cell, cell.traffic['flops'])
        self.flops_per_unit = step.unit(values, model, anti)
        if hasattr(model, 'k2_ops'):
            self.k2_ops_per_unit = model.k2_ops(values, step.sweeps(values))


class EpochClock:
    """The train() logger that marks the window (see the module doc)."""

    def __init__(self, config, run: Run, started: float, seconds: float,
                 warm: int, trace_seconds: float = 0.0):
        self.config = config
        self.run = run
        self.started = started
        self.seconds = seconds
        self.warm = warm
        self.trace_seconds = trace_seconds
        self.window_start = None
        self.window_end = None
        self.tracer = None
        self.traced = 0
        self.last = None
        self.stop_at = None
        self.epochs = 0

    def _stop(self, epoch: int) -> None:
        self.stop_at = epoch
        self.config.num_epochs = epoch

    def log(self, epoch: int, metrics) -> None:
        now = time.perf_counter()
        if self.stop_at is not None and epoch > self.stop_at:
            raise RuntimeError('train() went on past the end of the window: '
                               'it no longer reads num_epochs each block')
        self.epochs = epoch
        energy = float(metrics['energy'])
        if self.window_start is None:
            self.run.setup_parts[f'epoch{epoch}'] = now - self.started
            if epoch >= self.warm:
                self.window_start = now
                self.run.setup_s = now - self.started
        elif self.window_end is None:
            self.run.unit_s.append(now - self.last)
            self.run.failed += not math.isfinite(energy)
            if now - self.window_start >= self.seconds:
                self.window_end = now
                self.run.window_s = now - self.window_start
                if self.trace_seconds > 0:
                    self.tracer = Tracer()
                else:
                    self._stop(epoch)
        else:
            self.traced += 1
            if (now - self.tracer.start >= self.trace_seconds
                    and self.traced >= 2):
                self.run.trace = self.tracer.stop(self.traced, now)
                self._stop(epoch)
        self.last = now
