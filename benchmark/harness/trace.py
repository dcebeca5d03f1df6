"""The traced part of a run: a torch.profiler window over whole epochs or
calls, kept in memory, reduced to the numbers the per-layer metrics read.

Device events are the kernels, copies and sets the card ran (a graph
replay's kernels are events too).  Busy time is the union of their
intervals, so overlapping events count once.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

_TOP = 10


@dataclasses.dataclass
class TraceSummary:
    units: int                    # whole epochs or calls traced
    window_s: float               # host clock over those units
    busy_s: float                 # union of the device intervals
    kernels: int                  # kernel events (copies and sets apart)
    device_events: int
    by_name: Dict[str, float]     # device seconds by event name
    idle_gaps: List[Tuple[str, float]]


def union_seconds(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, float('-inf')
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def gaps(spans) -> List[Tuple[float, float]]:
    """The (start, end) holes between the merged intervals."""
    out, end = [], None
    for start, stop in sorted(spans):
        if end is not None and start > end:
            out.append((end, start))
        end = stop if end is None else max(end, stop)
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(('Memcpy', 'Memset', 'cudaMemcpy',
                                'cudaMemset'))


def _host_label(host: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host event running at time t."""
    inside = [(stop - start, name) for start, stop, name in host
              if start <= t <= stop]
    return min(inside)[1] if inside else 'host between operations'


class Tracer:
    """Start it at a unit boundary, `stop` it at a later one (both after a
    synchronize); `summary` then holds what the window showed."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self.start = time.perf_counter()
        self.summary: Optional[TraceSummary] = None

    def stop(self, units: int, end: float) -> TraceSummary:
        self._prof.stop()
        events = self._prof.events()
        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in events:
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == cuda:
                device.append((*span, e.name))
            else:
                host.append((*span, e.name))
        spans = [(a, b) for a, b, _ in device]
        by_name: Dict[str, float] = collections.defaultdict(float)
        for a, b, name in device:
            by_name[name] += (b - a) * 1e-6
        holes = sorted(gaps(spans), key=lambda g: g[0] - g[1])[:_TOP]
        idle = [(_host_label(host, (a + b) / 2), (b - a) * 1e-6)
                for a, b in holes]
        self.summary = TraceSummary(
            units=units, window_s=end - self.start,
            busy_s=union_seconds(spans) * 1e-6,
            kernels=sum(is_kernel(name) for _, _, name in device),
            device_events=len(device), by_name=dict(by_name),
            idle_gaps=idle)
        self._prof = None
        return self.summary


def breakdown(summary: TraceSummary) -> dict:
    top = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    return {'device_ops': [[name[:160], s] for name, s in top],
            'idle_gaps': [[name[:160], s] for name, s in summary.idle_gaps]}
