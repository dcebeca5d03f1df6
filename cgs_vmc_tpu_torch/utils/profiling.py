"""Profiling hooks (port of cgs_vmc_tpu/utils/profiling.py): a
``torch.profiler`` trace around a range of training epochs, and an epoch
timer that waits for the device.

`train` traces the second call of its epoch function into
``config.profile_dir`` (the first pays the one-time costs: kernel builds,
cuBLAS handles, allocator growth).  The trace is a Chrome-trace JSON,
``<host>_<pid>.<time>.pt.trace.json`` (TensorBoard's profiler plugin and
chrome://tracing read it), with the host's operators and, on a card, the
CUDA kernels each launched — the sweep kernels, the local-energy fan-out,
the collectives.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def synchronize(result) -> None:
    """Waits for the devices of every tensor in `result` (nested dicts,
    lists and tuples)."""
    devices = set()

    def walk(node):
        if isinstance(node, dict):
            for value in node.values():
                walk(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                walk(value)
        elif isinstance(node, torch.Tensor) and node.is_cuda:
            devices.add(node.device)

    walk(result)
    for device in devices:
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


class EpochTimer:
    """Wall-clock phase timing that waits for the device once a lap (the
    counterpart of jax.block_until_ready on the lap's result)."""

    def __init__(self):
        self._start = time.perf_counter()
        self.history: list[float] = []

    def lap(self, result=None) -> float:
        if result is not None:
            synchronize(result)
        now = time.perf_counter()
        elapsed = now - self._start
        self._start = now
        self.history.append(elapsed)
        return elapsed
