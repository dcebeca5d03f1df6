"""Structured metrics stream: stdout + JSONL + reference-compatible metrics.txt
(the port's own copy of cgs_vmc_tpu/utils/metrics.py; same lines written).

The reference appended one scalar per epoch to ``metrics.txt``
(cgs_vmc/run_training.py:142-153) and TODO-stubbed everything else
(acceptance-rate reporting, cgs_vmc/evaluation.py:141-151).  Here every
epoch emits a full JSON record (energy mean/variance, acceptance rate,
gradient norm, timing) to ``metrics.jsonl``, plus the legacy single-scalar
``metrics.txt`` for drop-in parity.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:

    def __init__(self, directory: Optional[str] = None,
                 print_every: int = 1, primary: str = 'energy'):
        self.directory = directory
        self.print_every = max(print_every, 1)
        self.primary = primary
        self._t_start = time.time()
        self._t_last = self._t_start
        if directory:
            os.makedirs(directory, exist_ok=True)

    def log(self, epoch: int, metrics: Dict) -> None:
        now = time.time()
        record = {'epoch': int(epoch),
                  'wall_time_s': round(now - self._t_start, 3),
                  'epoch_time_s': round(now - self._t_last, 3)}
        self._t_last = now
        for name, value in metrics.items():
            try:
                record[name] = float(value)
            except (TypeError, ValueError):
                record[name] = value

        if self.directory:
            with open(os.path.join(self.directory, 'metrics.jsonl'), 'a') as f:
                f.write(json.dumps(record) + '\n')
            primary_value = record.get(self.primary)
            if primary_value is not None:
                with open(os.path.join(self.directory, 'metrics.txt'),
                          'a') as f:
                    f.write(f'{primary_value}\n')

        if epoch % self.print_every == 0:
            parts = [f'epoch {record["epoch"]:5d}']
            for name in sorted(record):
                if name in ('epoch',):
                    continue
                value = record[name]
                if isinstance(value, float):
                    parts.append(f'{name}={value:.6g}')
            print('  '.join(parts), flush=True)
