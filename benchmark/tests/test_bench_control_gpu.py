"""On the card: the control (the reference at TF32 in the program's
place) fails a limit of every cell, and the program keeps within them, at
the cell's own sizes with a window of one epoch or call (~5 minutes in
all, most of it the flagship's set-up), each seed a process of its own.

    python -m pytest benchmark/tests -m gpu
"""

import json
import math
import subprocess
import sys

import pytest
import torch

from benchmark.harness import spec

BENCH = spec.load_benchmark()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return 'cuda'


def _fails(numbers, limits):
    return [k for k, v in numbers.items()
            if k in limits and not (math.isfinite(v) and v <= limits[k])]


@pytest.mark.gpu
@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_control_fails_and_program_holds(name, card, tmp_path):
    cell = spec.cell(name, BENCH)
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        out = subprocess.run(
            [sys.executable, 'benchmark/control.py', '--workload', name,
             '--seeds', str(seed), '--seconds', '0', '--out', str(tmp_path)],
            cwd=spec.ROOT, capture_output=True, text=True, check=True)
        r = json.loads(out.stdout.splitlines()[-1])
        print(json.dumps(r))
        assert not _fails(r['program'], cell.limits), r
        assert _fails(r['control'], cell.limits), r
