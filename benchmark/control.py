"""The readings that the limits of a cell are set from: for each seed, one
run of the cell (its window, then its check) with the numbers the program
gives, and the numbers the control gives on the same params and boards.
The control is the reference put in the program's place at the next
precision down, TF32 for the configurations' float32 with TF32 off.  The
benchmark's own runs never run it.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--out build/control]

Writes one JSON line a seed to <out>/<workload>.jsonl and prints it.
Needs the card, as run.py does.  Each seed runs in a process of its own,
as the benchmark's runs do: a process makes one capture of the loop's
graph, and the check sets the generators back after its replay.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, device: str = 'cuda',
             overrides=None) -> dict:
    from benchmark.harness import spec
    started = time.perf_counter()
    run, numbers, ctl = spec.driver(cell).run(
        cell, seed, seconds, False, started, device, control=True,
        overrides=overrides)
    return {'workload': cell.name, 'seed': seed, 'units': run.units,
            'program': numbers, 'control': ctl,
            'seconds': time.perf_counter() - started}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--out', default='build/control')
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(',')]
    if len(seeds) > 1:
        for seed in seeds:
            subprocess.run([sys.executable, __file__, '--workload',
                            args.workload, '--seeds', str(seed), '--seconds',
                            str(args.seconds), '--out', args.out],
                           check=True)
        return 0
    sys.path.insert(0, str(ROOT))
    from benchmark import run as run_py
    run_py._environment()
    import torch
    from benchmark.harness import spec
    if not torch.cuda.is_available():
        print('the control runs on the card', file=sys.stderr)
        return 1
    cell = spec.cell(args.workload, spec.load_benchmark())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    line = json.dumps(readings(cell, seeds[0], args.seconds))
    print(line, flush=True)
    with open(out / f'{args.workload}.jsonl', 'a') as f:
        f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
