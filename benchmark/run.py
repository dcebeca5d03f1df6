"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic, limits and metric readers are found
by name from BENCHMARK.json (harness/spec.py).  With --trace 0 the line
carries the cell's end-to-end metrics, with --trace 1 its per-layer ones
and a breakdown of the traced window.  The numbers that decide `correct`
are printed beside their limits as the last lines of standard error, and
under "checks", the line's last key.

Exits 1, printing no result, without CUDA or with fewer cards than the
cell asks for, and when the JAX package or JAX itself was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'cgs_vmc_tpu')


def _environment() -> None:
    """Every compiler cache at a fixed path inside the checkout, and one
    thread in each of the host's thread pools: the run's host work is one
    Python loop, and idle pool threads spinning on a shared machine only
    add noise."""
    for pool in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
        os.environ[pool] = '1'
    build = ROOT / 'build'
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['TORCHINDUCTOR_CACHE_DIR'] = str(build / 'inductor_cache')


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split('.')[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _number(value):
    value = float(value)
    return value if math.isfinite(value) else None


def _power_limit():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _device(device: str, chips: int, run, trace: bool) -> dict:
    import torch
    if device == 'cuda':
        info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': chips, 'memory_peak_bytes': run.memory_peak_bytes,
                'power_limit': _power_limit()}
    else:
        info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    if trace and run.trace is not None:
        info['busy_s'] = run.trace.busy_s
        info['window_s'] = run.trace.window_s
    return info


def measure(cell, seed: int, seconds: float, trace: bool,
            device: str = 'cuda', started: float = STARTED,
            overrides=None, **options) -> dict:
    """One run of `cell`: the result line as a dict (`options` go to the
    driver)."""
    from benchmark.harness import check, spec
    from benchmark.harness.trace import breakdown
    run, numbers, _ = spec.driver(cell).run(
        cell, seed, seconds, trace, started, device, overrides=overrides,
        **options)
    checks = check.judge(numbers, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(cell, m['name']).read(run)
        if value is not None and math.isfinite(value):
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    line = {'correct': all(c['ok'] for c in checks.values()),
            'attempted': run.units, 'failed': run.failed,
            'metrics': metrics,
            'device': _device(device, cell.chips, run, trace)}
    if trace and run.trace is not None:
        line['breakdown'] = breakdown(run.trace)
    line['checks'] = {name: {'value': _number(c['value']),
                             'limit': c['limit']}
                      for name, c in checks.items()}
    print('setup ' + ' '.join(f'{k} {v:.3f}' for k, v in
                              run.setup_parts.items())
          + f' (s from the start); check {run.check_s:.3f} s',
          file=sys.stderr)
    check.report(checks)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec
    cell = spec.cell(args.workload, spec.load_benchmark())
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA card(s); found '
              f'{found}', file=sys.stderr)
        return 1
    line = measure(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f'the run loaded {loaded}; nothing of JAX or the JAX package '
              'may run here', file=sys.stderr)
        return 1
    print(json.dumps(line))
    return 0


if __name__ == '__main__':
    sys.exit(main())
