"""A cell added as new files and new entries runs with no edit to any file
the benchmark has: a new traffic mix, its limits and a new metric reader,
in a copy of the benchmark."""

import json
import shutil
import time

from benchmark import run as run_py
from benchmark.harness import spec

READER = '''"""Training epochs in the window (a fixture's metric)."""


def read(run):
    return float(run.units) if run.kind == 'train' else None
'''


def test_a_cell_of_new_files_runs(tmp_path):
    shutil.copy(spec.ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(spec.HERE, tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in tmp_path.rglob('*') if p.is_file()}
    here = tmp_path / 'benchmark'
    mix = json.loads((here / 'traffic' / 'train_sr.json').read_text())
    mix['trace_seconds'] = 0.1
    mix['check_epochs'] = 1
    (here / 'traffic' / 'train_fixture.json').write_text(json.dumps(mix))
    (here / 'limits' / 'chain40_rbm.train_fixture.json').write_text(
        (here / 'limits' / 'chain40_rbm.train_sr.json').read_text())
    (here / 'metrics' / 'window_epochs.py').write_text(READER)

    bench = json.loads((tmp_path / 'BENCHMARK.json').read_text())
    bench['workloads'].append({
        'name': 'chain40_rbm.train_fixture', 'config': 'chain40_rbm',
        'traffic': 'train_fixture', 'chips': 1, 'why': 'a fixture'})
    for m in bench['end_to_end']:
        if m['name'] == 'train_samples_per_s':
            m['workloads'].append('chain40_rbm.train_fixture')
    bench['per_layer'].append({
        'name': 'window_epochs', 'unit': 'epochs', 'better': 'higher',
        'source': 'host_clock', 'layer': 'train.py + utils/cuda_graph.py',
        'moves': 'train_samples_per_s',
        'workloads': ['chain40_rbm.train_fixture']})
    # The one edit a later change makes: entries added to BENCHMARK.json.
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    del before[tmp_path / 'BENCHMARK.json']

    cell = spec.cell('chain40_rbm.train_fixture', bench, root=tmp_path)
    line = run_py.measure(
        cell, 11, 0.1, True, device='cpu', started=time.perf_counter(),
        overrides={'num_sites': 8, 'fc_layer_size': 16, 'batch_size': 32,
                   'num_equilibration_sweeps': 2}, replay='plain')
    assert line['correct'] is True
    assert line['metrics']['window_epochs']['value'] >= 1
    assert all(p.read_bytes() == data for p, data in before.items())
