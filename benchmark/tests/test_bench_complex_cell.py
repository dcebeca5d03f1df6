"""A J1–J2 cell with a complex log ψ, added as new files and entries in a
copy of the benchmark, end to end on the CPU: the 4×4 torus at J2/J1 =
0.5 with the port's `complex` composite (modulus and phase networks
fully connected) under the SR mix.  It reads `correct`, and each fault
planted underneath a whole run fails a check: the phase zeroed in the
sampler's cached log ψ, the program's J2 bonds dropped, one local energy
off where it is produced.

The cell's limits (`LIMITS`) sit between what sound runs read and what
the faults read, on the CPU with ``replay='plain'``: sound runs on the
12 seeds 2 ** 31 + 100 .. 111 read cache_gap 0 (the same float32
products on both sides), energy_gap 0–1.66e-7, step_gap 2.2e-6–3.33e-5,
change_gap 3.7e-6–1.77e-5; on 3 of those seeds the zeroed phase reads
cache_gap 0.43–1.14, the dropped J2 bonds energy_gap 0.334 (step_gap
0.29–0.34), the altered local energy energy_gap 6.6e-4–7.9e-4 (step_gap
0.033–0.20)."""

import json
import shutil
import time

import pytest
import torch

from benchmark import run as run_py
from benchmark.harness import spec
from cgs_vmc_tpu_torch import lattice as port_lattice
from cgs_vmc_tpu_torch.sampler import metropolis

CELL = 'square44_j1j2_complex.train_sr'
LIMITS = {'sector_violations': 0, 'frozen_blocks': 0, 'epochs_missed': 0,
          'twin_mismatch': 0, 'twin_gap': 0, 'cache_gap': 1e-5,
          'energy_gap': 1e-6, 'step_gap': 2e-4, 'change_gap': 2e-4}
SEEDS = [2 ** 31 + 100 + k for k in range(3)]


@pytest.fixture(scope='module')
def cell(tmp_path_factory):
    """The copy of the benchmark with the cell's configuration, limits and
    entries added; nothing of the benchmark's own files changed."""
    root = tmp_path_factory.mktemp('bench')
    shutil.copy(spec.ROOT / 'BENCHMARK.json', root)
    shutil.copytree(spec.HERE, root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in root.rglob('*') if p.is_file()}
    here = root / 'benchmark'
    config = json.loads((spec.ROOT / 'configs'
                         / 'j1j2_chain8_complex_sr.json').read_text())
    config.update(num_sites=16, size_x=4, size_y=4, batch_size=32,
                  num_equilibration_sweeps=2)
    (here / 'configs' / 'square44_j1j2_complex.json').write_text(
        json.dumps({'name': 'square44_j1j2_complex',
                    'copied_from': 'configs/j1j2_chain8_complex_sr.json',
                    'reduced': [], 'config': config}))
    (here / 'limits' / f'{CELL}.json').write_text(json.dumps(LIMITS))
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'square44_j1j2_complex', 'source': 'a fixture',
        'file': 'benchmark/configs/square44_j1j2_complex.json',
        'reduced': [], 'why': 'a fixture'})
    bench['workloads'].append({
        'name': CELL, 'config': 'square44_j1j2_complex',
        'traffic': 'train_sr', 'chips': 1, 'why': 'a fixture'})
    for m in bench['end_to_end']:
        if 'workloads' in m and 'square66_conv.train_sr' in m['workloads']:
            m['workloads'].append(CELL)
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    del before[root / 'BENCHMARK.json']
    yield spec.cell(CELL, bench, root=root)
    assert all(p.read_bytes() == data for p, data in before.items())


def _measure(cell, seed):
    return run_py.measure(cell, seed, 0.1, False, device='cpu',
                          started=time.perf_counter(), replay='plain')


def _failed(line):
    return [k for k, c in line['checks'].items()
            if c['value'] is None or c['value'] > c['limit']]


@pytest.mark.parametrize('seed', SEEDS)
def test_the_complex_cell_reads_correct(cell, seed):
    line = _measure(cell, seed)
    assert line['correct'] is True, line['checks']
    assert set(line['checks']) == set(LIMITS)
    assert line['attempted'] >= 1 and line['failed'] == 0


def _phase_zeroed(monkeypatch):
    """The sampler's cached log ψ keeps log|ψ| and loses the phase."""
    orig = metropolis.run_sweeps

    def run_sweeps(*args, **kwargs):
        out = orig(*args, **kwargs)
        log = out.log_amp
        return out._replace(log_amp=torch.complex(log.real,
                                                  torch.zeros_like(log.real)))
    monkeypatch.setattr(metropolis, 'run_sweeps', run_sweeps)


def _j2_dropped(monkeypatch):
    """The program's J1–J2 torus without its diagonal bonds."""
    def square(size_x, size_y):
        nearest = port_lattice.square_lattice_bonds(size_x, size_y)
        return nearest, torch.zeros(len(nearest)).numpy()
    monkeypatch.setattr(port_lattice, 'j1j2_square_bonds', square)


def _altered_answer(monkeypatch):
    tests = spec.load_module(spec.HERE / 'tests' / 'test_bench_drivers.py')
    tests.FAULTS['altered_answer'](monkeypatch)


@pytest.mark.parametrize('fault,caught', [
    (_phase_zeroed, 'cache_gap'), (_j2_dropped, 'energy_gap'),
    (_altered_answer, 'energy_gap')],
    ids=['phase_zeroed', 'j2_dropped', 'altered_answer'])
def test_a_planted_fault_fails_a_check(cell, fault, caught, monkeypatch):
    fault(monkeypatch)
    line = _measure(cell, SEEDS[0])
    assert line['correct'] is False
    assert caught in _failed(line), line['checks']
