"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'benchmark/run.py']
    assert BENCH['paths'] == ['benchmark']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert (runs * (BENCH['run_seconds'] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_names_units_and_keys():
    names = [c['name'] for c in BENCH['configs']] + CELLS + [
        m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/')
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in SOURCES
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
    for name in CELLS:
        c = spec.cell(name, BENCH)
        e2e = {m['name'] for m in c.end_to_end}
        assert 'setup_s' in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m['moves'] in e2e, (name, m['name'])


def undeclared_cuts(config_file: dict) -> list:
    """The reduced/cut rule: every field of ``config`` that differs from
    the repo's file it was copied from (a field either lacks counts) is
    listed in ``reduced`` and has its reason under ``cut``, and nothing
    else is; the fields that break the rule."""
    source = json.loads((spec.ROOT / config_file['copied_from']).read_text())
    config = config_file['config']
    changed = {k for k in set(config) | set(source)
               if config.get(k, source) != source.get(k, config)}
    declared = set(config_file['reduced'])
    return sorted(changed ^ declared | declared ^ set(
        config_file.get('cut', {})))


@pytest.mark.parametrize('name', CELLS)
def test_cell_resolves_to_its_files(name):
    c = spec.cell(name, BENCH)
    assert c.config['wavefunction_type']
    assert undeclared_cuts(c.config_file) == []
    assert spec.driver(c).run
    for m in c.end_to_end + c.per_layer:
        assert spec.metric_reader(c, m['name']).read
    assert spec.flops(c, c.config['wavefunction_type']).forward
    assert spec.flops(c, c.traffic['flops']).unit
    assert c.limits and all(v >= 0 for v in c.limits.values())


@pytest.mark.parametrize('name', [c['name'] for c in BENCH['configs']])
def test_config_file_holds_only_fields_of_the_port(name):
    from cgs_vmc_tpu_torch.config import Config
    entry = next(c for c in BENCH['configs'] if c['name'] == name)
    data = json.loads((spec.ROOT / entry['file']).read_text())
    assert set(data['config']) <= set(Config.__dataclass_fields__)
    assert data['reduced'] == entry['reduced']


def test_an_undeclared_cut_is_rejected():
    """The transformer's declared cut of batch_size passes; the same cut
    undeclared, a cut without its reason, and a declared key left as
    copied each fail."""
    c = spec.cell('square66_transformer.train_sr', BENCH).config_file
    assert c['reduced'] == ['batch_size'] and undeclared_cuts(c) == []
    cut = dict(c, config=dict(c['config'], num_attention_layers=2))
    assert undeclared_cuts(cut) == ['num_attention_layers']
    assert undeclared_cuts(dict(c, reduced=[], cut={})) == ['batch_size']
    assert undeclared_cuts(dict(c, cut={})) == ['batch_size']
    same = dict(c, config=dict(c['config'], batch_size=1024))
    assert undeclared_cuts(same) == ['batch_size']
