"""The port's own copies of the JAX package's jax-free modules (config,
lattice, utils/metrics and the CLI's flag helpers) against the originals,
on the CPU: the same configs/*.json, overrides, bonds and metric lines."""

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import pytest

from cgs_vmc_tpu import cli as jax_cli
from cgs_vmc_tpu import config as jax_config
from cgs_vmc_tpu import lattice as jax_lattice
from cgs_vmc_tpu.utils import metrics as jax_metrics
from cgs_vmc_tpu_torch import cli, config, lattice
from cgs_vmc_tpu_torch.utils import metrics

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG_FILES = sorted(str(p.relative_to(REPO))
                      for p in (REPO / 'configs').glob('*.json'))


def test_config_fields_and_defaults_agree():
    ours = [(f.name, f.type) for f in dataclasses.fields(config.Config)]
    theirs = [(f.name, f.type) for f in dataclasses.fields(jax_config.Config)]
    assert ours == theirs
    assert (dataclasses.asdict(config.Config())
            == dataclasses.asdict(jax_config.Config()))


@pytest.mark.parametrize('path', CONFIG_FILES)
def test_config_files_load_alike(path, tmp_path):
    ours = config.Config.load(str(REPO / path))
    theirs = jax_config.Config.load(str(REPO / path))
    assert ours.to_json() == theirs.to_json()
    # A config.json written by either package loads in the other.
    ours.save(str(tmp_path / 'a' / 'config.json'))
    theirs.save(str(tmp_path / 'b' / 'config.json'))
    assert (jax_config.Config.load(str(tmp_path / 'a' / 'config.json'))
            == theirs)
    assert config.Config.load(str(tmp_path / 'b' / 'config.json')) == ours


OVERRIDES = [
    '',
    'num_sites=8,wavefunction_type=rbm,batch_size=64',
    'learning_rates=[5e-2;1e-3],learning_rate_stops=[10]',
    'symmetrize=true,resnet_bottleneck=0,heisenberg_jx=-1.0',
    'composite_wavefunction_types=(rbm;fc),orthogonal_to=[a;b]',
    ' seed = 7 , ,sr_solver=dense_cg',
]


@pytest.mark.parametrize('override', OVERRIDES)
def test_parse_overrides_agree(override):
    ours = config.parse_overrides(config.Config(), override)
    theirs = jax_config.parse_overrides(jax_config.Config(), override)
    assert ours == theirs
    assert (config.Config().parse(override).to_json()
            == jax_config.Config().parse(override).to_json())


@pytest.mark.parametrize('override', ['nonsense_field=1', 'num_sites',
                                      'symmetrize=maybe'])
def test_parse_overrides_refuse_alike(override):
    with pytest.raises(ValueError) as ours:
        config.Config().parse(override)
    with pytest.raises(ValueError) as theirs:
        jax_config.Config().parse(override)
    assert str(ours.value) == str(theirs.value)


SIZES = [(1, 1), (1, 4), (2, 2), (2, 3), (3, 4), (4, 4), (5, 3), (6, 6)]
BUILDERS_2D = ['square_lattice_bonds', 'triangular_lattice_bonds',
               'honeycomb_lattice_bonds', 'kagome_lattice_bonds']


@pytest.mark.parametrize('name', BUILDERS_2D)
@pytest.mark.parametrize('periodic', [True, False])
def test_2d_bond_builders_agree(name, periodic):
    for size_x, size_y in SIZES:
        ours = getattr(lattice, name)(size_x, size_y, periodic)
        theirs = getattr(jax_lattice, name)(size_x, size_y, periodic)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize('periodic', [True, False])
def test_chain_bond_builders_agree(periodic):
    for n in (3, 4, 5, 8, 40):
        np.testing.assert_array_equal(lattice.chain_bonds(n, periodic),
                                      jax_lattice.chain_bonds(n, periodic))
        for ours, theirs in zip(lattice.j1j2_chain_bonds(n, periodic),
                                jax_lattice.j1j2_chain_bonds(n, periodic)):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
    for size_x, size_y in SIZES[2:]:
        for ours, theirs in zip(lattice.j1j2_square_bonds(size_x, size_y),
                                jax_lattice.j1j2_square_bonds(size_x,
                                                              size_y)):
            np.testing.assert_array_equal(ours, theirs)


def _resolve(module, cfg):
    try:
        return module.bonds_and_couplings_for_config(cfg)
    except ValueError as err:
        return ('ValueError', str(err))


def _assert_same_bonds(ours, theirs):
    if isinstance(theirs[0], str):
        assert ours == theirs
        return
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert (ours[1] is None) == (theirs[1] is None)
    if theirs[1] is not None:
        np.testing.assert_array_equal(ours[1], theirs[1])


@pytest.mark.parametrize('path', CONFIG_FILES)
def test_bonds_for_config_files_agree(path):
    ours = config.Config.load(str(REPO / path))
    theirs = jax_config.Config.load(str(REPO / path))
    _assert_same_bonds(_resolve(lattice, ours), _resolve(jax_lattice, theirs))


@pytest.mark.parametrize('override', [
    'num_sites=16,size_x=4,size_y=4',
    'num_sites=12,size_x=4,size_y=3,lattice_type=triangular',
    'num_sites=18,size_x=3,size_y=3,lattice_type=honeycomb',
    'num_sites=27,size_x=3,size_y=3,lattice_type=kagome',
    'num_sites=10,heisenberg_j2=0.5',
    'num_sites=16,size_x=4,size_y=4,heisenberg_j2=0.3',
    'num_sites=12,size_x=4,size_y=3,lattice_type=triangular,heisenberg_j2=1',
    'num_sites=10,size_x=4,size_y=4,lattice_type=honeycomb',
    'num_sites=9,lattice_type=hexagonal',
])
def test_bonds_for_config_dispatch_agrees(override):
    _assert_same_bonds(_resolve(lattice, config.Config().parse(override)),
                       _resolve(jax_lattice,
                                jax_config.Config().parse(override)))


def test_bond_files_load_alike(tmp_path):
    rows = np.array([[0, 1, 1.0], [1, 2, 0.5], [2, 0, -0.25]])
    with_j = tmp_path / 'J3.txt'
    np.savetxt(with_j, rows)
    plain = tmp_path / 'J2.txt'
    np.savetxt(plain, rows[:, :2], fmt='%d')
    for path in (with_j, plain):
        np.testing.assert_array_equal(lattice.load_bonds(str(path)),
                                      jax_lattice.load_bonds(str(path)))
        _assert_same_bonds(lattice.load_bonds_and_couplings(str(path)),
                           jax_lattice.load_bonds_and_couplings(str(path)))
    cfg = f'num_sites=3,j_file_path={with_j}'
    _assert_same_bonds(_resolve(lattice, config.Config().parse(cfg)),
                       _resolve(jax_lattice, jax_config.Config().parse(cfg)))


@pytest.mark.parametrize('override', [
    'num_sites=8,heisenberg_j2=0.4',
    'num_sites=16,size_x=4,size_y=4,heisenberg_j2=0.5',
    'num_sites=36,size_x=6,size_y=6,heisenberg_j2=0.2',
])
def test_j1j2_marshall_gauged_agrees(override):
    ours = lattice.j1j2_marshall_gauged(config.Config().parse(override))
    theirs = jax_lattice.j1j2_marshall_gauged(
        jax_config.Config().parse(override))
    for x, y in zip(ours, theirs):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('direction', ['x', 'y'])
@pytest.mark.parametrize('phi', [0.0, 0.3, -2.4])
def test_twist_phases_agree(direction, phi):
    cases = [(lattice.chain_bonds(n), n, 1) for n in (4, 8, 16)]
    cases += [(lattice.square_lattice_bonds(x, y), x, y)
              for x, y in ((4, 4), (3, 4), (6, 6))]
    cases += [(lattice.j1j2_chain_bonds(8)[0], 8, 1),
              (lattice.j1j2_square_bonds(4, 4)[0], 4, 4)]
    for bonds, size_x, size_y in cases:
        ours = lattice.twist_phases(size_x * size_y, bonds, phi, size_x,
                                    size_y, direction)
        theirs = jax_lattice.twist_phases(size_x * size_y, bonds, phi,
                                          size_x, size_y, direction)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError, match='direction'):
        lattice.twist_phases(4, lattice.chain_bonds(4), 0.3, 4,
                             direction='z')


def test_adjacency_helpers_agree(tmp_path):
    for bonds, n in ((lattice.chain_bonds(6), 6),
                     (lattice.chain_bonds(5, periodic=False), 5),
                     (lattice.square_lattice_bonds(3, 4), 12),
                     (lattice.triangular_lattice_bonds(3, 3), 9),
                     (lattice.kagome_lattice_bonds(2, 2, False), 12)):
        ours = lattice.adjacency_from_bonds(bonds, n)
        theirs = jax_lattice.adjacency_from_bonds(bonds, n)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    path = tmp_path / 'adj.txt'
    np.savetxt(path, lattice.adjacency_from_bonds(lattice.chain_bonds(6), 6),
               fmt='%d')
    ours = lattice.load_adjacency(str(path))
    assert ours.dtype == np.int32 and ours.shape == (6, 2)
    np.testing.assert_array_equal(ours, jax_lattice.load_adjacency(str(path)))


ARGV = [
    [],
    ['--config', 'configs/chain40_sr.json'],
    ['--config', 'configs/square66_conv_sr.json', '--num_epochs', '3',
     '--seed', '5', '--override', 'batch_size=16,num_conv_filters=8'],
    ['--checkpoint_dir', 'run', '--num_sites', '12', '--wavefunction_type',
     'rbm', '--optimizer_type', 'SR', '--heisenberg_jx', '-1'],
]


@pytest.mark.parametrize('argv', ARGV)
def test_build_config_agrees(argv, monkeypatch):
    monkeypatch.chdir(REPO)

    def build(module):
        parser = argparse.ArgumentParser()
        module._add_common(parser)
        args = parser.parse_args(argv)
        return module._build_config(args, default_optimizer='ITSWO',
                                    base=module._resume_base(args))

    assert build(cli).to_json() == build(jax_cli).to_json()


def test_resume_base_reads_the_run_config_alike(tmp_path):
    config.Config(num_sites=12, seed=3).save(str(tmp_path / 'config.json'))
    args = argparse.Namespace(resume=True, config='',
                              checkpoint_dir=str(tmp_path))
    assert (cli._resume_base(args).to_json()
            == jax_cli._resume_base(args).to_json())


def test_metrics_logger_writes_the_same_lines(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(time, 'time', lambda: 1000.0)
    records = [(1, {'energy': -3.5, 'acceptance_rate': np.float32(0.25)}),
               (2, {'energy': -3.75, 'note': 'text', 'grad_norm': 1e-7}),
               (3, {'acceptance_rate': 0.5})]
    printed = {}
    for name, module in (('ours', metrics), ('theirs', jax_metrics)):
        logger = module.MetricsLogger(str(tmp_path / name), print_every=2)
        for epoch, values in records:
            logger.log(epoch, values)
        printed[name] = capsys.readouterr().out
    assert printed['ours'] == printed['theirs'] != ''
    for file in ('metrics.jsonl', 'metrics.txt'):
        ours = (tmp_path / 'ours' / file).read_text()
        assert ours == (tmp_path / 'theirs' / file).read_text()
    assert len((tmp_path / 'ours' / 'metrics.jsonl').read_text()
               .splitlines()) == 3
    assert json.loads((tmp_path / 'ours' / 'metrics.jsonl').read_text()
                      .splitlines()[1])['note'] == 'text'
