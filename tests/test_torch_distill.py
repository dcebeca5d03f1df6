"""Distillation's parts in the port against the JAX package, and its CLI.

The models (FullVector bit for bit, the FC network to 1e-5), the exact
evaluators (rtol 1e-5), the basis-file reader and the ED copy; then, on the
CPU at N=8, the CLI: `train` defaults to ITSWO and resumes exactly, and
`distill --supervisor_dir` -> `eval` -> `dump` on the distilled run, with an
exact resume of the dual-sampling and basis-iteration optimizers.
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

from cgs_vmc_tpu import basis as jax_basis
from cgs_vmc_tpu import lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.evaluate import evaluate_vector as jax_evaluate_vector
from cgs_vmc_tpu.evaluate import exact_expectation as jax_exact
from cgs_vmc_tpu.evaluate import overlap_with_vector as jax_overlap
from cgs_vmc_tpu.models import FullVector as JaxFullVector
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops.heisenberg import HeisenbergHamiltonian as JaxHeisenberg
from cgs_vmc_tpu.utils import ed as jax_ed
from cgs_vmc_tpu_torch import basis, cli, models
from cgs_vmc_tpu_torch.evaluate import (
    evaluate_vector, exact_expectation, overlap_with_vector)
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.train import train
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils import ed, interop

N = 8
BONDS = lattice.chain_bonds(N)
E0, V0 = jax_ed.ground_state(N, BONDS, j_x=-1.0)


def _noisy_params(jax_wf, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))


@pytest.mark.parametrize('j_x', [-1.0, 1.0])
def test_full_vector_matches_jax_and_is_an_eigenstate(j_x):
    """logψ and sign on all 70 states equal JAX's bit for bit (the
    Marshall-gauged ground state is positive, the plain one signed), and
    the ED vector's local energy is E0 on every state."""
    e0, v0 = jax_ed.ground_state(N, BONDS, j_x=j_x)
    vector = v0.astype(np.float32)
    states = jax_basis.enumerate_sz_basis(N)
    jax_fv = JaxFullVector.for_sector(N, vector)
    jax_amp = jax_fv.apply(jax_fv.init(jax.random.key(0)), states)
    fv = FullVector.for_sector(N, vector)
    params = fv.init(torch.Generator())
    configs = torch.tensor(states)
    amp = fv.apply(params, configs)
    np.testing.assert_array_equal(amp.log.numpy(), np.asarray(jax_amp.log))
    np.testing.assert_array_equal(amp.sign.numpy(), np.asarray(jax_amp.sign))
    e_loc = HeisenbergHamiltonian(BONDS, j_x, 1.0).local_value(
        fv, params, configs).double()
    assert float(e_loc.var()) < 1e-8
    np.testing.assert_allclose(float(e_loc.mean()), e0, rtol=1e-5)


def test_lin_index_takes_device_tables():
    """Repair: the tables may be tensors that already live on the configs'
    device; FullVector makes them once a device and reuses them."""
    top, bot = basis.make_lin_tables(N)
    configs = torch.tensor(basis.enumerate_sz_basis(N))
    from_numpy = basis.lin_index(configs, top, bot)
    from_tensors = basis.lin_index(configs, torch.as_tensor(top),
                                   torch.as_tensor(bot))
    assert torch.equal(from_numpy, from_tensors)
    assert sorted(from_numpy.tolist()) == list(range(70))
    fv = FullVector.for_sector(N, np.abs(V0))
    params = fv.init(torch.Generator())
    fv.apply(params, configs)
    tables = fv._tables[torch.device('cpu')]
    fv.apply(params, configs[:5])
    assert fv._tables[torch.device('cpu')] is tables
    assert all(t.dtype == torch.int64 for t in tables)


@pytest.mark.parametrize('activation', ['exp', 'tanh'])
def test_fully_connected_matches_jax(activation):
    config = Config(num_sites=N, wavefunction_type='fully_connected',
                    num_fc_layers=2, fc_layer_size=12,
                    output_activation=activation)
    jax_wf = jax_build(config)
    params = _noisy_params(jax_wf, 2)
    states = jax_basis.enumerate_sz_basis(N)
    jax_amp = jax_wf.apply(params, states)
    wf = models.build_wavefunction(config)
    tparams = interop.params_from_numpy(params, 'cpu')
    amp = wf.apply(tparams, torch.tensor(states))
    np.testing.assert_allclose(amp.log.numpy(), np.asarray(jax_amp.log),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(amp.sign.numpy(), np.asarray(jax_amp.sign))
    assert set(wf.init(torch.Generator())) == {'dense_0', 'dense_1', 'out'}


def test_exact_evaluators_match_jax(tmp_path):
    """evaluate_vector (values, order, the written file), exact_expectation
    and overlap_with_vector within rtol 1e-5 of JAX's, on an RBM with a
    chunk size that leaves a partial last chunk."""
    config = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=1,
                    fc_layer_size=8, batch_size=32)
    jax_wf = jax_build(config)
    params = _noisy_params(jax_wf, 4)
    jax_psi = jax_evaluate_vector(jax_wf, params, config,
                                  output_path=str(tmp_path / 'jax.txt'))
    wf = models.build_wavefunction(config)
    tparams = interop.params_from_numpy(params, 'cpu')
    psi = evaluate_vector(wf, tparams, config,
                          output_path=str(tmp_path / 'port.txt'))
    np.testing.assert_allclose(psi, jax_psi, rtol=1e-5, atol=1e-7)
    assert np.max(np.abs(psi)) == 1.0

    def read(name):
        with open(tmp_path / name) as f:
            return np.array([complex(line.strip().replace(',', '+')
                                     .replace('+-', '-').replace('(', '')
                                     .replace(')', 'j'))
                             for line in f])
    np.testing.assert_allclose(read('port.txt'), read('jax.txt'), rtol=1e-5,
                               atol=1e-7)

    jax_e = jax_exact(jax_wf, params, JaxHeisenberg(BONDS, -1.0, 1.0), N,
                      batch=24)
    e = exact_expectation(wf, tparams, HeisenbergHamiltonian(BONDS, -1.0,
                                                             1.0), N,
                          batch=24)
    np.testing.assert_allclose(e, jax_e, rtol=1e-5)
    assert e > E0
    np.testing.assert_allclose(overlap_with_vector(psi, V0),
                               jax_overlap(jax_psi, V0), rtol=1e-5)
    assert overlap_with_vector(V0, -2.0 * V0) == pytest.approx(1.0)


def test_basis_file_and_ed_copy_match_originals(tmp_path):
    states = jax_basis.enumerate_sz_basis(N)
    path = str(tmp_path / 'basis.txt')
    jax_basis.save_basis_file(path, states[::3])
    np.testing.assert_array_equal(basis.load_basis_file(path),
                                  jax_basis.load_basis_file(path))
    for j_x in (-1.0, 1.0):
        np.testing.assert_array_equal(
            ed.heisenberg_matrix(N, BONDS, j_x, 1.0),
            jax_ed.heisenberg_matrix(N, BONDS, j_x, 1.0))
        np.testing.assert_array_equal(
            ed.heisenberg_matrix(N, BONDS, j_x, 1.0, sparse=True).toarray(),
            jax_ed.heisenberg_matrix(N, BONDS, j_x, 1.0,
                                     sparse=True).toarray())
        e0, v0 = ed.ground_state(N, BONDS, j_x=j_x)
        jax_e0, jax_v0 = jax_ed.ground_state(N, BONDS, j_x=j_x)
        assert e0 == jax_e0
        np.testing.assert_array_equal(v0, jax_v0)
        assert (ed.rayleigh_quotient(v0, N, BONDS, j_x)
                == jax_ed.rayleigh_quotient(v0, N, BONDS, j_x))


# ----------------------------------------------------------------------
# The CLI at N=8 on the CPU.
# ----------------------------------------------------------------------

_RUN = ('num_sites=8,wavefunction_type=rbm,num_fc_layers=0,fc_layer_size=8,'
        'batch_size=32,num_batches_per_epoch=2,num_equilibration_sweeps=2,'
        'heisenberg_jx=-1.0,learning_rates=[1e-2],learning_rate_stops=[],'
        'num_evaluation_samples=20')


def _train(run_dir, epochs, *extra):
    return cli.main(['train', '--checkpoint_dir', str(run_dir), '--device',
                     'cpu', '--num_epochs', str(epochs), '--override', _RUN,
                     *extra])


def _distill(supervisor, run_dir, epochs, *extra, student='rbm'):
    override = _RUN.replace('wavefunction_type=rbm',
                            f'wavefunction_type={student}')
    return cli.main(['distill', '--supervisor_dir', str(supervisor),
                     '--checkpoint_dir', str(run_dir), '--device', 'cpu',
                     '--num_epochs', str(epochs), '--override', override,
                     *extra])


def _latest(run_dir):
    return ckpt_lib.restore_checkpoint(
        ckpt_lib.latest_checkpoint(str(run_dir)), 'cpu')


def _last_record(run_dir):
    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        return json.loads(f.readlines()[-1])


def _assert_same_params(a, b):
    for x, y in zip(jax.tree.leaves(interop.params_to_numpy(a)),
                    jax.tree.leaves(interop.params_to_numpy(b))):
        np.testing.assert_array_equal(x, y)


def test_itswo_is_the_default_and_train_config_runs_it():
    """`train(Config(...))` with no optimizer type runs ITSWO, as the JAX
    package does."""
    config = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                    fc_layer_size=8, batch_size=16, num_batches_per_epoch=2,
                    num_equilibration_sweeps=1, num_epochs=2,
                    heisenberg_jx=-1.0)
    assert config.wavefunction_optimizer_type == ''
    state = train(config, 'cpu')
    assert float(state.extra['ema_count']) == 4.0
    assert set(state.extra) == {'omega', 'ite_normalization', 'ema_norm',
                                'ema_energy', 'ema_count'}


def test_cli_train_defaults_to_itswo_and_resumes_exactly(tmp_path):
    """No --optimizer_type: ITSWO.  A run cut after 2 epochs and resumed to
    3 ends bitwise where an uncut run ends: params, ω, the EMA scalars,
    the chains and their generator."""
    straight, resumed = tmp_path / 'straight', tmp_path / 'resumed'
    assert _train(straight, 3) == 0
    assert _train(resumed, 2) == 0
    assert _train(resumed, 3, '--resume') == 0
    with open(straight / 'config.json') as f:
        assert json.load(f)['wavefunction_optimizer_type'] == 'ITSWO'
    a, b = _latest(straight), _latest(resumed)
    assert a.epoch == b.epoch == 3
    _assert_same_params(a.params, b.params)
    _assert_same_params(a.extra['omega'], b.extra['omega'])
    for key in ('ite_normalization', 'ema_norm', 'ema_energy', 'ema_count'):
        assert torch.equal(a.extra[key], b.extra[key]), key
    assert float(a.extra['ema_count']) == 6.0
    assert torch.equal(a.sampler.configs, b.sampler.configs)
    assert torch.equal(a.sampler.generator.get_state(),
                       b.sampler.generator.get_state())
    assert _last_record(straight)['energy'] == _last_record(resumed)['energy']


def test_cli_train_generates_vectors_on_a_basis_file(tmp_path):
    path = str(tmp_path / 'basis.txt')
    jax_basis.save_basis_file(path, jax_basis.enumerate_sz_basis(N)[:10])
    run = tmp_path / 'run'
    assert _train(run, 1, '--generate_vectors', '--basis_file_path',
                  path) == 0
    with open(run / 'wavefunction_epoch_1.txt') as f:
        assert len(f.readlines()) == 10


def test_cli_distill_eval_dump_round_trip(tmp_path, capsys):
    """distill (default SWO) from a supervisor's run directory into an FC
    student; eval and dump on the distilled directory; dump writes what
    evaluate_vector gives."""
    supervisor, student = tmp_path / 'supervisor', tmp_path / 'student'
    assert _train(supervisor, 2) == 0
    assert _distill(supervisor, student, 3,
                    student='fully_connected') == 0
    with open(student / 'config.json') as f:
        saved = json.load(f)
    assert saved['wavefunction_optimizer_type'] == 'SWO'
    assert saved['supervisor_dir'] == str(supervisor)
    assert ckpt_lib.checkpoint_epoch(
        ckpt_lib.latest_checkpoint(str(student))) == 3
    with open(student / 'metrics.txt') as f:
        losses = [float(line) for line in f]
    assert len(losses) == 3 and all(np.isfinite(losses))

    capsys.readouterr()
    assert cli.main(['eval', '--checkpoint_dir', str(student), '--device',
                     'cpu']) == 0
    energy = float(capsys.readouterr().out.split('Energy: ')[1]
                   .split(' +/- ')[0])
    assert np.isfinite(energy) and energy > E0 - 0.5
    assert cli.main(['dump', '--checkpoint_dir', str(student), '--device',
                     'cpu']) == 0
    with open(student / 'wavefunction_epoch_0.txt') as f:
        dumped = np.array([float(line.split(',')[0][1:]) for line in f])
    config = Config.load(str(student / 'config.json'))
    expected = evaluate_vector(
        models.build_wavefunction(config), _latest(student).params,
        config.replace(checkpoint_dir=''))
    np.testing.assert_allclose(dumped, expected, rtol=1e-6)
    assert dumped.shape == (70,)


@pytest.mark.parametrize('name', ['DualSamplingSWO', 'BasisIterSWO'])
def test_cli_distill_resumes_exactly(tmp_path, name):
    """A distillation cut after 2 epochs and resumed to 3 ends bitwise where
    an uncut one ends: the target chains and their generator
    (DualSamplingSWO), the data generator (BasisIterSWO)."""
    supervisor = tmp_path / 'supervisor'
    straight, resumed = tmp_path / 'straight', tmp_path / 'resumed'
    assert _train(supervisor, 1) == 0
    flags = ('--optimizer_type', name)
    assert _distill(supervisor, straight, 3, *flags) == 0
    assert _distill(supervisor, resumed, 2, *flags) == 0
    assert _distill(supervisor, resumed, 3, '--resume', *flags) == 0
    a, b = _latest(straight), _latest(resumed)
    assert a.epoch == b.epoch == 3
    _assert_same_params(a.params, b.params)
    if name == 'DualSamplingSWO':
        assert torch.equal(a.extra['target_sampler'].configs,
                           b.extra['target_sampler'].configs)
        for x, y in ((a.sampler, b.sampler),
                     (a.extra['target_sampler'], b.extra['target_sampler'])):
            assert torch.equal(x.generator.get_state(),
                               y.generator.get_state())
    else:
        generator = b.extra['data_generator']
        assert generator.device.type == 'cpu'
        assert torch.equal(a.extra['data_generator'].get_state(),
                           generator.get_state())
    assert _last_record(straight)['loss'] == _last_record(resumed)['loss']
