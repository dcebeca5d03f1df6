"""Excited states of the port (ExcitedPenalty, ExcitedSR) against the JAX
package, on the CPU: one whole epoch of each on shared samples, the
exactness oracles of tests/test_excited.py, the registry and the error
cases, the two kinds of frozen state, and a resume that carries the frozen
chains.

Inputs are made with numpy from a seed (JAX-initialized params perturbed
with numpy noise, Sz=0 chains from permutations) and carried over with
`interop`, the frozen chains as a list of sampler states.  Tolerances,
float32 / complex64: epochs rtol 1e-4 / atol 1e-6 (the same sums in
another order; zero sweeps, so both packages see the same samples), the
SR residual within 1e-4·(1 + |g|) (it sits at the solver's rounding noise);
the oracles at tests/test_excited.py's bars; a resume bit for bit.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops.heisenberg import HeisenbergHamiltonian as JaxHeisenberg
from cgs_vmc_tpu.optim import GROUND_STATE_OPTIMIZERS as JAX_GROUND
from cgs_vmc_tpu.optim.common import TrainState as JaxTrainState
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu.utils import checkpoint as jax_ckpt
from cgs_vmc_tpu_torch import cli, lattice, models
from cgs_vmc_tpu_torch.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS, TrainState
from cgs_vmc_tpu_torch.optim.excited import (
    PenaltyExcitedOptimizer, SRPenaltyExcitedOptimizer, load_frozen_states)
from cgs_vmc_tpu_torch.train import train
from cgs_vmc_tpu_torch.utils import checkpoint, ed, interop


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The tensors are tiny: with several test workers on one machine,
    torch's intra-op thread pools only fight each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 8
JX = -1.0
BONDS = lattice.chain_bonds(N)
_VALS, _VECS = np.linalg.eigh(np.asarray(
    ed.heisenberg_matrix(N, BONDS, j_x=JX, sparse=False)))
E0, E1 = float(_VALS[0]), float(_VALS[1])
V0, V1 = _VECS[:, 0], _VECS[:, 1]
CHAINS = 24
NAMES = ('ExcitedPenalty', 'ExcitedSR')
_ANSATZ = {
    'rbm': dict(wavefunction_type='rbm', num_fc_layers=0, fc_layer_size=8),
    'complex': dict(wavefunction_type='complex',
                    composite_wavefunction_types=('rbm', 'fully_connected'),
                    num_fc_layers=1, fc_layer_size=6),
}


def _config(**overrides):
    """tests/test_excited.py's config."""
    values = dict(num_sites=N, batch_size=128, num_batches_per_epoch=4,
                  num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                  learning_rates=[0.0], learning_rate_stops=[],
                  optimizer='gradient', heisenberg_jx=JX,
                  orthogonality_penalty=10.0, seed=11)
    values.update(overrides)
    return Config(**values)


def _ham():
    return HeisenbergHamiltonian(BONDS, JX, 1.0)


def _numpy_state(jax_wf, seed, chains=CHAINS):
    """(perturbed numpy params, numpy Sz=0 configs) from a seed."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    template = np.repeat([1.0, -1.0], N // 2)
    configs = np.stack([rng.permutation(template) for _ in range(chains)]
                       ).astype(np.float32)
    return params, configs


def _samplers(jax_wf, params, configs):
    """The same chains as a JAX and a port sampler state."""
    amp = jax_wf.apply(params, configs)
    log_amp, sign = np.array(amp.log), np.array(amp.sign)
    zeros = jnp.zeros(len(configs), jnp.float32)
    jax_state = JaxSamplerState(
        jnp.asarray(configs), jnp.asarray(log_amp), jnp.asarray(sign),
        jax.random.split(jax.random.key(0), len(configs)), zeros, zeros)
    return jax_state, interop.sampler_state_from_numpy(configs, log_amp,
                                                       sign, 'cpu')


def _close_trees(got, want, rtol=1e-4, atol=1e-6):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=rtol, atol=atol),
        interop.params_to_numpy(got), jax.device_get(want))


@pytest.mark.parametrize('kind', sorted(_ANSATZ))
@pytest.mark.parametrize('name', NAMES)
def test_epoch_matches_jax(name, kind):
    """One epoch with zero sweeps (2 batches of the shared chains; the
    frozen chains injected): energy, variance, overlap, loss, grad norm and
    the new params at rtol 1e-4 / atol 1e-6."""
    config = _config(**_ANSATZ[kind], batch_size=CHAINS,
                     num_batches_per_epoch=2, num_equilibration_sweeps=0,
                     num_monte_carlo_sweeps=0, use_fast_sampler=False,
                     learning_rates=[0.05], sr_diag_shift=1e-2)
    jax_wf = jax_build(config)
    params, configs = _numpy_state(jax_wf, seed=3)
    frozen, frozen_configs = _numpy_state(jax_wf, seed=4)
    jax_sampler, sampler = _samplers(jax_wf, params, configs)
    jax_lower, lower = _samplers(jax_wf, frozen, frozen_configs)

    jax_opt = JAX_GROUND[name](jax_wf, JaxHeisenberg(BONDS, JX, 1.0), config,
                               lower_states=[(jax_wf, frozen)])
    jax_state = JaxTrainState(params, jax_opt.optax_opt.init(params),
                              jax_sampler, jnp.zeros((), jnp.int32),
                              {'lower_samplers': [jax_lower]})
    jax_new, want = jax.jit(jax_opt.epoch)(jax_state)

    wf = models.build_wavefunction(config)
    opt = GROUND_STATE_OPTIMIZERS[name](
        wf, _ham(), config,
        lower_states=[(wf, interop.params_from_numpy(frozen, 'cpu'))])
    tparams = interop.params_from_numpy(params, 'cpu')
    new, got = opt.epoch(TrainState(tparams, opt.sgd.init(tparams), sampler,
                                    0, {'lower_samplers': [lower]}))
    assert set(got) == set(want)
    for key in sorted(set(want) - {'acceptance_rate', 'sr_residual_norm'}):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    if 'sr_residual_norm' in want:
        assert abs(float(got['sr_residual_norm'])
                   - float(want['sr_residual_norm'])) <= 1e-4 * (
            1 + float(want['grad_norm']))
    _close_trees(new.params, jax_new.params)
    # The chains are not drawn from |psi|^2 (zero sweeps from random
    # configs), so the overlap estimator is only positive and finite here.
    assert 0.0 < float(want['overlap']) < np.inf
    (moved,) = new.extra['lower_samplers']
    assert torch.equal(moved.configs, lower.configs) and new.epoch == 1


def _vector_state(vec):
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    return wf, wf.init(torch.Generator())


@pytest.mark.parametrize('name', NAMES)
def test_overlap_exact_for_identical_states(name):
    """psi == psi_0: every ratio is 1, so the overlap is 1 to f32 rounding,
    and the exact eigenstate's energy is E0 with no variance
    (tests/test_excited.py:57 and :211)."""
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(V0)
    opt = GROUND_STATE_OPTIMIZERS[name](wf, _ham(), _config(sr_diag_shift=1e-2),
                                        lower_states=[(wf0, params0)])
    _, metrics = opt.epoch(opt.init_state(1, 'cpu'))
    assert abs(float(metrics['overlap']) - 1.0) < 1e-4
    assert abs(float(metrics['energy']) - E0) < 1e-3
    assert float(metrics['energy_variance']) < 1e-4


def test_exact_excited_state_is_a_zero_variance_fixed_point():
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(V1)
    opt = PenaltyExcitedOptimizer(wf, _ham(), _config(),
                                  lower_states=[(wf0, params0)])
    _, metrics = opt.epoch(opt.init_state(2, 'cpu'))
    assert abs(float(metrics['energy']) - E1) < 1e-3
    assert float(metrics['energy_variance']) < 1e-4
    assert abs(float(metrics['overlap'])) < 0.1


def test_complex_path_overlap_exact():
    """Complex-log ansatz, psi == psi_0: the overlap is 1 through the phase
    pullbacks (tests/test_excited.py:134)."""
    rng = np.random.default_rng(5)
    modulus = rng.uniform(0.2, 1.0, size=V0.shape[0]).astype(np.float32)
    phase = rng.uniform(-2.0, 2.0, size=V0.shape[0]).astype(np.float32)

    def make():
        return ComplexPhaseWavefunction(FullVector.for_sector(N, modulus),
                                        FullVector.for_sector(N,
                                                              np.exp(phase)))

    wf0 = make()
    opt = PenaltyExcitedOptimizer(make(), _ham(), _config(),
                                  lower_states=[(wf0, wf0.init(
                                      torch.Generator()))])
    state, metrics = opt.epoch(opt.init_state(6, 'cpu'))
    assert state.sampler.log_amp.is_complex()
    assert abs(float(metrics['overlap']) - 1.0) < 1e-4
    assert np.isfinite(float(metrics['grad_norm']))


def _jax_error(name, config, lower_states=None):
    jax_wf = jax_build(config)
    with pytest.raises((ValueError, NotImplementedError)) as err:
        opt = JAX_GROUND[name](jax_wf, JaxHeisenberg(BONDS, JX, 1.0), config,
                               lower_states=lower_states)
        state = opt.init_state(jax.random.key(0))
        opt.epoch(state)
    return err


@pytest.mark.parametrize('name', NAMES)
def test_registry_and_errors_match_jax(name):
    """The registry names both optimizers; a missing orthogonal_to, a
    penalty <= 0 and a complex frozen state under a real ansatz raise the
    JAX package's errors with its messages."""
    assert GROUND_STATE_OPTIMIZERS[name] is {
        'ExcitedPenalty': PenaltyExcitedOptimizer,
        'ExcitedSR': SRPenaltyExcitedOptimizer}[name]
    config = _config(**_ANSATZ['rbm'], batch_size=8,
                     num_batches_per_epoch=1, num_equilibration_sweeps=1)
    wf = models.build_wavefunction(config)
    with pytest.raises(ValueError) as err:
        GROUND_STATE_OPTIMIZERS[name](wf, _ham(), config)
    assert str(err.value) == str(_jax_error(name, config).value)
    assert 'orthogonal_to' in str(err.value)

    frozen = wf.init(torch.Generator())
    bad = config.replace(orthogonality_penalty=0.0)
    jax_wf = jax_build(config)
    jax_frozen = jax_wf.init(jax.random.key(0))
    with pytest.raises(ValueError) as err:
        GROUND_STATE_OPTIMIZERS[name](wf, _ham(), bad,
                                      lower_states=[(wf, frozen)])
    assert str(err.value) == str(_jax_error(
        name, bad, [(jax_wf, jax_frozen)]).value)

    complex_config = _config(**_ANSATZ['complex'])
    cwf = models.build_wavefunction(complex_config)
    opt = GROUND_STATE_OPTIMIZERS[name](
        wf, _ham(), config,
        lower_states=[(cwf, cwf.init(torch.Generator()))])
    with pytest.raises(NotImplementedError) as err:
        opt.epoch(opt.init_state(0, 'cpu'))
    jax_cwf = jax_build(complex_config)
    assert str(err.value) == str(_jax_error(
        name, config,
        [(jax_cwf, jax_cwf.init(jax.random.key(0)))]).value)


def test_frozen_states_load_from_a_run_dir_and_an_artifact(tmp_path):
    """load_frozen_states: a run directory (its own config.json, its latest
    checkpoint) and a params-only .msgpack the JAX package wrote
    (architecture from the current config)."""
    config = _config(**_ANSATZ['rbm'], batch_size=16,
                     num_batches_per_epoch=1, num_epochs=1,
                     wavefunction_optimizer_type='EnergyGradient',
                     learning_rates=[0.01], checkpoint_dir=str(tmp_path / 'g'))
    state = train(config, 'cpu')
    jax_wf = jax_build(config)
    artifact_params, _ = _numpy_state(jax_wf, seed=9)
    artifact = jax_ckpt.save_params_only(str(tmp_path), artifact_params,
                                         'frozen')
    loaded = load_frozen_states(config.replace(
        orthogonal_to=[config.checkpoint_dir, artifact]))
    assert len(loaded) == 2
    (wf_run, p_run), (wf_art, p_art) = loaded
    for a, b in zip(jax.tree.leaves(interop.params_to_numpy(p_run)),
                    jax.tree.leaves(interop.params_to_numpy(state.params))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(interop.params_to_numpy(p_art)),
                    jax.tree.leaves(artifact_params)):
        np.testing.assert_array_equal(a, b)
    configs = torch.as_tensor(_numpy_state(jax_wf, seed=10)[1])
    np.testing.assert_allclose(
        wf_art.apply(p_art, configs).log.numpy(),
        np.asarray(jax_wf.apply(artifact_params, configs.numpy()).log),
        rtol=1e-5, atol=1e-5)
    assert wf_run.apply(p_run, configs).log.shape == (configs.shape[0],)
    with pytest.raises(FileNotFoundError):
        empty = tmp_path / 'empty'
        empty.mkdir()
        config.replace(checkpoint_dir=str(empty)).save(
            str(empty / 'config.json'))
        load_frozen_states(config.replace(orthogonal_to=[str(empty)]))


@pytest.fixture(scope='module')
def ground_run(tmp_path_factory):
    """A 2-epoch EnergyGradient run of an RBM on the N=8 chain."""
    run_dir = str(tmp_path_factory.mktemp('ground'))
    train(_config(**_ANSATZ['rbm'], batch_size=32, num_batches_per_epoch=2,
                  num_epochs=2, wavefunction_optimizer_type='EnergyGradient',
                  learning_rates=[0.01], checkpoint_dir=run_dir), 'cpu')
    return run_dir


@pytest.mark.parametrize('name', NAMES)
def test_resume_carries_the_frozen_chains_bit_for_bit(name, ground_run,
                                                      tmp_path):
    """Two epochs straight and one epoch + a resumed one give the same
    params and frozen chains bit for bit: the checkpoint carries
    extra['lower_samplers'] (and their generators)."""
    config = _config(**_ANSATZ['rbm'], batch_size=32,
                     num_batches_per_epoch=2, num_epochs=2,
                     wavefunction_optimizer_type=name, learning_rates=[0.02],
                     sr_diag_shift=1e-2, orthogonal_to=[ground_run])
    straight = train(config.replace(checkpoint_dir=str(tmp_path / 'a')),
                     'cpu')
    split_dir = str(tmp_path / 'b')
    train(config.replace(num_epochs=1, checkpoint_dir=split_dir), 'cpu')
    restored = checkpoint.restore_checkpoint(
        checkpoint.latest_checkpoint(split_dir), 'cpu')
    (lower,) = restored.extra['lower_samplers']
    assert isinstance(lower.generator, torch.Generator)
    resumed = train(config.replace(checkpoint_dir=split_dir), 'cpu',
                    resume=True)
    for a, b in zip(jax.tree.leaves(interop.params_to_numpy(resumed.params)),
                    jax.tree.leaves(interop.params_to_numpy(
                        straight.params))):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(resumed.extra['lower_samplers'],
                         straight.extra['lower_samplers']):
        assert torch.equal(got.configs, want.configs)
        assert torch.equal(got.log_amp, want.log_amp)
    assert torch.equal(resumed.sampler.configs, straight.sampler.configs)


@pytest.mark.parametrize('name', NAMES)
def test_cli_train_orthogonal_to(name, ground_run, tmp_path, capsys):
    """`train --orthogonal_to RUN` with each optimizer: the metrics stream
    carries the overlap; `--resume` continues the run."""
    out = str(tmp_path / name)
    override = ('num_sites=8,wavefunction_type=rbm,num_fc_layers=0,'
                'fc_layer_size=8,batch_size=32,num_batches_per_epoch=2,'
                'num_equilibration_sweeps=2,heisenberg_jx=-1.0,'
                'optimizer=gradient,learning_rates=[2e-2],'
                'learning_rate_stops=[],sr_diag_shift=1e-2')
    assert cli.main(['train', '--device', 'cpu', '--checkpoint_dir', out,
                     '--optimizer_type', name, '--orthogonal_to', ground_run,
                     '--num_epochs', '2', '--override', override]) == 0
    assert cli.main(['train', '--device', 'cpu', '--checkpoint_dir', out,
                     '--resume', '--num_epochs', '3']) == 0
    with open(os.path.join(out, 'metrics.jsonl')) as f:
        lines = [json.loads(line) for line in f]
    assert [r['epoch'] for r in lines] == [1, 2, 3]
    assert all(np.isfinite([r['energy'], r['overlap']]).all() for r in lines)
    with open(os.path.join(out, 'config.json')) as f:
        assert json.load(f)['orthogonal_to'] == [ground_run]
