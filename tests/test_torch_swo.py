"""The six SWO optimizers of the port against the JAX package, on the CPU.

Each comparison runs one whole epoch of two batches with zero sweeps, so
both packages see the same chains (made with numpy from a seed, their
amplitudes from the JAX wavefunction), from the same params (JAX-initialized,
perturbed with numpy noise, carried over with `interop`), at epoch 1 with
learning_rates [2e-2, 1e-2] and stops [1] (the epoch picks the rate).
Tolerance, float32 throughout: rtol 1e-4 / atol 1e-6 on the metrics, the
new params and ITSWO's normalization scalars.

The L2 losses train with adam, whose count advances once an update (two an
epoch).  The log-overlap ones train with plain gradient steps: their
gradient in a parameter whose log-derivative is the same on every sample
(the head bias) is exactly 0, and only rounding noise of ~1e-8 remains in
either package; adam divides a gradient by its own size and would turn
that noise into a step of the full learning rate.

Models: an RBM at N=8 and an unsymmetrized conv_2d (2 × 4 filters) at 4×4.
Supervised targets: a FullVector of the ED ground state and an RBM.
BasisIterSWO runs on the JAX package's index stream, handed to the port's
epoch through the method that makes it; its own stream is held by its
invariants.  Then the JAX package's training bars on the CPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu import lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import FullVector as JaxFullVector
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.optim import GROUND_STATE_OPTIMIZERS as JAX_GROUND
from cgs_vmc_tpu.optim import SUPERVISED_OPTIMIZERS as JAX_SUPERVISED
from cgs_vmc_tpu.optim.common import TrainState as JaxTrainState
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu.train import build_hamiltonian as jax_hamiltonian
from cgs_vmc_tpu.utils import ed
from cgs_vmc_tpu_torch import basis, models
from cgs_vmc_tpu_torch.evaluate import evaluate_vector, overlap_with_vector
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.optim import (
    GROUND_STATE_OPTIMIZERS, SUPERVISED_OPTIMIZERS, TrainState)
from cgs_vmc_tpu_torch.optim.swo import BasisIterationSWO
from cgs_vmc_tpu_torch.train import build_hamiltonian
from cgs_vmc_tpu_torch.utils import interop

CHAINS = 48
_MODELS = {
    'rbm': dict(num_sites=8, wavefunction_type='rbm', num_fc_layers=0,
                fc_layer_size=8),
    'conv': dict(num_sites=16, size_x=4, size_y=4,
                 wavefunction_type='conv_2d', num_conv_layers=2,
                 num_conv_filters=4, kernel_size=3),
}
_LOG_OVERLAP = ('LogOverlapITSWO', 'LogOverlapSWO')
_METRICS = {'ITSWO': ('energy', 'loss'), 'LogOverlapITSWO': ('energy',),
            'SWO': ('loss',), 'LogOverlapSWO': ('mean_ratio',),
            'DualSamplingSWO': ('loss',), 'BasisIterSWO': ('loss',)}


def _config(kind, name, **overrides):
    values = dict(batch_size=CHAINS, num_batches_per_epoch=2,
                  num_equilibration_sweeps=0, num_monte_carlo_sweeps=0,
                  heisenberg_jx=-1.0, time_evolution_beta=0.12,
                  wavefunction_optimizer_type=name,
                  optimizer='gradient' if name in _LOG_OVERLAP else 'adam',
                  learning_rates=[2e-2, 1e-2], learning_rate_stops=[1],
                  use_fast_sampler=False, **_MODELS[kind])
    values.update(overrides)
    return Config(**values)


def _close(actual, expected, what):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(expected, np.float64), rtol=1e-4,
                               atol=1e-6, err_msg=what)


def _assert_trees_close(port_params, jax_params):
    jax.tree.map(lambda x, y: _close(x, y, 'params'),
                 interop.params_to_numpy(port_params),
                 jax.device_get(jax_params))


def _noisy_params(jax_wf, rng, seed):
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))


def _chains(jax_wf, params, n_sites, n, rng):
    template = np.repeat([1.0, -1.0], n_sites // 2).astype(np.float32)
    configs = np.stack([rng.permutation(template) for _ in range(n)])
    amp = jax_wf.apply(params, configs)
    return configs, np.asarray(amp.log), np.asarray(amp.sign)


def _jax_sampler(configs, log_amp, sign):
    n = configs.shape[0]
    zeros = jnp.zeros(n, jnp.float32)
    return JaxSamplerState(jnp.asarray(configs), jnp.asarray(log_amp),
                           jnp.asarray(sign),
                           jax.random.split(jax.random.key(0), n), zeros,
                           zeros)


@functools.lru_cache(maxsize=None)
def _ed_vector(n_sites):
    """|V0| of the ED ground state (float32), the Marshall-gauged
    (jx = -1) chain at N=8 or 4×4 square lattice at N=16."""
    bonds = (lattice.chain_bonds(n_sites) if n_sites == 8
             else lattice.square_lattice_bonds(4, 4))
    _, v0 = ed.ground_state(n_sites, bonds, j_x=-1.0)
    return np.abs(v0).astype(np.float32)


def _targets(kind, target, rng):
    """(JAX target wf, port target wf, target params as numpy)."""
    n_sites = _MODELS[kind]['num_sites']
    if target == 'ed':
        vector = _ed_vector(n_sites)
        jax_t = JaxFullVector.for_sector(n_sites, vector)
        return (jax_t, FullVector.for_sector(n_sites, vector),
                jax.device_get(jax_t.init(jax.random.key(0))))
    config = Config(num_sites=n_sites, wavefunction_type='rbm',
                    num_fc_layers=0, fc_layer_size=6)
    jax_t = jax_build(config)
    return (jax_t, models.build_wavefunction(config),
            _noisy_params(jax_t, rng, 11))


def _run_jax(opt, params, sampler, extra):
    state = JaxTrainState(params, opt.optax_opt.init(params), sampler,
                          jnp.asarray(1, jnp.int32), extra)
    return jax.jit(opt.epoch)(state)


def _to_torch(tree):
    return interop.params_from_numpy(tree, 'cpu')


@pytest.mark.parametrize('kind', sorted(_MODELS))
@pytest.mark.parametrize('name', ['ITSWO', 'LogOverlapITSWO'])
def test_imaginary_time_epoch_matches_jax(name, kind):
    config = _config(kind, name)
    rng = np.random.default_rng(3)
    jax_wf = jax_build(config)
    params = _noisy_params(jax_wf, rng, 0)
    chains = _chains(jax_wf, params, config.num_sites, CHAINS, rng)
    scalars = ({'ite_normalization': 1.3, 'ema_norm': 1.1,
                'ema_energy': -2.5, 'ema_count': 3.0}
               if name == 'ITSWO' else {})
    jax_opt = JAX_GROUND[name](jax_wf, jax_hamiltonian(config), config)
    jax_new, jax_metrics = _run_jax(
        jax_opt, params, _jax_sampler(*chains),
        {'omega': params,
         **{k: jnp.float32(v) for k, v in scalars.items()}})

    opt = GROUND_STATE_OPTIMIZERS[name](models.build_wavefunction(config),
                                        build_hamiltonian(config), config)
    tparams = _to_torch(params)
    extra = {'omega': _to_torch(params),
             **{k: torch.tensor(v) for k, v in scalars.items()}}
    new, metrics = opt.epoch(TrainState(
        tparams, opt.sgd.init(tparams),
        interop.sampler_state_from_numpy(*chains, 'cpu'), 1, extra))

    for metric in _METRICS[name]:
        _close(metrics[metric], jax_metrics[metric], metric)
    _assert_trees_close(new.params, jax_new.params)
    # ω is the epoch's starting params, not the updated ones.
    _assert_trees_close(new.extra['omega'], params)
    for key in scalars:
        _close(new.extra[key], jax_new.extra[key], key)
    assert new.epoch == 2
    if name == 'ITSWO':
        assert new.opt_state['count'] == 2


@pytest.mark.parametrize('target', ['ed', 'rbm'])
@pytest.mark.parametrize('kind', sorted(_MODELS))
@pytest.mark.parametrize('name', sorted(SUPERVISED_OPTIMIZERS))
def test_supervised_epoch_matches_jax(name, kind, target):
    config = _config(kind, name)
    rng = np.random.default_rng(5)
    jax_wf = jax_build(config)
    params = _noisy_params(jax_wf, rng, 1)
    jax_t, port_t, t_params = _targets(kind, target, rng)
    dual = name == 'DualSamplingSWO'
    n = CHAINS // 2 if dual else CHAINS
    chains = _chains(jax_wf, params, config.num_sites, n, rng)
    jax_opt = JAX_SUPERVISED[name](jax_wf, jax_t, config)
    opt = SUPERVISED_OPTIMIZERS[name](models.build_wavefunction(config),
                                      port_t, config)
    jax_extra = {'target': t_params}
    extra = {'target': _to_torch(t_params)}
    if dual:
        t_chains = _chains(jax_t, t_params, config.num_sites, n, rng)
        jax_extra['target_sampler'] = _jax_sampler(*t_chains)
        extra['target_sampler'] = interop.sampler_state_from_numpy(
            *t_chains, 'cpu', seed=1)
    if name == 'BasisIterSWO':
        key = jax.random.key(9)
        jax_extra['data_key'] = key
        _, perm_key = jax.random.split(key)
        stream = np.asarray(jax_opt._epoch_indices(perm_key, None))
        opt._epoch_indices = lambda generator, rank=0: torch.tensor(stream)
        extra['data_generator'] = torch.Generator()
    jax_new, jax_metrics = _run_jax(jax_opt, params, _jax_sampler(*chains),
                                    jax_extra)

    tparams = _to_torch(params)
    new, metrics = opt.epoch(TrainState(
        tparams, opt.sgd.init(tparams),
        interop.sampler_state_from_numpy(*chains, 'cpu'), 1, extra))

    for metric in _METRICS[name]:
        _close(metrics[metric], jax_metrics[metric], metric)
    _assert_trees_close(new.params, jax_new.params)
    _assert_trees_close(new.extra['target'], t_params)
    assert new.epoch == 2


def _basis_iteration(seed, batch_size, batches):
    config = _config('rbm', 'BasisIterSWO', batch_size=batch_size,
                     num_batches_per_epoch=batches)
    vector = _ed_vector(8)
    opt = BasisIterationSWO(models.build_wavefunction(config),
                            FullVector.for_sector(8, vector), config)
    state = opt.init_state(seed, 'cpu', {'ed_vector': torch.tensor(vector)})
    return opt, state


def test_basis_iteration_covers_the_basis_without_replacement():
    """One pass (35 × 2 rows of the 70-state N=8 basis) visits every row
    once; a longer epoch (3 × 35 rows) tiles the permutation; the epoch
    trains."""
    opt, state = _basis_iteration(3, 35, 2)
    generator = state.extra['data_generator']
    before = generator.get_state()
    idx = opt._epoch_indices(generator)
    assert sorted(idx.tolist()) == list(range(70))
    generator.set_state(before)
    new, metrics = opt.epoch(state)
    assert np.isfinite(float(metrics['loss'])) and new.epoch == 1
    assert not torch.equal(generator.get_state(), before)

    opt, state = _basis_iteration(3, 35, 3)
    idx = opt._epoch_indices(state.extra['data_generator']).tolist()
    assert sorted(idx[:70]) == list(range(70))
    assert idx[70:] == idx[:35]


def test_basis_iteration_seed_changes_order():
    orders = []
    for seed in (3, 4):
        opt, state = _basis_iteration(seed, 35, 2)
        orders.append(opt._epoch_indices(
            state.extra['data_generator']).tolist())
    assert orders[0] != orders[1]


# The JAX package's training bars (tests/test_training.py), on the port.
N = 8
E0, V0 = ed.ground_state(N, lattice.chain_bonds(N), j_x=-1.0)


def _bar_config(**kwargs):
    values = dict(num_sites=N, wavefunction_type='rbm', num_fc_layers=1,
                  fc_layer_size=16, batch_size=128, num_batches_per_epoch=5,
                  num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                  learning_rates=[3e-3, 1e-3], learning_rate_stops=[60],
                  optimizer='adam', heisenberg_jx=-1.0,
                  time_evolution_beta=0.12, seed=7)
    values.update(kwargs)
    return Config(**values)


@pytest.mark.parametrize('name', ['ITSWO', 'LogOverlapITSWO'])
def test_imaginary_time_lowers_energy(name):
    config = _bar_config(wavefunction_optimizer_type=name)
    opt = GROUND_STATE_OPTIMIZERS[name](models.build_wavefunction(config),
                                        build_hamiltonian(config), config)
    state = opt.init_state(config.seed, 'cpu')
    for _ in range(80):
        state, metrics = opt.epoch(state)
    energy = float(metrics['energy'])
    assert energy < 0.6 * E0, energy  # most of the way to the ground state
    assert energy - E0 > -0.5, energy  # not below the exact ground state


@pytest.mark.parametrize('name', sorted(SUPERVISED_OPTIMIZERS))
def test_distillation_reaches_high_overlap(name):
    """Distilling the exact N=8 target into an RBM drives the fidelity
    above 0.97 in 60 epochs."""
    config = _bar_config(batch_size=64, num_batches_per_epoch=10,
                         learning_rates=[1e-2, 3e-3],
                         learning_rate_stops=[40],
                         wavefunction_optimizer_type=name)
    vector = np.abs(V0).astype(np.float32)
    wf = models.build_wavefunction(config)
    opt = SUPERVISED_OPTIMIZERS[name](wf, FullVector.for_sector(N, vector),
                                      config)
    state = opt.init_state(3, 'cpu', {'ed_vector': torch.tensor(vector)},
                           config.batch_size)
    for _ in range(60):
        state, _ = opt.epoch(state)
    psi = evaluate_vector(wf, state.params, config,
                          basis_array=basis.enumerate_sz_basis(N))
    fidelity = overlap_with_vector(psi, vector)
    assert fidelity > 0.97, f'{name}: overlap {fidelity}'
