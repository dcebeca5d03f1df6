"""Stochastic reconfiguration of the port against the JAX package: one
update from a fixed sample set for every solver, the gating, the chunked
Jacobian, one whole SR epoch, training against ED, and `cli eval
--params` on an artifact the JAX package wrote.

Inputs are made with numpy from a seed and carried over with `interop`.
Tolerances, float32 throughout: 'dense' rtol 1e-4 / atol 1e-6 (the
Cholesky solves the same system; sums run in another order); the CG
solvers rtol 5e-3 / atol 5e-4, the bound the JAX package's own tests hold
its CG solvers to against the dense one (test_sr.py); residual norms, which sit at the
solver's rounding noise, within 1e-4·(1 + |g|).  Gradients: rtol 1e-4 and
atol 1e-5·max|g| — the head bias's exact gradient is 0 (its Jacobian
column is constant, so centering removes it) and only rounding noise of
that size remains in either package.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu import lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops.heisenberg import HeisenbergHamiltonian as JaxHeisenberg
from cgs_vmc_tpu.optim.common import TrainState as JaxTrainState
from cgs_vmc_tpu.optim.sr import StochasticReconfiguration as JaxSR
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu.utils import checkpoint as jax_ckpt
from cgs_vmc_tpu.utils import ed
from cgs_vmc_tpu_torch import cli, models
from cgs_vmc_tpu_torch.evaluate import evaluate_operator
from cgs_vmc_tpu_torch.optim import TrainState
from cgs_vmc_tpu_torch.optim.sr import (
    StochasticReconfiguration, flatten_params, jacobian_rows)
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import interop

SOLVERS = ('dense', 'dense_cg', 'sample_cg', 'cg')
SAMPLES = 48
LR = 0.05
_MODELS = {
    'rbm': dict(num_sites=8, wavefunction_type='rbm', num_fc_layers=0,
                fc_layer_size=8),
    'symconv': dict(num_sites=16, size_x=4, size_y=4,
                    wavefunction_type='conv_2d', num_conv_layers=2,
                    num_conv_filters=4, kernel_size=3, symmetrize=True),
}


def _config(kind, **overrides):
    values = dict(heisenberg_jx=-1.0, wavefunction_optimizer_type='SR',
                  sr_diag_shift=1e-2, sr_solver='dense',
                  sr_cg_maxiter=200, sr_cg_tol=1e-8, sr_delta_clip=10.0,
                  optimizer='gradient', learning_rates=[LR],
                  learning_rate_stops=[], **_MODELS[kind])
    values.update(overrides)
    return Config(**values)


def _bonds(config):
    if config.size_x > 1:
        return lattice.square_lattice_bonds(config.size_x, config.size_y)
    return lattice.chain_bonds(config.num_sites)


def _problem(config, seed=0, n=SAMPLES):
    """(JAX optimizer, port optimizer, params, Sz=0 configs, E_loc)."""
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    noise = 0.3 if config.wavefunction_type == 'rbm' else 0.05
    params = jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    template = np.repeat([1.0, -1.0], config.num_sites // 2)
    configs = np.stack([rng.permutation(template) for _ in range(n)]
                       ).astype(np.float32)
    jax_opt = JaxSR(jax_wf, JaxHeisenberg(_bonds(config), -1.0, 1.0), config)
    e_loc = np.array(jax_opt.hamiltonian.local_value(jax_wf, params,
                                                     configs))
    opt = StochasticReconfiguration(models.build_wavefunction(config),
                                    build_hamiltonian(config), config)
    return jax_opt, opt, params, configs, e_loc


def _both_updates(config, seed=0):
    """update_from_samples in both packages on the same problem; returns
    ((params, residual, grad) of JAX, of the port, the start params)."""
    jax_opt, opt, params, configs, e_loc = _problem(config, seed)
    got_jax = jax.jit(jax_opt.update_from_samples)(
        params, jax_opt.optax_opt.init(params), jnp.zeros((), jnp.int32),
        jnp.asarray(configs), jnp.asarray(e_loc))
    tparams = interop.params_from_numpy(params, 'cpu')
    got = opt.update_from_samples(tparams, opt.sgd.init(tparams), 0,
                                  torch.as_tensor(configs),
                                  torch.as_tensor(e_loc))
    new_jax, _, res_jax, grad_jax = got_jax
    new, _, res, grad = got
    return ((jax.device_get(new_jax), float(res_jax),
             jax.device_get(grad_jax)),
            (interop.params_to_numpy(new), float(res),
             interop.params_to_numpy(grad)), params)


def _assert_trees_close(a, b, rtol, atol):
    jax.tree.map(lambda x, y: np.testing.assert_allclose(
        x, np.asarray(y), rtol=rtol, atol=atol), a, b)


def _max_abs(tree):
    return max(float(np.max(np.abs(x))) for x in jax.tree.leaves(tree))


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                             for x in jax.tree.leaves(tree))))


@pytest.mark.parametrize('solver', SOLVERS)
@pytest.mark.parametrize('kind', sorted(_MODELS))
def test_update_from_samples_matches_jax(kind, solver):
    (p_jax, r_jax, g_jax), (p, r, g), _ = _both_updates(
        _config(kind, sr_solver=solver))
    rtol, atol = (1e-4, 1e-6) if solver == 'dense' else (5e-3, 5e-4)
    _assert_trees_close(g, g_jax, 1e-4, 1e-5 * _max_abs(g_jax))
    _assert_trees_close(p, p_jax, rtol, atol)
    assert abs(r - r_jax) <= 1e-4 * (1 + _global_norm(g_jax))


@pytest.mark.parametrize('kind', sorted(_MODELS))
def test_gating_matches_jax(kind):
    """A residual gate too loose to fire changes nothing; one that fires
    zeroes the step; a tiny trust region clips |δ| to sr_delta_clip."""
    (open_jax, _, _), (open_port, _, _), _ = _both_updates(
        _config(kind, sr_reject_residual=1e30))
    (ref, _, _), _, _ = _both_updates(_config(kind))
    _assert_trees_close(open_port, ref, 1e-4, 1e-6)
    _assert_trees_close(open_jax, ref, 1e-6, 1e-8)

    (shut_jax, _, _), (shut, _, _), start = _both_updates(
        _config(kind, sr_reject_residual=1e-30))
    jax.tree.map(np.testing.assert_array_equal, shut, start)
    jax.tree.map(np.testing.assert_array_equal, shut_jax, start)

    clip = 1e-2      # |δ| is O(1) here; the step stays far above f32 ulps
    (clip_jax, _, _), (clipped, _, _), start = _both_updates(
        _config(kind, sr_delta_clip=clip))
    step = jax.tree.map(lambda a, b: a - b, clipped, start)
    np.testing.assert_allclose(_global_norm(step), LR * clip, rtol=1e-2)
    _assert_trees_close(clipped, clip_jax, 1e-6, 1e-9)


@pytest.mark.parametrize('kind', sorted(_MODELS))
def test_non_positive_definite_falls_back_to_the_gradient(kind):
    """A negative diagonal shift makes the system indefinite: the
    Cholesky reports it, δ becomes NaN and the gate takes the raw gradient
    (clipped), with no exception — as the JAX package does."""
    config = _config(kind, sr_diag_shift=-2.0, sr_delta_clip=0.5)
    (p_jax, _, g_jax), (p, _, g), start = _both_updates(config)
    scale = min(1.0, 0.5 / (_global_norm(g) + 1e-12))
    expected = jax.tree.map(lambda s, d: s - LR * scale * d, start, g)
    _assert_trees_close(p, expected, 1e-5, 1e-7)
    _assert_trees_close(p, p_jax, 1e-4, 1e-6)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(p))


@pytest.mark.parametrize('chunk', [16, 20])
def test_chunked_jacobian_equals_unchunked(chunk):
    """sr_jacobian_chunk changes memory, not the rows, whether or not the
    chunk divides the sample count (48)."""
    config = _config('symconv')
    _, opt, params, configs, e_loc = _problem(config, seed=3)
    tparams = interop.params_from_numpy(params, 'cpu')
    flat, unflatten = flatten_params(tparams)
    for leaf, back in zip(jax.tree.leaves(interop.params_to_numpy(tparams)),
                          jax.tree.leaves(interop.params_to_numpy(
                              unflatten(flat)))):
        np.testing.assert_array_equal(leaf, back)

    def single_log(p, c):
        return opt.wf.apply(unflatten(p), c[None, :]).log[0]

    configs = torch.as_tensor(configs)
    full = jacobian_rows(single_log, flat, configs, 0)
    chunked = jacobian_rows(single_log, flat, configs, chunk)
    assert full.shape == (SAMPLES, flat.numel())
    torch.testing.assert_close(chunked, full, rtol=1e-5, atol=1e-7)

    chunked_opt = StochasticReconfiguration(
        opt.wf, opt.hamiltonian, config.replace(sr_jacobian_chunk=chunk))
    e = torch.as_tensor(e_loc)
    a = opt._dense_solve(configs, tparams, e, e.mean())[0]
    b = chunked_opt._dense_solve(configs, tparams, e, e.mean())[0]
    _assert_trees_close(interop.params_to_numpy(b),
                        interop.params_to_numpy(a), 1e-5, 1e-7)


@pytest.mark.parametrize('kind', sorted(_MODELS))
def test_sr_epoch_matches_jax(kind):
    """One whole SR epoch (zero sweeps, so both packages see the same
    samples: 2 batches of the shared chains): energy, variance, grad norm
    and new params at rtol 1e-4 / atol 1e-6, residual at its noise
    bound."""
    config = _config(kind, batch_size=24, num_batches_per_epoch=2,
                     num_equilibration_sweeps=0, num_monte_carlo_sweeps=0,
                     use_fast_sampler=False)
    jax_opt, opt, params, configs, _ = _problem(config, seed=7, n=24)
    amp = jax_opt.wf.apply(params, configs)
    log_amp, sign = np.asarray(amp.log), np.asarray(amp.sign)
    zeros = jnp.zeros(24, jnp.float32)
    jax_state = JaxTrainState(
        params, jax_opt.optax_opt.init(params),
        JaxSamplerState(jnp.asarray(configs), jnp.asarray(log_amp),
                        jnp.asarray(sign),
                        jax.random.split(jax.random.key(0), 24), zeros,
                        zeros),
        jnp.zeros((), jnp.int32), {})
    jax_new, jax_metrics = jax.jit(jax_opt.epoch)(jax_state)

    tparams = interop.params_from_numpy(params, 'cpu')
    state = TrainState(tparams, opt.sgd.init(tparams),
                       interop.sampler_state_from_numpy(configs, log_amp,
                                                        sign, 'cpu'), 0, {})
    new, metrics = opt.epoch(state)
    for name in ('energy', 'energy_variance', 'grad_norm'):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jax_metrics[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    assert abs(float(metrics['sr_residual_norm'])
               - float(jax_metrics['sr_residual_norm'])) <= 1e-4 * (
        1 + float(jax_metrics['grad_norm']))
    _assert_trees_close(interop.params_to_numpy(new.params),
                        jax.device_get(jax_new.params), 1e-4, 1e-6)
    assert new.epoch == 1 and set(metrics) >= {'acceptance_rate',
                                               'sr_residual_norm'}


def test_sr_training_reaches_ed_energy():
    """RBM N=8 with dense SR through `train` (the fused sweeps' plain
    versions on the CPU): the late-epoch mean energy within 2% of ED."""
    config = _config('rbm', fc_layer_size=16, batch_size=128,
                     num_batches_per_epoch=2, num_equilibration_sweeps=5,
                     num_monte_carlo_sweeps=1, num_epochs=60,
                     learning_rates=[0.05], seed=3)
    e0, _ = ed.ground_state(8, lattice.chain_bonds(8), j_x=-1.0)

    class Record:
        energies = []

        def log(self, epoch, metrics):
            self.energies.append(float(metrics['energy']))
            assert np.isfinite(float(metrics['sr_residual_norm']))

    record = Record()
    train(config, 'cpu', logger=record)
    late = np.mean(record.energies[-10:])
    assert abs(late - e0) / abs(e0) < 0.02, (late, e0)


def test_cli_eval_reads_a_jax_params_artifact(tmp_path, capsys):
    """The JAX package writes a params-only .msgpack (save_params_only);
    `cgs_vmc_tpu_torch.cli eval --params` evaluates it with the
    architecture from --config."""
    config = _config('symconv', batch_size=32, num_evaluation_samples=4,
                     num_equilibration_sweeps=1, num_monte_carlo_sweeps=1)
    config_path = str(tmp_path / 'config.json')
    config.save(config_path)
    jax_wf = jax_build(config)
    artifact = jax_ckpt.save_params_only(
        str(tmp_path), jax_wf.init(jax.random.key(1)), 'tiny')
    capsys.readouterr()
    assert cli.main(['eval', '--config', config_path, '--params', artifact,
                     '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    energy = float(out.split('Energy: ')[1].split(' +/- ')[0])
    e0, _ = ed.ground_state(16, _bonds(config), j_x=-1.0)
    assert np.isfinite(energy) and energy > e0 - 0.5

    wrong = str(tmp_path / 'wrong.json')
    config.replace(num_conv_filters=8).save(wrong)
    with pytest.raises(ValueError, match='template'):
        cli.main(['eval', '--config', wrong, '--params', artifact,
                  '--device', 'cpu'])


def test_split_eval_is_accepted_and_changes_nothing(capsys):
    """`split_eval=true` (how the JAX package compiles its evaluation on a
    TPU, the same estimator) gives the numbers of `false` on one seed, and
    configs/square1010_deep_eval.json, which sets it, evaluates its
    committed artifact through the CLI (here at a cut depth)."""
    config = _config('symconv', batch_size=16, num_evaluation_samples=4,
                     num_equilibration_sweeps=1, num_monte_carlo_sweeps=1)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator().manual_seed(2))
    ham = build_hamiltonian(config)
    plain = evaluate_operator(wf, params, ham, config, 'cpu', seed=3)
    split = evaluate_operator(wf, params, ham,
                              config.replace(split_eval=True), 'cpu', seed=3)
    np.testing.assert_array_equal(split.values, plain.values)
    assert split.mean == plain.mean and split.error == plain.error

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    capsys.readouterr()
    assert cli.main([
        'eval', '--config',
        os.path.join(repo, 'configs', 'square1010_deep_eval.json'),
        '--params', os.path.join(repo, 'artifacts',
                                 'heisenberg_10x10_deep32_cont.msgpack'),
        '--device', 'cpu', '--override',
        'batch_size=4,num_equilibration_sweeps=0,num_evaluation_samples=2,'
        'num_monte_carlo_sweeps=0']) == 0
    out = capsys.readouterr().out
    energy = float(out.split('Energy: ')[1].split(' +/- ')[0])
    assert -100.0 < energy < 0.0
