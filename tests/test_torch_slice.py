"""The slice end to end against the JAX package: one EnergyGradient epoch
and one zero-sweep evaluation from the same params and chains in both
packages, the port's training against ED, and the CLI (train -> eval, and
an exact resume from a checkpoint)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu import lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.evaluate import evaluate_operator as jax_evaluate
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops.heisenberg import HeisenbergHamiltonian as JaxHeisenberg
from cgs_vmc_tpu.optim import EnergyGradientOptimizer as JaxEnergyGradient
from cgs_vmc_tpu.optim.common import TrainState as JaxTrainState
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu.utils import ed
from cgs_vmc_tpu_torch import cli, models
from cgs_vmc_tpu_torch.evaluate import evaluate_operator
from cgs_vmc_tpu_torch.optim import EnergyGradientOptimizer, TrainState
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils import interop

N = 8
CHAINS = 32


def _config(**overrides):
    values = dict(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                  fc_layer_size=16, batch_size=CHAINS,
                  num_batches_per_epoch=1, num_equilibration_sweeps=0,
                  num_monte_carlo_sweeps=1, heisenberg_jx=-1.0,
                  wavefunction_optimizer_type='EnergyGradient',
                  optimizer='adam', learning_rates=[1e-2],
                  learning_rate_stops=[], num_evaluation_samples=2)
    values.update(overrides)
    return Config(**values)


def _shared_start(config, seed=0):
    """JAX-initialized params perturbed with numpy noise, and Sz=0 chains
    from numpy, with their JAX amplitudes."""
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    template = np.repeat([1.0, -1.0], N // 2).astype(np.float32)
    configs = np.stack([rng.permutation(template) for _ in range(CHAINS)])
    amp = jax_wf.apply(params, configs)
    return jax_wf, params, configs, np.asarray(amp.log), np.asarray(amp.sign)


def _jax_sampler(configs, log_amp, sign):
    zeros = jnp.zeros(CHAINS, jnp.float32)
    return JaxSamplerState(jnp.asarray(configs), jnp.asarray(log_amp),
                           jnp.asarray(sign),
                           jax.random.split(jax.random.key(0), CHAINS),
                           zeros, zeros)


@pytest.mark.parametrize('optimizer', ['adam', 'gradient'])
def test_energy_gradient_epoch_matches_jax(optimizer):
    """Energy, variance, grad norm and updated params agree at rtol 1e-4 /
    atol 1e-6 (float32; sums taken in another order)."""
    config = _config(optimizer=optimizer)
    jax_wf, params, configs, log_amp, sign = _shared_start(config)
    bonds = lattice.chain_bonds(N)
    jax_opt = JaxEnergyGradient(jax_wf, JaxHeisenberg(bonds, -1.0, 1.0),
                                config)
    jax_state = JaxTrainState(params, jax_opt.optax_opt.init(params),
                              _jax_sampler(configs, log_amp, sign),
                              jnp.zeros((), jnp.int32), {})
    jax_new, jax_metrics = jax.jit(jax_opt.epoch)(jax_state)

    opt = EnergyGradientOptimizer(models.build_wavefunction(config),
                                  build_hamiltonian(config), config)
    tparams = interop.params_from_numpy(params, 'cpu')
    state = TrainState(tparams, opt.sgd.init(tparams),
                       interop.sampler_state_from_numpy(
                           configs, log_amp, sign, 'cpu'), 0, {})
    new, metrics = opt.epoch(state)

    for name in ('energy', 'energy_variance', 'grad_norm'):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jax_metrics[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    jax.tree.map(lambda x, y: np.testing.assert_allclose(
        x, np.asarray(y), rtol=1e-4, atol=1e-6),
        interop.params_to_numpy(new.params), jax.device_get(jax_new.params))
    assert new.epoch == 1


def test_evaluate_zero_sweeps_matches_jax():
    config = _config(num_monte_carlo_sweeps=0)
    jax_wf, params, configs, log_amp, sign = _shared_start(config, seed=1)
    jax_result = jax_evaluate(jax_wf, params,
                              JaxHeisenberg(lattice.chain_bonds(N), -1.0,
                                            1.0),
                              config, state=_jax_sampler(configs, log_amp,
                                                         sign))
    result = evaluate_operator(
        models.build_wavefunction(config),
        interop.params_from_numpy(params, 'cpu'), build_hamiltonian(config),
        config, 'cpu',
        state=interop.sampler_state_from_numpy(configs, log_amp, sign,
                                               'cpu'))
    np.testing.assert_allclose(result.mean, jax_result.mean, rtol=1e-5)
    assert result.values.shape == (config.num_evaluation_samples,)


def test_train_reaches_ed_energy():
    """EnergyGradient + the fused sweeps (plain versions on the CPU) reach
    the N=8 chain ground state within 5%, as the JAX package does
    (tests/test_fast_rbm.py)."""
    config = _config(batch_size=128, num_batches_per_epoch=5,
                     num_equilibration_sweeps=5, num_epochs=150,
                     learning_rates=[5e-3, 1e-3], learning_rate_stops=[120],
                     seed=2)
    e0, _ = ed.ground_state(N, lattice.chain_bonds(N), j_x=-1.0)

    class Last:
        def log(self, epoch, metrics):
            self.metrics = {k: float(v) for k, v in metrics.items()}

    last = Last()
    train(config, 'cpu', logger=last)
    assert abs(last.metrics['energy'] - e0) / abs(e0) < 0.05
    assert last.metrics['acceptance_rate'] > 0.05


def _cli_train(run_dir, epochs, *extra):
    override = ('num_sites=8,wavefunction_type=rbm,num_fc_layers=0,'
                'fc_layer_size=16,batch_size=32,num_batches_per_epoch=2,'
                'num_equilibration_sweeps=2,heisenberg_jx=-1.0,'
                'learning_rates=[1e-2],learning_rate_stops=[],'
                'num_evaluation_samples=20')
    return cli.main(['train', '--checkpoint_dir', str(run_dir), '--device',
                     'cpu', '--optimizer_type', 'EnergyGradient',
                     '--num_epochs', str(epochs), '--override', override,
                     *extra])


def test_cli_train_eval_round_trip(tmp_path, capsys):
    assert _cli_train(tmp_path, 3) == 0
    assert ckpt_lib.checkpoint_epoch(
        ckpt_lib.latest_checkpoint(str(tmp_path))) == 3
    with open(tmp_path / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert [r['epoch'] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r['energy']) for r in records)
    capsys.readouterr()
    assert cli.main(['eval', '--checkpoint_dir', str(tmp_path),
                     '--device', 'cpu']) == 0
    out = capsys.readouterr().out
    energy = float(out.split('Energy: ')[1].split(' +/- ')[0])
    e0, _ = ed.ground_state(N, lattice.chain_bonds(N), j_x=-1.0)
    assert np.isfinite(energy) and energy > e0 - 0.1
    assert cli.main(['eval', '--checkpoint_dir', str(tmp_path),
                     '--device', 'cpu', '--observable', 'szsz:1']) == 0
    szsz = float(capsys.readouterr().out.split('SzSz(d=1): ')[1]
                 .split(' +/- ')[0])
    assert -0.25 <= szsz <= 0.25
    assert cli.main(['eval', '--checkpoint_dir', str(tmp_path),
                     '--device', 'cpu', '--observable', 'szsz_1']) == 1


def test_resume_gives_the_same_next_epoch(tmp_path):
    """A run cut after 2 epochs and resumed to 3 ends bitwise where an
    uncut 3-epoch run ends: params, optimizer, chains, generator."""
    straight, resumed = tmp_path / 'straight', tmp_path / 'resumed'
    assert _cli_train(straight, 3) == 0
    assert _cli_train(resumed, 2) == 0
    assert _cli_train(resumed, 3, '--resume') == 0
    a = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(
        str(straight)), 'cpu')
    b = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(
        str(resumed)), 'cpu')
    assert a.epoch == b.epoch == 3
    for x, y in zip(jax.tree.leaves(interop.params_to_numpy(a.params)),
                    jax.tree.leaves(interop.params_to_numpy(b.params))):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(a.sampler.configs, b.sampler.configs)
    assert torch.equal(a.sampler.generator.get_state(),
                       b.sampler.generator.get_state())
    assert a.opt_state['count'] == b.opt_state['count'] == 3
    with open(os.path.join(resumed, 'metrics.jsonl')) as f:
        resumed_last = json.loads(f.readlines()[-1])
    with open(os.path.join(straight, 'metrics.jsonl')) as f:
        straight_last = json.loads(f.readlines()[-1])
    assert resumed_last['energy'] == straight_last['energy']


def test_unported_settings_and_devices_raise(tmp_path):
    """epochs_per_call and param_ema_decay train now; num_devices > 1
    needs a process group of that size (torchrun); orbax stays out."""
    config = _config(num_epochs=1)
    state = train(config.replace(epochs_per_call=2, num_epochs=3), 'cpu')
    assert state.epoch == 3
    state = train(config.replace(param_ema_decay=0.9), 'cpu')
    assert 'ema_params' in state.extra
    with pytest.raises(ValueError, match='Requested 2 devices, have 1; '
                       '.*torchrun --nproc_per_node=2'):
        train(config.replace(num_devices=2), 'cpu')
    with pytest.raises(NotImplementedError, match='checkpoint_backend'):
        train(config.replace(checkpoint_backend='orbax'), 'cpu')
    with pytest.raises(NotImplementedError, match='not ported'):
        train(config.replace(wavefunction_optimizer_type='SWO'), 'cpu')
    with pytest.raises(ValueError, match='orthogonal_to'):
        train(config.replace(wavefunction_optimizer_type='ExcitedPenalty'),
              'cpu')
    with pytest.raises(ValueError):
        train(config, 'mps')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            train(config, 'cuda')
