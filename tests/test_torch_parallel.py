"""Chain-sharded training and evaluation of the port over torch.distributed,
on the CPU with gloo (parallel/mesh.py and the optimizers' collectives).

Ranks are spawned processes (`parallel.dryrun.spawn_ranks`, a file
rendezvous under tmp_path so parallel test files never share a port, a
time limit on every spawn).  One module-scoped 2-rank spawn runs most
checks and writes an .npz a rank that the small tests read; a 4-rank spawn
checks the collectives again.

The equivalence checks run every optimizer on ONE fixed global batch of
chains (numpy, from a seed) with zero sweeps, so the sampling is out of
the picture: the single process holds all the chains, rank r of two holds
rows r·c .. (r+1)·c − 1, and the 2-rank update must equal the
single-process one at rtol 1e-5 (the same sums in another order).  One
batch an epoch keeps the gathered rows of dense SR in the single
process's order.  The cross-package case holds the port's 2-rank dense SR
update to the JAX package's shard_map update on a 2-device mesh at
rtol 1e-4.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cgs_vmc_tpu_torch import lattice, models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.evaluate import evaluate_operator, exact_expectation
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.optim import (GROUND_STATE_OPTIMIZERS,
                                     SUPERVISED_OPTIMIZERS, common)
from cgs_vmc_tpu_torch.optim.excited import SRPenaltyExcitedOptimizer
from cgs_vmc_tpu_torch.optim.sr import flatten_params
from cgs_vmc_tpu_torch.parallel import dryrun, mesh
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils import ed, interop, profiling

N = 8
CHAINS = 16            # the global batch of the equivalence checks
RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANSATZ = {
    'rbm': dict(wavefunction_type='rbm', num_fc_layers=0, fc_layer_size=8),
    'complex': dict(wavefunction_type='complex',
                    composite_wavefunction_types=('rbm', 'fully_connected'),
                    num_fc_layers=1, fc_layer_size=6),
}
# (case, optimizer, ansatz, overrides) of the fixed-batch equivalences.
CASES = (
    ('EnergyGradient-rbm', 'EnergyGradient', 'rbm', {}),
    ('EnergyGradient-complex', 'EnergyGradient', 'complex', {}),
    ('SR-dense-rbm', 'SR', 'rbm', {'sr_solver': 'dense'}),
    ('SR-dense-complex', 'SR', 'complex', {'sr_solver': 'dense'}),
    ('SR-dense_cg-rbm', 'SR', 'rbm', {'sr_solver': 'dense_cg'}),
    ('SR-sample_cg-rbm', 'SR', 'rbm', {'sr_solver': 'sample_cg'}),
    ('SR-sample_cg-complex', 'SR', 'complex', {'sr_solver': 'sample_cg'}),
    ('SR-cg-rbm', 'SR', 'rbm', {'sr_solver': 'cg'}),
    ('SR-cg-complex', 'SR', 'complex', {'sr_solver': 'cg'}),
    ('ITSWO', 'ITSWO', 'rbm', {}),
    ('LogOverlapITSWO', 'LogOverlapITSWO', 'rbm', {}),
    ('SWO', 'SWO', 'rbm', {}),
    ('LogOverlapSWO', 'LogOverlapSWO', 'rbm', {}),
    ('DualSamplingSWO', 'DualSamplingSWO', 'rbm', {}),
    ('ExcitedPenalty', 'ExcitedPenalty', 'rbm', {}),
    ('ExcitedSR', 'ExcitedSR', 'rbm', {}),
)
BASIS_ITER_BATCH = 16  # a rank's; the single process reads twice as many


def _values(name='EnergyGradient', ansatz='rbm', **overrides):
    values = dict(num_sites=N, batch_size=CHAINS, num_batches_per_epoch=1,
                  num_equilibration_sweeps=0, num_monte_carlo_sweeps=0,
                  heisenberg_jx=-1.0, wavefunction_optimizer_type=name,
                  optimizer='gradient', learning_rates=[2e-2],
                  learning_rate_stops=[], use_fast_sampler=False,
                  sr_diag_shift=1e-2, sr_cg_maxiter=50, sr_cg_tol=1e-7,
                  time_evolution_beta=0.12, orthogonality_penalty=5.0,
                  seed=3, **_ANSATZ[ansatz])
    values.update(overrides)
    return values


def _config(name='EnergyGradient', ansatz='rbm', **overrides):
    return Config(**_values(name, ansatz, **overrides))


def _noisy(wf, seed):
    """wf.init(seed) plus numpy noise (every process draws the same)."""
    rng = np.random.default_rng(seed)
    tree = interop.params_to_numpy(wf.init(torch.Generator().manual_seed(
        seed)))
    return interop.params_from_numpy(models.base.tree_map(
        lambda x: (x + 0.3 * rng.standard_normal(x.shape)).astype(
            np.float32), tree), 'cpu')


def _chains(seed, n=CHAINS):
    rng = np.random.default_rng(seed)
    template = np.repeat([1.0, -1.0], N // 2).astype(np.float32)
    return np.stack([rng.permutation(template) for _ in range(n)])


def _stub_sampler(wf, params, configs, seed):
    """A SamplerState holding `configs` (zero sweeps never move them)."""
    with torch.no_grad():
        amp = wf.apply(params, torch.as_tensor(configs))
    return interop.sampler_state_from_numpy(
        configs, amp.log.numpy(), amp.sign.numpy(), 'cpu', seed)


def _fixed_state(name, ansatz, overrides):
    """(optimizer, the global TrainState on the fixed batch)."""
    config = _config(name, ansatz, **overrides)
    wf = models.build_wavefunction(config)
    params = _noisy(wf, 1)
    if name in SUPERVISED_OPTIMIZERS:
        target_wf = models.build_wavefunction(config)
        opt = SUPERVISED_OPTIMIZERS[name](wf, target_wf, config)
        target = _noisy(target_wf, 7)
        state = opt.init_state(config.seed, 'cpu', target, CHAINS)
    elif name.startswith('Excited'):
        lower_wf = models.build_wavefunction(config)
        lower = _noisy(lower_wf, 9)
        opt = GROUND_STATE_OPTIMIZERS[name](
            wf, build_hamiltonian(config), config,
            lower_states=[(lower_wf, lower)])
        state = opt.init_state(config.seed, 'cpu', CHAINS)
    else:
        opt = GROUND_STATE_OPTIMIZERS[name](wf, build_hamiltonian(config),
                                            config)
        state = opt.init_state(config.seed, 'cpu', CHAINS)
    extra = dict(state.extra)
    if 'target_sampler' in extra:
        # DualSamplingSWO: half the chains each.
        half = CHAINS // 2
        extra['target_sampler'] = _stub_sampler(
            target_wf, extra['target'], _chains(5, half), 5)
        sampler = _stub_sampler(wf, params, _chains(4, half), 4)
    else:
        sampler = _stub_sampler(wf, params, _chains(4), 4)
    if 'lower_samplers' in extra:
        extra['lower_samplers'] = [_stub_sampler(lower_wf, lower,
                                                 _chains(6), 6)]
    return opt, state._replace(params=params, opt_state=opt.sgd.init(params),
                               sampler=sampler, extra=extra)


def _flat(params):
    return flatten_params(params)[0].numpy()


def _metrics(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _collective_inputs(rank):
    rng = np.random.default_rng(100 + rank)
    return {'a': rng.standard_normal((3, 4)).astype(np.float32),
            'b': {'c': rng.standard_normal(5).astype(np.float32),
                  'z': (rng.standard_normal(2) + 1j * rng.standard_normal(2)
                        ).astype(np.complex64)},
            'rows': rng.standard_normal((2, 3)).astype(np.float32),
            'crows': (rng.standard_normal(3) + 1j * rng.standard_normal(3)
                      ).astype(np.complex64)}


def _collectives(rank, group, out):
    x = _collective_inputs(rank)
    tree = {'a': torch.as_tensor(x['a']),
            'b': {'c': torch.as_tensor(x['b']['c']),
                  'z': torch.as_tensor(x['b']['z'])}}
    mean = common.pmean(tree, group)
    total = common.psum(tree, group)
    out['pmean_a'] = mean['a'].numpy()
    out['pmean_c'] = mean['b']['c'].numpy()
    out['pmean_z'] = mean['b']['z'].numpy()
    out['psum_a'] = total['a'].numpy()
    out['psum_z'] = total['b']['z'].numpy()
    out['gather_rows'] = common.all_gather_rows(
        torch.as_tensor(x['rows']), group).numpy()
    out['gather_crows'] = common.all_gather_rows(
        torch.as_tensor(x['crows']), group).numpy()
    out['pmean_scalar'] = common.pmean(torch.tensor(float(rank)),
                                       group).numpy()


def _equivalences(rank, world, group, out):
    for case, name, ansatz, overrides in CASES:
        opt, state = _fixed_state(name, ansatz, overrides)
        ref, ref_metrics = opt.epoch(state)
        sharded = mesh.shard_train_state(state, group)
        new, metrics = opt.epoch(sharded, group=group)
        out[f'{case}/ref'] = _flat(ref.params)
        out[f'{case}/shard'] = _flat(new.params)
        out[f'{case}/ref_metrics'] = json.dumps(_metrics(ref_metrics))
        out[f'{case}/metrics'] = json.dumps(_metrics(metrics))
        if case == 'SR-dense-rbm':
            out['cross/params'] = _flat(state.params)
            out['cross/shard'] = _flat(new.params)


def _basis_iter(rank, world, group, out):
    config = _config('BasisIterSWO', batch_size=BASIS_ITER_BATCH,
                     learning_rates=[5e-2])
    wf = models.build_wavefunction(config)
    _, v0 = ed.ground_state(N, lattice.chain_bonds(N), j_x=-1.0)
    target_wf = FullVector.for_sector(N, np.abs(v0).astype(np.float32))
    target = target_wf.init(torch.Generator())
    opt = SUPERVISED_OPTIMIZERS['BasisIterSWO'](wf, target_wf, config)
    state = mesh.shard_train_state(
        opt.init_state(config.seed, 'cpu', target), group)
    gen = torch.Generator()
    gen.set_state(state.extra['data_generator'].get_state())
    out['basis/indices'] = opt._epoch_indices(gen, rank).numpy()
    first = state
    state, metrics = opt.epoch(state, group=group)
    out['basis/shard1'] = _flat(state.params)
    if rank == 0:
        big = config.replace(batch_size=world * BASIS_ITER_BATCH)
        single = SUPERVISED_OPTIMIZERS['BasisIterSWO'](wf, target_wf, big)
        ref_state = first._replace(extra=dict(
            first.extra, data_generator=torch.Generator().manual_seed(
                config.seed + 2)))
        gen = torch.Generator().manual_seed(config.seed + 2)
        out['basis/single_indices'] = single._epoch_indices(gen).numpy()
        ref, _ = single.epoch(ref_state)
        out['basis/ref1'] = _flat(ref.params)
    losses = [float(metrics['loss'])]
    for _ in range(29):
        state, metrics = opt.epoch(state, group=group)
        losses.append(float(metrics['loss']))
    out['basis/losses'] = np.asarray(losses)


def _chains_per_rank(rank, world, group, out, tmp):
    config = _config(num_equilibration_sweeps=2, num_monte_carlo_sweeps=1,
                     use_fast_sampler=True, batch_size=CHAINS)
    opt = GROUND_STATE_OPTIMIZERS['EnergyGradient'](
        models.build_wavefunction(config), build_hamiltonian(config), config)
    state = opt.init_state(config.seed, 'cpu', CHAINS)
    out['chains/global'] = state.sampler.configs.numpy()
    state = mesh.shard_train_state(state, group)
    out['chains/start'] = state.sampler.configs.numpy()
    for _ in range(2):
        state, _ = opt.epoch(state, group=group)
    out['chains/after'] = state.sampler.configs.numpy()
    try:
        mesh.chains_per_device(CHAINS + 1, group)
    except ValueError as err:
        out['chains/error'] = str(err)


def _evaluate(rank, world, group, out):
    config = _config(batch_size=64, num_equilibration_sweeps=20,
                     num_monte_carlo_sweeps=2, num_evaluation_samples=60,
                     num_devices=world, use_fast_sampler=True)
    wf = models.build_wavefunction(config)
    params = _noisy(wf, 2)
    ham = build_hamiltonian(config)
    result = evaluate_operator(wf, params, ham, config, 'cpu', seed=17)
    out['eval/mean'] = result.mean
    out['eval/error'] = result.error
    out['eval/values'] = result.values
    out['eval/acc'] = result.acceptance_rate
    if rank == 0:
        out['eval/exact'] = exact_expectation(wf, params, ham, N)


def _train_config(directory, **overrides):
    values = dict(batch_size=CHAINS, num_equilibration_sweeps=2,
                  num_monte_carlo_sweeps=1, num_batches_per_epoch=2,
                  use_fast_sampler=True, num_devices=2, checkpoint_frequency=1,
                  max_checkpoints_to_keep=10, checkpoint_dir=directory,
                  optimizer='adam', learning_rates=[1e-2])
    values.update(overrides)
    return _config(**values)


def _ema_and_resume(rank, world, group, out, tmp):
    config = _train_config(os.path.join(tmp, 'ema'), num_epochs=3,
                           param_ema_decay=0.7)
    state = train(config, 'cpu')
    out['ema/slot'] = _flat(state.extra['ema_params'])
    out['ema/params'] = _flat(state.params)

    straight = _train_config(os.path.join(tmp, 'straight'), num_epochs=4)
    a = train(straight, 'cpu')
    resumed = _train_config(os.path.join(tmp, 'resumed'), num_epochs=2)
    train(resumed, 'cpu')
    b = train(resumed.replace(num_epochs=4), 'cpu', resume=True)
    out['resume/a_params'] = _flat(a.params)
    out['resume/b_params'] = _flat(b.params)
    out['resume/a_configs'] = a.sampler.configs.numpy()
    out['resume/b_configs'] = b.sampler.configs.numpy()
    out['resume/a_gen'] = a.sampler.generator.get_state().numpy()
    out['resume/b_gen'] = b.sampler.generator.get_state().numpy()


def _excited_oracle(rank, world, group, out):
    """tests/test_excited.py:281 on two ranks: psi == psi_0 exactly."""
    bonds = lattice.chain_bonds(N)
    e0, v0 = ed.ground_state(N, bonds, j_x=-1.0)
    config = _config('ExcitedSR', batch_size=4 * world,
                     num_batches_per_epoch=2, num_equilibration_sweeps=5,
                     num_monte_carlo_sweeps=1, learning_rates=[0.0],
                     orthogonality_penalty=10.0)
    wf0 = FullVector.for_sector(N, v0.astype(np.float32))
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    opt = SRPenaltyExcitedOptimizer(
        wf, HeisenbergHamiltonian(bonds, -1.0, 1.0), config,
        lower_states=[(wf0, wf0.init(torch.Generator()))])
    state = mesh.shard_train_state(
        opt.init_state(21, 'cpu', config.batch_size), group)
    out['excited/lower_rows'] = state.extra['lower_samplers'][0] \
        .configs.shape[0]
    _, metrics = opt.epoch(state, group=group)
    out['excited/overlap'] = float(metrics['overlap'])
    out['excited/energy'] = float(metrics['energy'])
    out['excited/e0'] = e0


def _two_rank_checks(rank, world, tmp):
    group = mesh.make_mesh(world)
    out = {}
    _collectives(rank, group, out)
    profiling.reset_counters('collectives')
    _equivalences(rank, world, group, out)
    _basis_iter(rank, world, group, out)
    _chains_per_rank(rank, world, group, out, tmp)
    _evaluate(rank, world, group, out)
    _ema_and_resume(rank, world, group, out, tmp)
    _excited_oracle(rank, world, group, out)
    np.savez(os.path.join(tmp, f'rank{rank}.npz'), **out)


def _four_rank_checks(rank, world, tmp):
    out = {}
    _collectives(rank, mesh.make_mesh(world), out)
    np.savez(os.path.join(tmp, f'rank{rank}.npz'), **out)


def _load_ranks(tmp, world):
    return [dict(np.load(os.path.join(tmp, f'rank{r}.npz')))
            for r in range(world)]


@pytest.fixture(scope='module')
def two(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('two_ranks'))
    dryrun.spawn_ranks(_two_rank_checks, 2, (tmp,),
                       'file://' + os.path.join(tmp, 'rendezvous'),
                       timeout_s=240)
    return tmp, _load_ranks(tmp, 2)


@pytest.fixture(scope='module')
def four(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp('four_ranks'))
    dryrun.spawn_ranks(_four_rank_checks, 4, (tmp,),
                       'file://' + os.path.join(tmp, 'rendezvous'),
                       timeout_s=180)
    return _load_ranks(tmp, 4)


def _check_collectives(ranks):
    world = len(ranks)
    inputs = [_collective_inputs(r) for r in range(world)]
    for out in ranks:
        np.testing.assert_allclose(
            out['pmean_a'], np.mean([x['a'] for x in inputs], 0), rtol=1e-6)
        np.testing.assert_allclose(
            out['pmean_c'], np.mean([x['b']['c'] for x in inputs], 0),
            rtol=1e-6)
        np.testing.assert_allclose(
            out['pmean_z'], np.mean([x['b']['z'] for x in inputs], 0),
            rtol=1e-6)
        np.testing.assert_allclose(
            out['psum_a'], np.sum([x['a'] for x in inputs], 0), rtol=1e-6)
        np.testing.assert_allclose(
            out['psum_z'], np.sum([x['b']['z'] for x in inputs], 0),
            rtol=1e-6)
        np.testing.assert_array_equal(
            out['gather_rows'], np.concatenate([x['rows'] for x in inputs]))
        np.testing.assert_array_equal(
            out['gather_crows'],
            np.concatenate([x['crows'] for x in inputs]))
        assert float(out['pmean_scalar']) == pytest.approx(
            (world - 1) / 2, rel=1e-7)


def test_collectives_two_ranks(two):
    _check_collectives(two[1])


def test_collectives_four_ranks(four):
    _check_collectives(four)


@pytest.mark.parametrize('case', [c[0] for c in CASES])
def test_two_rank_epoch_equals_single_process(two, case):
    """The 2-rank update on the fixed global batch equals the
    single-process update, on both ranks, at rtol 1e-5."""
    ranks = two[1]
    for out in ranks:
        np.testing.assert_allclose(out[f'{case}/shard'], out[f'{case}/ref'],
                                   rtol=RTOL, atol=1e-7)
        got = json.loads(str(out[f'{case}/metrics']))
        want = json.loads(str(out[f'{case}/ref_metrics']))
        assert set(got) == set(want)
        for name, value in want.items():
            if name == 'sr_residual_norm':
                # It sits at the solver's rounding noise: held as the
                # port's SR tests hold it, within 1e-4·(1 + |g|).
                assert abs(got[name] - value) <= 1e-4 * (
                    1 + want['grad_norm']), name
                continue
            assert got[name] == pytest.approx(value, rel=RTOL, abs=1e-6), \
                name
    np.testing.assert_array_equal(ranks[0][f'{case}/shard'],
                                  ranks[1][f'{case}/shard'])


def test_dense_sr_two_ranks_matches_jax(two):
    """The port's 2-rank dense SR update on the fixed batch against the
    JAX package on the same batch, at rtol 1e-4: its single-device dense
    epoch, and its shard_map 'sample_cg' epoch on a 2-device mesh (the
    JAX sharded solver that centers with the global mean).  Its shard_map
    'dense' epoch centers each shard by its own mean (the re-centering
    after its gather is a no-op), so it solves another system: pinned
    here as a fault of the reference (ROADMAP.md §3)."""
    import jax
    import jax.numpy as jnp
    from cgs_vmc_tpu.config import Config as JaxConfig
    from cgs_vmc_tpu.models import build_wavefunction as jax_build
    from cgs_vmc_tpu.optim import StochasticReconfiguration as JaxSR
    from cgs_vmc_tpu.parallel import mesh as jax_mesh
    from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSampler
    from cgs_vmc_tpu.train import build_hamiltonian as jax_hamiltonian

    port_wf = models.build_wavefunction(_config('SR', 'rbm'))
    params = interop.params_to_numpy(_noisy(port_wf, 1))
    configs = _chains(4)
    device_mesh = jax_mesh.make_mesh(2)

    def jax_epoch(solver, sharded):
        jax_config = JaxConfig(**_values('SR', 'rbm', sr_solver=solver))
        jax_wf = jax_build(jax_config)
        opt = JaxSR(jax_wf, jax_hamiltonian(jax_config), jax_config)
        state = opt.init_state(jax.random.key(0), CHAINS)
        amp = jax_wf.apply(params, configs)
        zeros = jnp.zeros(CHAINS, jnp.float32)
        state = state._replace(
            params=jax.tree.map(jnp.asarray, params),
            opt_state=opt.optax_opt.init(params),
            sampler=JaxSampler(jnp.asarray(configs), amp.log, amp.sign,
                               jax.random.split(jax.random.key(1), CHAINS),
                               zeros, zeros))
        if not sharded:
            return _flat_like(params, jax.jit(opt.epoch)(state)[0].params)
        _, shapes = jax.eval_shape(opt.epoch, state)
        fn = jax_mesh.sharded_epoch_fn(opt.epoch, device_mesh, state,
                                       list(shapes))
        new, _ = fn(jax_mesh.shard_train_state(state, device_mesh))
        return _flat_like(params, jax.device_get(new.params))

    got = two[1][0]
    np.testing.assert_array_equal(got['cross/params'],
                                  _flat_like(params, params))
    single = jax_epoch('dense', sharded=False)
    np.testing.assert_allclose(got['cross/shard'], single, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got['cross/shard'],
                               jax_epoch('sample_cg', sharded=True),
                               rtol=1e-4, atol=1e-6)
    jax_sharded_dense = jax_epoch('dense', sharded=True)
    assert not np.allclose(jax_sharded_dense, single, rtol=1e-4, atol=1e-6)


def _flat_like(template, tree):
    """The leaves of `tree` (a nested dict with `template`'s keys) in the
    order of the port's `template`, concatenated."""
    ordered = models.base.tree_map(lambda _, x: np.asarray(x), template,
                                   tree)
    return np.concatenate([x.ravel() for x in
                           models.base.tree_leaves(ordered)])


def test_basis_iter_ranks_read_disjoint_rows(two):
    ranks = two[1]
    a, b = ranks[0]['basis/indices'], ranks[1]['basis/indices']
    assert len(a) == len(b) == BASIS_ITER_BATCH
    assert not set(a.tolist()) & set(b.tolist())
    np.testing.assert_array_equal(np.concatenate([a, b]),
                                  ranks[0]['basis/single_indices'])


def test_basis_iter_two_ranks_equal_single_process(two):
    """Two ranks of batch b read the rows one process of batch 2b reads
    in one batch: the same update at rtol 1e-5."""
    for out in two[1]:
        np.testing.assert_allclose(out['basis/shard1'],
                                   two[1][0]['basis/ref1'], rtol=RTOL,
                                   atol=1e-7)


def test_basis_iter_sharded_descends(two):
    losses = two[1][0]['basis/losses']
    assert len(losses) == 30 and np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    np.testing.assert_array_equal(losses, two[1][1]['basis/losses'])


def test_distinct_chains_on_distinct_ranks(two):
    r0, r1 = two[1]
    c = CHAINS // 2
    np.testing.assert_array_equal(r0['chains/global'], r1['chains/global'])
    np.testing.assert_array_equal(r0['chains/start'],
                                  r0['chains/global'][:c])
    np.testing.assert_array_equal(r1['chains/start'],
                                  r1['chains/global'][c:])
    # Both ranks' chains moved, and not in lockstep.
    assert not np.array_equal(r0['chains/after'], r0['chains/start'])
    assert not np.array_equal(r0['chains/after'] - r0['chains/start'],
                              r1['chains/after'] - r1['chains/start'])


def test_chains_per_device_and_make_mesh_errors(two):
    assert str(two[1][0]['chains/error']) == (
        f'batch_size={CHAINS + 1} not divisible by mesh size 2')
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match=r'Requested 8 devices, have 1; '
                       r'.*torchrun --nproc_per_node=8'):
        mesh.make_mesh(8)
    with pytest.raises(ValueError, match='Requested 2 devices, have 1'):
        train(_config(num_devices=2, num_epochs=1), 'cpu')
    assert mesh.chains_group(1) is None


def test_sharded_evaluate_matches_exact(two):
    r0, r1 = two[1]
    for key in ('eval/mean', 'eval/error', 'eval/values', 'eval/acc'):
        np.testing.assert_array_equal(r0[key], r1[key])
    mean, err = float(r0['eval/mean']), float(r0['eval/error'])
    exact = float(r0['eval/exact'])
    assert np.isfinite(err) and err > 0
    assert abs(mean - exact) < 5 * err, (mean, err, exact)
    assert 0.05 < float(r0['eval/acc']) < 1.0


def test_ema_on_the_mesh(two):
    """The EMA slot of a 2-rank run equals the recursion over the params
    its checkpoints hold, and is the same on both ranks."""
    tmp, ranks = two
    np.testing.assert_array_equal(ranks[0]['ema/slot'], ranks[1]['ema/slot'])
    run = os.path.join(tmp, 'ema')
    params = [_flat(ckpt_lib.restore_params_from_checkpoint(
        os.path.join(run, f'ckpt_epoch_{e}.pt'), 'cpu')) for e in range(4)]
    ema = params[0].astype(np.float64)
    for p in params[1:]:
        ema = 0.7 * ema + 0.3 * p
    np.testing.assert_allclose(ranks[0]['ema/slot'], ema, rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_array_equal(ranks[0]['ema/params'], params[3])


def test_two_rank_resume_is_exact(two):
    for out in two[1]:
        for key in ('params', 'configs', 'gen'):
            np.testing.assert_array_equal(out[f'resume/a_{key}'],
                                          out[f'resume/b_{key}'])
    assert not np.array_equal(two[1][0]['resume/a_configs'],
                              two[1][1]['resume/a_configs'])


def test_resume_at_another_count_raises(two):
    tmp, _ = two
    config = _train_config(os.path.join(tmp, 'straight'), num_epochs=5,
                           num_devices=1)
    with pytest.raises(ValueError, match=r'written by a run of 2 rank\(s\); '
                       r'resume it with num_devices=2'):
        train(config, 'cpu', resume=True)
    # Its params read at any count.
    params = ckpt_lib.restore_params_from_checkpoint(
        ckpt_lib.latest_checkpoint(os.path.join(tmp, 'straight')), 'cpu')
    np.testing.assert_array_equal(_flat(params), two[1][0]['resume/a_params'])


def test_sharded_excited_sr_identical_state_oracle(two):
    for out in two[1]:
        assert int(out['excited/lower_rows']) == 4
        assert abs(float(out['excited/overlap']) - 1.0) < 1e-4
        assert abs(float(out['excited/energy'])
                   - float(out['excited/e0'])) < 1e-3


def test_world_size_one_is_the_plain_path_bit_for_bit(tmp_path):
    """A 1-rank process group takes the sharded path; it trains and
    evaluates bit for bit as no group does."""
    config = _config(num_equilibration_sweeps=2, num_monte_carlo_sweeps=1,
                     num_batches_per_epoch=2, use_fast_sampler=True,
                     optimizer='adam', learning_rates=[1e-2], num_epochs=3,
                     num_evaluation_samples=5)
    plain = train(config, 'cpu')
    wf = models.build_wavefunction(config)
    ham = build_hamiltonian(config)
    plain_eval = evaluate_operator(wf, plain.params, ham, config, 'cpu')
    mesh.initialize_distributed('gloo', 'file://' + str(tmp_path / 'rdv'),
                                1, 0)
    try:
        assert mesh.chains_group(1) is dist.group.WORLD
        profiling.reset_counters('collectives')
        sharded = train(config, 'cpu')
        collectives = profiling.counter('collectives')
        sharded_eval = evaluate_operator(wf, sharded.params, ham, config,
                                         'cpu')
    finally:
        dist.destroy_process_group()
    assert collectives == 3   # one pmean a dtype an epoch: all float32
    np.testing.assert_array_equal(_flat(sharded.params), _flat(plain.params))
    assert torch.equal(sharded.sampler.configs, plain.sampler.configs)
    np.testing.assert_array_equal(sharded_eval.values, plain_eval.values)
    assert sharded_eval.acceptance_rate == plain_eval.acceptance_rate


def test_torchrun_cli_train_two_ranks(tmp_path):
    run = tmp_path / 'run'
    override = ('num_sites=8,wavefunction_type=rbm,num_fc_layers=0,'
                'fc_layer_size=8,batch_size=32,num_epochs=3,'
                'wavefunction_optimizer_type=SR,heisenberg_jx=-1.0,'
                'optimizer=gradient,learning_rates=[5e-2],'
                'learning_rate_stops=[],num_devices=2')
    env = dict(os.environ, OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node=2', '-m', 'cgs_vmc_tpu_torch.cli', 'train',
         '--device', 'cpu', '--checkpoint_dir', str(run), '--override',
         override], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    # Rank 0 alone prints and writes the metrics.
    assert proc.stdout.count('epoch     3') == 1
    with open(run / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert [r['epoch'] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r['energy']) for r in records)
    raw = torch.load(run / 'ckpt_epoch_3.pt', weights_only=True)
    assert len(raw['sampler']['generator_state']) == 2
    assert raw['sampler']['configs'].shape[0] == 32


def test_dryrun_multichip_two_ranks(capfd):
    dryrun.dryrun_multichip(2, timeout_s=180)
    out = capfd.readouterr().out
    assert 'dryrun_multichip(2): energy=' in out and out.rstrip().endswith(
        'OK')
