"""Multiple-try Metropolis, parallel tempering and the exact autoregressive
sampler of the PyTorch port, with the registry that resolves them, on the
CPU.

The registry is held to the JAX package's `resolved_name` for every knob
combination (one known difference: a pure RBM resolves to 'rbm_kernel' here
on any device, where the JAX entry is offered on a TPU only).  Deterministic
pieces are held to the JAX package exactly (`geometric_ladder` 1e-7,
`_swap_round` on injected uniforms, `mc_step(beta=...)` on shared
proposals); the samplers themselves by the Born distribution over the
enumerated N=8 sector: total variation < 0.05 from 512 chains × 32
snapshots (the bar of tests/test_torch_fast_samplers.py; 16,384 draws over
70 states have a sampling noise of ~0.025).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.sampler import metropolis as jax_metropolis
from cgs_vmc_tpu.sampler import registry as jax_registry
from cgs_vmc_tpu.sampler import tempering as jax_tempering
from cgs_vmc_tpu_torch import basis, models
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_tpu_torch.sampler import (
    fast_ar, metropolis, mtm, registry, tempering)
from cgs_vmc_tpu_torch.train import build_hamiltonian
from cgs_vmc_tpu_torch.utils import checkpoint, interop


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """These tensors are tiny: with several test workers on one machine,
    torch's intra-op thread pools only fight each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 8
_ANSATZES = {
    'rbm': dict(wavefunction_type='rbm', num_fc_layers=0, fc_layer_size=8),
    'jastrow': dict(wavefunction_type='jastrow'),
    'made': dict(wavefunction_type='made', num_fc_layers=1,
                 fc_layer_size=12),
    'pixelcnn': dict(wavefunction_type='pixelcnn', size_x=4, size_y=2,
                     num_conv_layers=2, num_conv_filters=4),
    'complex_made': dict(wavefunction_type='complex',
                         composite_wavefunction_types=('made',
                                                       'fully_connected'),
                         num_fc_layers=1, fc_layer_size=12),
    'complex_fc': dict(wavefunction_type='complex',
                       composite_wavefunction_types=('fully_connected',
                                                     'fully_connected'),
                       num_fc_layers=1, fc_layer_size=12),
}


def _setup(kind, seed=0, chains=32, noise=0.3, **overrides):
    """(config, JAX wf, wf, numpy params, params): the JAX init with `seed`
    plus numpy noise, carried over with interop."""
    config = Config(num_sites=N, batch_size=chains, **_ANSATZES[kind],
                    **overrides)
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    raw = jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    return (config, jax_wf, models.build_wavefunction(config), raw,
            interop.params_from_numpy(raw, 'cpu'))


# ---------------------------------------------------------------------------
# Registry.

_KNOBS = list(itertools.product((0, 1, 4), (0, 1, 3), ('exchange', 'flip'),
                                (True, False), (0, 2)))


@pytest.mark.parametrize('kind', sorted(_ANSATZES))
def test_registry_resolves_every_knob_combination_as_jax(kind):
    """mtm_candidates × pt_replicas × move × use_fast_sampler × total_sz2
    (72 combinations an ansatz) against the JAX registry."""
    wf = jax_wf = None
    for k, replicas, move, fast, sz2 in _KNOBS:
        config = Config(num_sites=N, **_ANSATZES[kind], mtm_candidates=k,
                        pt_replicas=replicas, mc_move_type=move,
                        use_fast_sampler=fast, total_sz2=sz2)
        if wf is None:
            wf, jax_wf = models.build_wavefunction(config), jax_build(config)
        ours = registry.resolved_name(wf, config)
        theirs = jax_registry.resolved_name(jax_wf, config)
        if ours == 'rbm_kernel':
            # The one known difference: the JAX entry ('rbm_pallas') is
            # gated on the TPU backend, so on the CPU it falls through.
            assert kind == 'rbm' and theirs == 'generic'
            assert move == 'exchange' and fast and not sz2
        else:
            assert ours == theirs, (k, replicas, move, fast, sz2)


def test_registry_names_the_three_new_entries():
    for kind, overrides, name in (
            ('jastrow', dict(pt_replicas=2, mtm_candidates=4), 'tempering'),
            ('jastrow', dict(pt_replicas=2, mc_move_type='flip'),
             'tempering'),
            ('made', dict(mtm_candidates=2), 'mtm'),
            ('made', {}, 'exact_autoregressive'),
            ('pixelcnn', {}, 'exact_autoregressive'),
            ('complex_made', {}, 'exact_autoregressive'),
            ('complex_fc', {}, 'generic'),
            ('made', dict(use_fast_sampler=False), 'generic'),
            ('made', dict(total_sz2=2), 'generic')):
        config = Config(num_sites=N, **_ANSATZES[kind], **overrides)
        assert registry.resolved_name(models.build_wavefunction(config),
                                      config) == name, (kind, overrides)


# ---------------------------------------------------------------------------
# The Born distribution.

def _born_tv(wf, params, state, sweeps_fn, sweeps=2):
    states = basis.enumerate_sz_basis(N)
    with torch.no_grad():
        log = wf.apply(params, torch.tensor(states)).log.real.double().numpy()
    exact = np.exp(2 * (log - log.max()))
    exact /= exact.sum()
    weights = 2 ** np.arange(N)
    index = {int(code): row for row, code in
             enumerate(((states > 0) * weights).sum(axis=1))}
    counts = np.zeros(len(states))
    for it in range(40):
        state = sweeps_fn(params, state, sweeps)
        if it >= 8:
            codes = ((state.configs.numpy() > 0) * weights).sum(axis=1)
            np.add.at(counts, [index[int(c)] for c in codes], 1)
    return 0.5 * np.abs(counts / counts.sum() - exact).sum(), state


@pytest.mark.parametrize('k', [1, 4])
def test_mtm_samples_born_distribution(k):
    config, _, wf, _, params = _setup('rbm', seed=7, chains=512, noise=0.5)
    state = metropolis.init_sampler_for(11, wf, params, config, 'cpu')
    tv, state = _born_tv(
        wf, params, state,
        lambda p, s, n: mtm.run_sweeps(wf, p, s, n, k=k))
    assert tv < 0.05, f'TV distance {tv} too large'
    assert bool((state.configs.sum(dim=1) == 0).all())
    assert float(state.num_proposed[0]) == 40 * 2 * max(N // k, 1)
    rate = float(metropolis.acceptance_rate(state))
    assert 0.05 < rate < 1.0
    with torch.no_grad():
        fresh = wf.apply(params, state.configs)
    torch.testing.assert_close(state.log_amp, fresh.log, rtol=1e-5,
                               atol=1e-5)


def test_mtm_complex_log_and_zero_sweeps():
    """A complex log is carried as it is (only its real part weighs), and
    zero sweeps return the state untouched."""
    config, _, wf, _, params = _setup('complex_fc', seed=3, chains=16,
                                      mtm_candidates=3)
    state = metropolis.init_sampler_for(4, wf, params, config, 'cpu')
    sweeps = registry.resolve_sweeps_fn(wf, config)
    assert sweeps(params, state, 0) is state
    new = sweeps(params, state, 2)
    assert new.log_amp.dtype == torch.complex64
    with torch.no_grad():
        fresh = wf.apply(params, new.configs)
    torch.testing.assert_close(new.log_amp, fresh.log, rtol=1e-5, atol=1e-5)
    assert float(new.num_proposed[0]) == 2 * (N // 3)


def test_mtm_selection_never_picks_a_zero_amplitude():
    """Rows with all but one logit at -inf select the finite one and give
    no NaN."""
    logits = torch.full((64, 5), -torch.inf)
    finite = torch.arange(64) % 5
    logits[torch.arange(64), finite] = 0.3
    picked = mtm._categorical(torch.Generator().manual_seed(0), logits)
    assert torch.equal(picked, finite)


def test_tempering_physical_replica_samples_born_distribution():
    config, _, wf, _, params = _setup('rbm', seed=7, chains=512, noise=0.5,
                                      pt_replicas=3, pt_beta_min=0.3)
    state = metropolis.init_sampler_for(12, wf, params, config, 'cpu')
    assert isinstance(state, tempering.PTSamplerState)
    sweeps = registry.resolve_sweeps_fn(wf, config)
    tv, state = _born_tv(wf, params, state, sweeps, sweeps=2)
    assert tv < 0.05, f'TV distance {tv} too large'
    # Physical-replica statistics only; the swap rounds of a call alternate
    # parities from 0, as the JAX package's loop index does.
    assert float(state.num_proposed[0]) == 40 * 2 * N
    np.testing.assert_array_equal(state.swap_proposed[0].numpy(), [40, 40])
    one = sweeps(params, metropolis.reset_stats(state), 1)
    np.testing.assert_array_equal(one.swap_proposed[0].numpy(), [1, 0])
    rates = tempering.swap_rate(state).numpy()
    assert ((rates > 0.2) & (rates <= 1.0)).all(), rates
    # The hot replicas are flatter than the physical one.
    assert float(state.aux_log[:, -1].mean()) < float(state.log_amp.mean())
    fresh = metropolis.refresh_amplitudes(wf, params, state)
    torch.testing.assert_close(fresh.aux_log, state.aux_log, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(fresh.log_amp, state.log_amp, rtol=1e-5,
                               atol=1e-5)
    reset = metropolis.reset_stats(state)
    assert float(reset.swap_proposed.sum()) == 0.0
    assert float(reset.num_proposed.sum()) == 0.0
    assert torch.equal(reset.aux_configs, state.aux_configs)


def test_tempering_with_the_flip_move_leaves_the_sector():
    config, _, wf, _, params = _setup('rbm', seed=2, chains=64,
                                      pt_replicas=2, mc_move_type='flip')
    state = metropolis.init_sampler_for(5, wf, params, config, 'cpu')
    state = registry.resolve_sweeps_fn(wf, config)(params, state, 3)
    assert len(state.configs.sum(dim=1).unique()) > 1


# ---------------------------------------------------------------------------
# Deterministic pieces against the JAX package.

@pytest.mark.parametrize('replicas,beta_min', [(2, 0.4), (4, 0.25),
                                               (7, 0.9)])
def test_geometric_ladder_matches_jax(replicas, beta_min):
    ours = tempering.geometric_ladder(replicas, beta_min).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jax_tempering.geometric_ladder(replicas, beta_min)),
        rtol=1e-6, atol=1e-7)
    assert ours[0] == 1.0 and abs(ours[-1] - beta_min) < 1e-6
    with pytest.raises(ValueError, match='>= 2'):
        tempering.geometric_ladder(1, 0.5)
    with pytest.raises(ValueError, match='pt_beta_min'):
        tempering.geometric_ladder(3, 1.5)


def _shared_ladders(kind, chains=24, replicas=4, seed=0):
    """The same ladder in both packages: (JAX state, port state, ...)."""
    config, jax_wf, wf, raw, params = _setup(
        kind, seed=seed, chains=chains, pt_replicas=replicas,
        pt_beta_min=0.3)
    jax_state = jax_tempering.init_pt_sampler(
        jax.random.key(seed + 1), jax_wf, raw, N, chains, replicas, 0.3)
    fields = {name: np.asarray(getattr(jax_state, name)) for name in (
        'configs', 'log_amp', 'sign', 'aux_configs', 'aux_log', 'aux_sign',
        'betas')}
    state = interop.pt_sampler_state_from_numpy(device='cpu', **fields)
    return config, jax_wf, wf, raw, params, jax_state, state


@pytest.mark.parametrize('kind', ['rbm', 'complex_fc'])
@pytest.mark.parametrize('parity', [0, 1])
def test_swap_round_matches_jax_on_injected_uniforms(kind, parity):
    """The port's `_swap_round`, fed the uniforms the JAX package draws from
    its swap keys, makes the same swaps."""
    _, _, _, _, _, jax_state, state = _shared_ladders(kind)

    def uniforms_of(key):
        _, k_u = jax.random.split(key)
        return jax.random.uniform(k_u, (3,))

    uniforms = np.asarray(jax.vmap(uniforms_of)(jax_state.swap_keys))
    jax_new = jax_tempering._swap_round(jax_state, jnp.asarray(parity))
    new = tempering._swap_round(state, parity, torch.tensor(uniforms))
    for name in ('configs', 'log_amp', 'sign', 'aux_configs', 'aux_log',
                 'aux_sign', 'betas', 'swap_accepted', 'swap_proposed'):
        np.testing.assert_array_equal(getattr(new, name).numpy(),
                                      np.asarray(getattr(jax_new, name)),
                                      err_msg=name)
    accepted = new.swap_accepted.numpy()
    assert accepted[:, 1 - parity::2].sum() == 0
    assert 0 < accepted.sum() < accepted[:, parity::2].size


@pytest.mark.parametrize('kind', ['rbm', 'complex_fc'])
def test_tempered_mc_step_matches_jax_on_shared_proposals(kind, monkeypatch):
    """`mc_step(beta=...)` with the proposal and its acceptance uniforms
    given to both packages: the same accepts, the same new state; beta
    changes which moves are accepted."""
    config, jax_wf, wf, raw, params = _setup(kind, seed=3, chains=64)
    rng = np.random.default_rng(4)
    template = np.repeat([1.0, -1.0], N // 2)
    configs, proposed = (
        np.stack([rng.permutation(template) for _ in range(64)]
                 ).astype(np.float32) for _ in range(2))
    accept_u = rng.random(64).astype(np.float32)
    beta = rng.uniform(0.2, 1.0, 64).astype(np.float32)

    monkeypatch.setitem(
        jax_metropolis.PROPOSALS, 'given',
        lambda keys, c: (jnp.asarray(proposed), jnp.asarray(accept_u), keys))
    monkeypatch.setitem(
        metropolis.PROPOSALS, 'given',
        lambda generator, c: (torch.as_tensor(proposed),
                              torch.as_tensor(accept_u)))
    amp = jax_wf.apply(raw, jnp.asarray(configs))
    zeros = jnp.zeros(64, jnp.float32)
    jax_state = jax_metropolis.SamplerState(
        jnp.asarray(configs), amp.log, amp.sign,
        jax.random.split(jax.random.key(0), 64), zeros, zeros)
    state = interop.sampler_state_from_numpy(
        configs, np.asarray(amp.log), np.asarray(amp.sign), 'cpu')
    accepts = {}
    for label, b in (('tempered', beta), ('physical', None)):
        jax_new = jax_metropolis.mc_step(
            jax_wf, raw, jax_state, 'given',
            None if b is None else jnp.asarray(b))
        new = metropolis.mc_step(wf, params, state, 'given',
                                 None if b is None else torch.as_tensor(b))
        np.testing.assert_array_equal(new.configs.numpy(),
                                      np.asarray(jax_new.configs))
        np.testing.assert_array_equal(new.num_accepted.numpy(),
                                      np.asarray(jax_new.num_accepted))
        np.testing.assert_allclose(new.log_amp.numpy(),
                                   np.asarray(jax_new.log_amp), rtol=1e-5,
                                   atol=1e-5)
        accepts[label] = new.num_accepted.numpy()
    assert 0 < accepts['physical'].sum() < 64
    assert (accepts['tempered'] != accepts['physical']).any()


def test_run_sweeps_on_a_shared_ladder_keeps_the_jax_invariants():
    """From the JAX package's ladder (carried by interop) a tempered sweep
    keeps every replica in the sector, counts only the physical replica's
    moves, and leaves the betas alone."""
    config, _, wf, _, params, jax_state, state = _shared_ladders('jastrow')
    new = tempering.run_sweeps(wf, params, state, 2)
    assert bool((new.configs.sum(dim=1) == 0).all())
    assert bool((new.aux_configs.sum(dim=2) == 0).all())
    assert bool((new.num_proposed == 2 * N).all())
    assert torch.equal(new.betas, state.betas)
    np.testing.assert_array_equal(new.swap_proposed[0].numpy(), [1, 1, 1])
    assert tempering.run_sweeps(wf, params, state, 0) is state


# ---------------------------------------------------------------------------
# Checkpoints.

def test_tempered_run_resumes_exactly_from_a_checkpoint(tmp_path):
    """A TrainState holding a PTSamplerState round-trips through a
    checkpoint (weights_only load), and the epoch after it equals the
    uninterrupted run's bit for bit."""
    config = Config(num_sites=N, **_ANSATZES['rbm'], batch_size=16,
                    num_batches_per_epoch=2, num_equilibration_sweeps=1,
                    num_monte_carlo_sweeps=1, heisenberg_jx=-1.0,
                    wavefunction_optimizer_type='EnergyGradient',
                    pt_replicas=3, pt_beta_min=0.3)
    wf = models.build_wavefunction(config)
    opt = GROUND_STATE_OPTIMIZERS['EnergyGradient'](
        wf, build_hamiltonian(config), config)
    state, _ = opt.epoch(opt.init_state(5, 'cpu', config.batch_size))
    assert isinstance(state.sampler, tempering.PTSamplerState)
    path = checkpoint.save_checkpoint(str(tmp_path), state, 1)
    restored = checkpoint.restore_checkpoint(path, 'cpu')
    assert isinstance(restored.sampler, tempering.PTSamplerState)
    for name in tempering.PTSamplerState._fields:
        if name != 'generator':
            assert torch.equal(getattr(restored.sampler, name),
                               getattr(state.sampler, name)), name
    straight, straight_metrics = opt.epoch(state)
    resumed, resumed_metrics = opt.epoch(restored)
    assert float(straight_metrics['energy']) == float(
        resumed_metrics['energy'])
    for name in tempering.PTSamplerState._fields:
        if name != 'generator':
            assert torch.equal(getattr(resumed.sampler, name),
                               getattr(straight.sampler, name)), name
    assert torch.equal(resumed.sampler.generator.get_state(),
                       straight.sampler.generator.get_state())
    assert float(straight.sampler.swap_proposed.sum()) > 0


def test_a_ladder_inside_extra_round_trips(tmp_path):
    """A PTSamplerState held in TrainState.extra (a second sampler) is
    encoded as a tagged sampler too."""
    config, _, wf, _, params, _, ladder = _shared_ladders('rbm', chains=8)
    opt = GROUND_STATE_OPTIMIZERS['EnergyGradient'](
        wf, build_hamiltonian(config.replace(heisenberg_jx=-1.0)), config)
    state = opt.init_state(1, 'cpu', 8)._replace(
        extra={'target_sampler': ladder})
    path = checkpoint.save_checkpoint(str(tmp_path), state, 0)
    back = checkpoint.restore_checkpoint(path, 'cpu').extra['target_sampler']
    assert isinstance(back, tempering.PTSamplerState)
    assert torch.equal(back.aux_configs, ladder.aux_configs)
    assert torch.equal(back.betas, ladder.betas)


# ---------------------------------------------------------------------------
# The exact autoregressive sampler.

@pytest.mark.parametrize('kind', ['made', 'pixelcnn', 'complex_made'])
def test_fast_ar_draws_fresh_samples_with_acceptance_one(kind):
    config, _, wf, _, params = _setup(kind, seed=6, chains=256)
    assert fast_ar.supports(wf)
    state = metropolis.init_sampler_for(7, wf, params, config, 'cpu')
    sweeps = registry.resolve_sweeps_fn(wf, config)
    first = sweeps(params, state, 0)       # no num_sweeps <= 0 shortcut
    second = sweeps(params, first, 0)
    assert not torch.equal(first.configs, state.configs)
    assert not torch.equal(second.configs, first.configs)
    assert float(metropolis.acceptance_rate(second)) == 1.0
    assert float(second.num_proposed[0]) == 2.0
    assert bool((second.configs.sum(dim=1) == 0).all())
    with torch.no_grad():
        fresh = wf.apply(params, second.configs)
    torch.testing.assert_close(second.log_amp, fresh.log)
    assert second.log_amp.is_complex() == (kind == 'complex_made')


def test_fast_ar_samples_born_distribution_of_a_complex_state():
    config, _, wf, _, params = _setup('complex_made', seed=8, chains=512)
    state = metropolis.init_sampler_for(9, wf, params, config, 'cpu')
    tv, _ = _born_tv(wf, params, state, registry.resolve_sweeps_fn(wf, config))
    assert tv < 0.05, f'TV distance {tv} too large'


def test_fast_ar_refuses_other_ansatzes():
    config, _, wf, _, params = _setup('jastrow')
    assert not fast_ar.supports(wf)
    state = metropolis.init_sampler_for(0, wf, params, config, 'cpu')
    with pytest.raises(ValueError, match='requires'):
        fast_ar.run_sweeps(wf, params, state, 1)
