"""The incremental samplers of the port (Jastrow delta, Sherman–Morrison
projected BDG, environment-cached MPS) and their registry entries, on the
CPU.

The registry is held to the JAX package's names, priorities and predicates.
Each sampler is held to (a) exact arithmetic oracles built on the full
forward pass, (b) the Born distribution |ψ|² over the enumerated N=8 sector
(total variation < 0.05 from 512 chains × 32 snapshots, against the JAX
tests' 0.08 from 256 chains × 48), (c) its cache: after every call log_amp and
sign equal a fresh `wf.apply`.  Params are JAX-initialized and carried over
with `interop`.
"""

import numpy as np
import jax
import pytest
import torch

from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.sampler import registry as jax_registry
from cgs_vmc_tpu_torch import basis, models
from cgs_vmc_tpu_torch.sampler import (
    fast_jastrow, fast_mps, fast_pbdg, metropolis, registry)
from cgs_vmc_tpu_torch.utils import interop

@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """These tensors are tiny: with several test workers on one machine,
    torch's intra-op thread pools only fight each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 8
SAMPLERS = {
    'jastrow': (dict(wavefunction_type='jastrow'), fast_jastrow,
                'jastrow_delta'),
    'pbdg': (dict(wavefunction_type='pbdg'), fast_pbdg,
             'pbdg_sherman_morrison'),
    'mps': (dict(wavefunction_type='mps', bond_dimension=4,
                 mps_incremental_sweeps=True), fast_mps, 'mps_env'),
}


def _setup(kind, seed=0, chains=32, noise=0.0):
    """(config, wf, params, sampler state): params from the JAX init with
    `seed` (plus numpy noise, to move a Jastrow away from its nearly flat
    start), chains from the port's generator seeded seed + 1."""
    overrides, _, _ = SAMPLERS[kind]
    config = Config(num_sites=N, batch_size=chains, **overrides)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_build(config).init(jax.random.key(seed))))
    wf = models.build_wavefunction(config)
    params = interop.params_from_numpy(params, 'cpu')
    state = metropolis.init_sampler_for(seed + 1, wf, params, config, 'cpu')
    return config, wf, params, state


# ---------------------------------------------------------------------------
# Registry.

_REGISTRY_CASES = [
    # (ansatz, overrides), as tests/test_registry.py and the per-sampler
    # dispatch tests of the JAX package cover them.
    ('pbdg', {}),
    ('pbdg', dict(use_fast_sampler=False)),
    ('pbdg', dict(total_sz2=2)),
    ('pbdg', dict(mc_move_type='flip')),
    ('mps', dict(bond_dimension=4)),
    ('mps', dict(bond_dimension=4, mps_incremental_sweeps=True)),
    ('mps', dict(bond_dimension=4, mps_incremental_sweeps=True,
                 use_fast_sampler=False)),
    ('mps', dict(bond_dimension=4, mps_incremental_sweeps=True,
                 mc_move_type='flip')),
    ('jastrow', {}),
    ('jastrow', dict(use_fast_sampler=False)),
    ('jastrow', dict(output_activation='tanh')),
    ('jastrow', dict(total_sz2=2)),
    ('jastrow', dict(mc_move_type='flip')),
    ('fully_connected_nnb', dict(num_fc_layers=1, fc_layer_size=12)),
    ('fully_connected', dict(num_fc_layers=1, fc_layer_size=12)),
    ('prod', dict(composite_wavefunction_types=('jastrow', 'jastrow'))),
    ('complex', dict(composite_wavefunction_types=('jastrow',
                                                   'fully_connected'))),
]


@pytest.mark.parametrize('wf_type,overrides', _REGISTRY_CASES)
def test_registry_resolves_as_jax(wf_type, overrides):
    config = Config(num_sites=N, wavefunction_type=wf_type, **overrides)
    assert (registry.resolved_name(models.build_wavefunction(config), config)
            == jax_registry.resolved_name(jax_build(config), config))


def test_registry_priorities_equal_jax():
    """The ported entries carry the JAX priorities, in the same order; the
    RBM kernels keep priority 50 under the port's own name and without the
    backend gate (a pure RBM resolves to them on the CPU too)."""
    theirs = {e.name: e.priority for e in jax_registry.registered_fast_paths()}
    ours = {e.name: e.priority for e in registry.registered_fast_paths()}
    assert ours.pop('rbm_kernel') == theirs['rbm_pallas'] == 50
    assert ours == {name: theirs[name] for name in
                    ('mps_env', 'jastrow_delta', 'pbdg_sherman_morrison')}
    assert ours == {'mps_env': 90, 'jastrow_delta': 45,
                    'pbdg_sherman_morrison': 40}
    names = [e.name for e in registry.registered_fast_paths()]
    assert names == ['mps_env', 'rbm_kernel', 'jastrow_delta',
                     'pbdg_sherman_morrison']
    rbm = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=0)
    assert registry.resolved_name(models.build_wavefunction(rbm),
                                  rbm) == 'rbm_kernel'


@pytest.mark.parametrize('knob', ['mtm_candidates', 'pt_replicas'])
def test_unported_sampler_knobs_still_raise(knob):
    config = Config(num_sites=N, wavefunction_type='jastrow', **{knob: 4})
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        registry.resolve_sweeps_fn(models.build_wavefunction(config), config)


@pytest.mark.parametrize('kind', sorted(SAMPLERS))
def test_wrong_ansatz_is_refused(kind):
    _, module, _ = SAMPLERS[kind]
    other = 'mps' if kind != 'mps' else 'jastrow'
    _, wf, params, state = _setup(other)
    assert not module.supports(wf)
    with pytest.raises(ValueError, match='requires'):
        module.run_sweeps(wf, params, state, 1)


# ---------------------------------------------------------------------------
# Invariants shared by the three samplers.

@pytest.mark.parametrize('kind', sorted(SAMPLERS))
def test_invariants_and_cache_refresh(kind):
    """Sz conserved, counters consistent, zero sweeps a no-op, and after
    every call the cached (sign, log) equal a fresh forward."""
    config, wf, params, state = _setup(kind, seed=3, noise=0.3)
    sweeps = registry.resolve_sweeps_fn(wf, config)
    assert registry.resolved_name(wf, config) == SAMPLERS[kind][2]
    assert sweeps(params, state, 0) is state
    for call in range(3):
        before = state.num_proposed.clone()
        state = sweeps(params, state, 2)
        amp = wf.apply(params, state.configs)
        torch.testing.assert_close(state.log_amp, amp.log, rtol=0, atol=0)
        torch.testing.assert_close(state.sign, amp.sign, rtol=0, atol=0)
        assert bool((state.configs.sum(dim=1) == 0).all())
        assert bool((state.configs.abs() == 1).all())
        assert bool((state.num_accepted <= state.num_proposed).all())
        if kind == 'mps':
            assert bool((state.num_proposed - before <= 2 * (N - 1)).all())
        else:
            assert bool((state.num_proposed - before == 2 * N).all())
    rate = float(metropolis.acceptance_rate(state))
    assert 0.02 < rate < 0.999


@pytest.mark.parametrize('kind', sorted(SAMPLERS))
def test_samples_born_distribution(kind):
    # The JAX tests' own targets: the seed-7 init; the Jastrow, whose init
    # is nearly flat, moved away from uniform.
    config, wf, params, _ = _setup(kind, seed=7,
                                   noise=0.3 if kind == 'jastrow' else 0.0)
    _, module, _ = SAMPLERS[kind]
    states = basis.enumerate_sz_basis(N)
    log = wf.apply(params, torch.tensor(states)).log.double().numpy()
    exact = np.exp(2 * (log - log.max()))
    exact /= exact.sum()
    weights = 2 ** np.arange(N)
    index = {int(code): row for row, code in
             enumerate(((states > 0) * weights).sum(axis=1))}

    state = metropolis.init_sampler_for(11, wf, params, config, 'cpu', 512)
    counts = np.zeros(len(states))
    for it in range(40):
        state = module.run_sweeps(wf, params, state, 3 if kind == 'mps'
                                  else 2)
        if it >= 8:
            codes = ((state.configs.numpy() > 0) * weights).sum(axis=1)
            np.add.at(counts, [index[int(c)] for c in codes], 1)
    empirical = counts / counts.sum()
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.05, f'TV distance {tv} too large'


# ---------------------------------------------------------------------------
# Jastrow: the delta and the generic sampler's chains.

def test_jastrow_delta_matches_full_forward():
    _, wf, params, state = _setup('jastrow', seed=1, chains=64, noise=0.5)
    configs = state.configs
    sym = wf.symmetric_pair(params)
    base = wf.apply(params, configs).log
    generator = torch.Generator().manual_seed(5)
    rows = torch.arange(64)
    for _ in range(5):
        down, up, _ = metropolis.propose_exchange_sites(generator, configs)
        assert bool((configs[rows, down] == -1).all())
        assert bool((configs[rows, up] == 1).all())
        moved = configs.clone()
        moved[rows, down], moved[rows, up] = 1.0, -1.0
        delta = fast_jastrow.exchange_delta(sym, params['onsite']['b'],
                                            configs, down, up)
        torch.testing.assert_close(delta, wf.apply(params, moved).log - base,
                                   rtol=1e-4, atol=1e-5)


def test_jastrow_walks_the_generic_samplers_chains():
    """One seed: the delta path and the generic path draw the same
    proposals and uniforms, so the chains coincide (a float32 tie in an
    acceptance test is the only way apart; none occurs here)."""
    _, wf, params, state = _setup('jastrow', seed=2, chains=64, noise=0.5)
    twin = state._replace(
        generator=torch.Generator().manual_seed(0))
    twin.generator.set_state(state.generator.get_state())
    fast = fast_jastrow.run_sweeps(wf, params, state, 3)
    generic = metropolis.run_sweeps(wf, params, twin, 3)
    np.testing.assert_array_equal(fast.configs.numpy(),
                                  generic.configs.numpy())
    np.testing.assert_array_equal(fast.num_accepted.numpy(),
                                  generic.num_accepted.numpy())
    torch.testing.assert_close(fast.log_amp, generic.log_amp, rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(state.generator.get_state(),
                       twin.generator.get_state())


# ---------------------------------------------------------------------------
# Projected BDG: the two rank-1 steps against determinants from scratch.

def test_sherman_morrison_ratio_matches_full_recompute():
    _, wf, params, state = _setup('pbdg', seed=0, chains=32)
    pairing, configs = params['pairing'], state.configs
    up, down, inv = fast_pbdg._build_cache(pairing, configs)
    half, chain = N // 2, torch.arange(32)
    # The cache holds the inverse of the sorted submatrix.
    sub = models.determinant.pairing_submatrix(pairing[None], configs)
    torch.testing.assert_close(inv @ sub, torch.eye(half).expand(32, -1, -1),
                               rtol=1e-3, atol=1e-3)
    base = wf.apply(params, configs).log
    rng = np.random.default_rng(3)
    slots = torch.arange(half)[None]
    for _ in range(10):
        r = torch.tensor(rng.integers(0, half, 32))
        c = torch.tensor(rng.integers(0, half, 32))
        i, j = up[chain, r], down[chain, c]
        flipped = configs.clone()
        flipped[chain, i], flipped[chain, j] = -1.0, 1.0
        expected = wf.apply(params, flipped).log - base
        new_row = torch.gather(pairing[j], 1, down)
        inv_col_r = inv[chain, :, r]
        ratio1 = (new_row * inv_col_r).sum(-1)
        w = torch.einsum('bk,bkm->bm', new_row, inv) - (slots == r[:, None]
                                                        ).float()
        inv1 = inv - inv_col_r[:, :, None] * (w / ratio1[:, None])[:, None, :]
        v = torch.gather(pairing[:, i].T, 1, up)
        v = torch.where(slots == r[:, None], pairing[j, i][:, None], v)
        ratio2 = torch.einsum('brc,bc->br', inv1, v)[chain, c]
        torch.testing.assert_close(torch.log(torch.abs(ratio1 * ratio2)),
                                   expected, rtol=2e-3, atol=2e-3)


def test_fast_pbdg_matches_a_full_forward_oracle():
    """The same slot picks and uniforms through determinants from scratch
    (float64) give the same chains: the draws are [sweeps, steps, chains]
    arrays taken up front from the state's generator, r, then c, then u."""
    _, wf, params, state = _setup('pbdg', seed=4, chains=16)
    n_sweeps, half = 2, N // 2
    generator = torch.Generator().manual_seed(0)
    generator.set_state(state.generator.get_state())
    shape = (n_sweeps, N, 16)
    r_all = torch.randint(0, half, shape, generator=generator)
    c_all = torch.randint(0, half, shape, generator=generator)
    u_all = torch.rand(shape, generator=generator)
    pairing = params['pairing'].double().numpy()

    def det(config, up, down):
        return np.linalg.det(pairing[np.ix_(up, down)])

    expected = state.configs.numpy().copy()
    accepted = np.zeros(16)
    for sweep in range(n_sweeps):
        for b in range(16):
            # Slots start each sweep in ascending site order.
            up = [s for s in range(N) if expected[b, s] > 0]
            down = [s for s in range(N) if expected[b, s] < 0]
            for step in range(N):
                r, c = int(r_all[sweep, step, b]), int(c_all[sweep, step, b])
                new_up, new_down = list(up), list(down)
                new_up[r], new_down[c] = down[c], up[r]
                ratio = (det(expected[b], new_up, new_down)
                         / det(expected[b], up, down))
                if ratio * ratio > float(u_all[sweep, step, b]):
                    expected[b, up[r]], expected[b, down[c]] = -1.0, 1.0
                    up, down = new_up, new_down
                    accepted[b] += 1
    out = fast_pbdg.run_sweeps(wf, params, state, n_sweeps)
    np.testing.assert_array_equal(out.configs.numpy(), expected)
    np.testing.assert_array_equal(out.num_accepted.numpy(), accepted)
    assert torch.equal(state.generator.get_state(), generator.get_state())


# ---------------------------------------------------------------------------
# MPS: the cached environments against full forwards.

def test_fast_mps_matches_a_full_forward_oracle():
    """The same ordered adjacent-exchange schedule, acceptance rule and
    uniforms with every amplitude from the full forward give the same
    chains, and only antiparallel bonds count as proposals."""
    _, wf, params, state = _setup('mps', seed=2, chains=32)
    n_sweeps = 3
    generator = torch.Generator().manual_seed(0)
    generator.set_state(state.generator.get_state())
    u_all = torch.rand((n_sweeps, N - 1, 32), generator=generator).double()

    def amp2(configs):
        return torch.exp(2 * wf.apply(params, configs).log.double())

    expected = state.configs.clone()
    proposed = torch.zeros(32)
    accepted = torch.zeros(32)
    for sweep in range(n_sweeps):
        for k in range(N - 1):
            swapped = expected.clone()
            swapped[:, [k, k + 1]] = expected[:, [k + 1, k]]
            active = expected[:, k] != expected[:, k + 1]
            accept = active & (amp2(swapped) > u_all[sweep, k]
                               * amp2(expected))
            expected[accept] = swapped[accept]
            proposed += active.float()
            accepted += accept.float()
    out = fast_mps.run_sweeps(wf, params, state, n_sweeps)
    np.testing.assert_array_equal(out.configs.numpy(), expected.numpy())
    np.testing.assert_array_equal(out.num_proposed.numpy(), proposed.numpy())
    np.testing.assert_array_equal(out.num_accepted.numpy(), accepted.numpy())
    assert float(proposed.sum()) < n_sweeps * (N - 1) * 32
    assert torch.equal(state.generator.get_state(), generator.get_state())


@pytest.mark.parametrize('n_sites', [3, 4, 5])
def test_fast_mps_short_chains(n_sites):
    """The first and the last bond meet at N=3; the suffix list is one
    environment long."""
    config = Config(num_sites=n_sites, wavefunction_type='mps',
                    bond_dimension=2, batch_size=16,
                    mps_incremental_sweeps=True, total_sz2=n_sites % 2)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator().manual_seed(1))
    state = metropolis.init_sampler_for(2, wf, params, config, 'cpu')
    sz = state.configs.sum(dim=1)
    out = fast_mps.run_sweeps(wf, params, state, 4)
    torch.testing.assert_close(out.configs.sum(dim=1), sz)
    torch.testing.assert_close(out.log_amp,
                               wf.apply(params, out.configs).log)
    assert float(out.num_accepted.sum()) > 0


# ---------------------------------------------------------------------------
# Through the optimizer: one SR epoch on each fast path.

@pytest.mark.parametrize('kind', sorted(SAMPLERS))
def test_sr_epoch_runs_on_the_fast_path(kind):
    from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    overrides, _, name = SAMPLERS[kind]
    config = Config(num_sites=N, batch_size=32, num_batches_per_epoch=2,
                    num_equilibration_sweeps=2, num_monte_carlo_sweeps=1,
                    heisenberg_jx=-1.0, wavefunction_optimizer_type='SR',
                    sr_diag_shift=1e-2, optimizer='gradient',
                    learning_rates=[0.05], learning_rate_stops=[],
                    **overrides)
    wf = models.build_wavefunction(config)
    assert registry.resolved_name(wf, config) == name
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, build_hamiltonian(config), config)
    state = opt.init_state(3, 'cpu')
    for _ in range(2):
        state, metrics = opt.epoch(state)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert 0.0 < float(metrics['acceptance_rate']) < 1.0
