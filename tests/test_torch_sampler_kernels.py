"""The port's samplers against the JAX package: the plain versions of the
fused RBM sweep kernels (K1 streamed, K2 Philox), the wrappers' dispatch,
the fast_rbm adapter and registry, and the generic Metropolis sampler.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
compares them with these plain versions there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.sampler import kernels as jax_kernels
from cgs_vmc_tpu_torch import basis, models
from cgs_vmc_tpu_torch.models.nn import log_cosh
from cgs_vmc_tpu_torch.sampler import fast_rbm, kernels, metropolis, registry
from cgs_vmc_tpu_torch.utils import profiling

N = 8
H = 16
CHAINS = 32


def _rbm_params(seed, scale=0.3, n_sites=N, hidden=H, device='cpu'):
    rng = np.random.default_rng(seed)
    return [torch.tensor(scale * rng.standard_normal(shape),
                         dtype=torch.float32, device=device)
            for shape in ((n_sites, hidden), (hidden,), (n_sites,))]


def _configs(seed, n_sites=N, chains=CHAINS):
    rng = np.random.default_rng(seed)
    template = np.repeat([1.0, -1.0], n_sites // 2).astype(np.float32)
    return torch.tensor(np.stack([rng.permutation(template)
                                  for _ in range(chains)]))


def _streamed(seed, n_steps, n_sites=N, chains=CHAINS):
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, n_sites // 2, size=(n_steps, chains, 2))
    log_u = np.log(rng.random((n_steps, chains))).astype(np.float32)
    return torch.tensor(picks, dtype=torch.int32), torch.tensor(log_u)


def _log_psi(w, b, a, configs):
    return configs @ a + torch.sum(log_cosh(configs @ w + b), dim=-1)


# ---------------------------------------------------------------------------
# K1: plain version against the JAX kernel (interpret mode) and the oracle.

def test_k1_plain_matches_jax_kernel_and_reference():
    """Same picks (kernels.sample_picks) and uniforms
    (log(jax.random.uniform(key)), as the JAX wrapper draws them):
    configs and accept counts exactly equal, logψ within 1e-4."""
    w, b, a = _rbm_params(0)
    configs = _configs(1)
    picks = jax_kernels.sample_picks(jax.random.key(2), 64, N, CHAINS)
    key = jax.random.key(3)
    log_u = jnp.log(jax.random.uniform(key, (64, CHAINS), jnp.float32))
    jw, jb, ja, jc = (x.numpy() for x in (w, b, a, configs))
    jax_out = jax_kernels.rbm_sweeps(jw, jb, ja, jc, picks, key,
                                     block_chains=CHAINS, interpret=True)
    jax_ref = jax_kernels.rbm_sweeps_reference(jw, jb, ja, jc, picks, key)
    ours = kernels.rbm_sweeps(w, b, a, configs,
                              torch.tensor(np.asarray(picks)),
                              torch.tensor(np.asarray(log_u)))
    for ref in (jax_out, jax_ref):
        np.testing.assert_array_equal(ours.configs.numpy(),
                                      np.asarray(ref.configs))
        np.testing.assert_array_equal(ours.num_accepted.numpy(),
                                      np.asarray(ref.num_accepted))
        np.testing.assert_allclose(ours.log_amp.numpy(),
                                   np.asarray(ref.log_amp), rtol=1e-4,
                                   atol=1e-4)
    assert 0 < float(ours.num_accepted.sum()) < 64 * CHAINS


def test_k1_plain_matches_torch_reference():
    w, b, a = _rbm_params(4)
    configs = _configs(5)
    picks, log_u = _streamed(6, 48)
    out = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    ref = kernels.rbm_sweeps_reference(w, b, a, configs, picks, log_u)
    assert torch.equal(out.configs, ref.configs)
    assert torch.equal(out.num_accepted, ref.num_accepted)
    torch.testing.assert_close(out.log_amp, ref.log_amp, rtol=1e-4,
                               atol=1e-4)


def test_k1_plain_margin_is_the_least_distance_to_the_threshold():
    """The witness's `margin` records each chain's least |2Δlogψ − log u|
    over its active proposals (recomputed here from scratch, step by step
    along the reference trajectory) and leaves the result unchanged."""
    w, b, a = _rbm_params(14)
    configs = _configs(15)
    picks, log_u = _streamed(16, 30)
    picks[3, :4] = N // 2                 # inactive proposals are skipped
    theta = configs @ w + b
    margin = torch.full((CHAINS,), torch.inf)
    out = kernels.rbm_sweeps_lanes_plain(w, b, a, configs, theta, picks,
                                         log_u, 16, margin)
    plain = kernels.rbm_sweeps_lanes_plain(w, b, a, configs, theta, picks,
                                           log_u, 16)
    assert all(torch.equal(x, y) for x, y in zip(out, plain))
    expect = torch.full((CHAINS,), torch.inf)
    state = configs
    for t in range(picks.shape[0]):
        down = state < 0
        rank_down = torch.cumsum(down, dim=1) - down.long()
        rank_up = torch.cumsum(~down, dim=1) - (~down).long()
        hit_down = down & (rank_down == picks[t, :, 0:1])
        hit_up = ~down & (rank_up == picks[t, :, 1:2])
        active = hit_down.any(dim=1) & hit_up.any(dim=1)
        proposed = state + 2.0 * (hit_down.float() - hit_up.float())
        d_log = _log_psi(w, b, a, proposed) - _log_psi(w, b, a, state)
        expect = torch.minimum(expect, torch.where(
            active, (2.0 * d_log - log_u[t]).abs(), torch.inf))
        state = kernels.rbm_sweeps_reference(
            w, b, a, state, picks[t:t + 1], log_u[t:t + 1]).configs
    assert torch.equal(state, out.configs)
    torch.testing.assert_close(margin, expect, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The lane-order witness: the kernels' own summation order.

def _scalar_lane_sum(d: np.ndarray, chain: int, lanes: int) -> np.float32:
    """Σ_h d[chain] added one float32 at a time in the kernels' order
    (csrc/rbm_sweep.cu): lane l sums its slots i = 0, 1, … holding units
    G·((i + g) mod ⌈H/G⌉) + l from +0.0, g = chain mod (32/G); then the
    butterfly v[l] += v[l ^ m], m = G/2 … 1; lane 0's value."""
    hidden = d.shape[1]
    n_slots = -(-hidden // lanes)
    group = chain % (32 // lanes)
    parts = []
    for lane in range(lanes):
        part = np.float32(0.0)
        for i in range(n_slots):
            col = lanes * ((i + group) % n_slots) + lane
            if col < hidden:
                part = np.float32(part + d[chain, col])
        parts.append(part)
    m = lanes // 2
    while m:
        parts = [np.float32(parts[l] + parts[l ^ m]) for l in range(lanes)]
        m //= 2
    return parts[0]


@pytest.mark.parametrize('lanes', [16, 32])
@pytest.mark.parametrize('hidden', [1, 33, 64, 160, 512])
def test_lane_order_sum_matches_a_scalar_loop(hidden, lanes):
    """Bit for bit, on chains in both groups of a warp (at 16 lanes a
    chain two chains share a warp and rotate their slots differently)."""
    rng = np.random.default_rng(hidden + lanes)
    chains = 4
    d = (rng.standard_normal((chains, hidden))
         * 10.0 ** rng.uniform(-6, 1, (chains, hidden))).astype(np.float32)
    got = kernels.lane_order_sum(torch.tensor(d), lanes).numpy()
    want = np.array([_scalar_lane_sum(d, c, lanes) for c in range(chains)],
                    dtype=np.float32)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


@pytest.mark.parametrize('kernel', ['K1', 'K2'])
@pytest.mark.parametrize('n_sites,hidden', [(36, 64), (40, 160)])
def test_witness_matches_plain_away_from_the_threshold(kernel, n_sites,
                                                       hidden):
    """On every chain whose witness margin exceeds 1e-4, the witness makes
    the plain version's decisions: configs and accept counts bit for bit
    (the sums differ by rounding, ~1e-6)."""
    chains = 64
    n_steps = 2 * n_sites
    w, b, a = _rbm_params(50 + n_sites, n_sites=n_sites, hidden=hidden)
    configs = _configs(51, n_sites=n_sites, chains=chains)
    theta = configs @ w + b
    lanes = 16
    margin = torch.full((chains,), torch.inf)
    if kernel == 'K1':
        picks, log_u = _streamed(52, n_steps, n_sites, chains)
        ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
        out = kernels.rbm_sweeps_lanes_plain(w, b, a, configs, theta, picks,
                                             log_u, lanes, margin)
    else:
        seed = torch.tensor([2 ** 31 + 53], dtype=torch.int64)
        ref = kernels.rbm_sweeps_prng_plain(w, b, a, configs, n_steps, seed)
        out = kernels.rbm_sweeps_prng_lanes_plain(
            w, b, a, configs, theta, n_steps, seed, lanes, margin)
    far = margin > 1e-4
    assert int(far.sum()) >= chains - 4
    assert torch.equal(out.configs[far], ref.configs[far])
    assert torch.equal(out.num_accepted[far], ref.num_accepted[far])
    assert 0 < float(out.num_accepted.sum()) < n_steps * chains
    assert (out.configs.sum(dim=1) == 0).all()


def test_prng_witness_carries_theta_across_draw_blocks():
    """K2's witness over more steps than one block of Philox draws equals
    K1's witness fed the same draws in one call, bit for bit: θ is carried
    across the blocks, never recomputed."""
    w, b, a = _rbm_params(60)
    configs = _configs(61)
    theta = configs @ w + b
    seed = torch.tensor([77], dtype=torch.int64)
    n_steps = kernels._STEP_BLOCK + 8
    out = kernels.rbm_sweeps_prng_lanes_plain(w, b, a, configs, theta,
                                              n_steps, seed, 16)
    picks, log_u = kernels.philox_draws(seed, 0, n_steps, CHAINS, N // 2,
                                        N // 2)
    ref = kernels.rbm_sweeps_lanes_plain(w, b, a, configs, theta, picks,
                                         log_u, 16)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    with pytest.raises(ValueError, match='lanes'):
        kernels.lane_order_sum(theta, 8)


def test_k1_caches_consistent_and_sz_conserved():
    w, b, a = _rbm_params(7)
    configs = _configs(8)
    picks, log_u = _streamed(9, 100)
    out = kernels.rbm_sweeps(w, b, a, configs, picks, log_u)
    assert set(out.configs.unique().tolist()) <= {-1.0, 1.0}
    assert (out.configs.sum(dim=1) == 0).all()
    torch.testing.assert_close(out.theta, out.configs @ w + b, rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(out.log_amp, _log_psi(w, b, a, out.configs),
                               rtol=1e-4, atol=1e-4)


def test_k1_always_reject():
    """A deeply peaked wavefunction rejects every move away from the
    current config: state unchanged, no accepts."""
    configs = _configs(10)
    same = configs[:1].repeat(CHAINS, 1)
    w, b = torch.zeros(N, H), torch.zeros(H)
    a = 50.0 * configs[0]
    picks, log_u = _streamed(11, 50)
    out = kernels.rbm_sweeps(w, b, a, same, picks, log_u)
    assert torch.equal(out.configs, same)
    assert float(out.num_accepted.sum()) == 0.0


def test_k1_out_of_range_picks_are_noops():
    """The `active` guard: a rank beyond the chain's spin counts is a
    rejected no-op, even with log u = -inf (which accepts everything)."""
    w, b, a = _rbm_params(12)
    configs = _configs(13)
    picks = torch.full((5, CHAINS, 2), N // 2, dtype=torch.int32)
    log_u = torch.full((5, CHAINS), -float('inf'))
    out = kernels.rbm_sweeps(w, b, a, configs, picks, log_u)
    assert torch.equal(out.configs, configs)
    assert float(out.num_accepted.sum()) == 0.0


def test_picks_are_per_chain_independent():
    gen = torch.Generator().manual_seed(20)
    picks = kernels.sample_picks(gen, 40, N, 64)
    assert picks.dtype == torch.int32 and picks.shape == (40, 64, 2)
    assert int(picks[..., 0].max()) == N // 2 - 1 and int(picks.min()) == 0
    assert max(len(picks[t, :, 0].unique()) for t in range(40)) > 1
    w, b, a = _rbm_params(21, scale=0.1)
    same = _configs(22, chains=1).repeat(CHAINS, 1)
    picks = kernels.sample_picks(gen, 4 * N, N, CHAINS)
    log_u = torch.log(torch.rand((4 * N, CHAINS), generator=gen))
    out = kernels.rbm_sweeps(w, b, a, same, picks, log_u)
    assert torch.unique(out.configs, dim=0).shape[0] > 1


# ---------------------------------------------------------------------------
# K2: Philox draws and the plain version.

def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors (Salmon et al., Random123)."""
    def run(counter, key):
        words = kernels.philox4x32_10(
            [torch.tensor(c, dtype=torch.int64) for c in counter],
            [torch.tensor(k, dtype=torch.int64) for k in key])
        return [int(x) for x in words]
    assert run([0, 0, 0, 0], [0, 0]) == [
        0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert run([0xffffffff] * 4, [0xffffffff] * 2) == [
        0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd]
    assert run([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344],
               [0xa4093822, 0x299f31d0]) == [
        0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]


def test_philox_draws_ranges_and_uniformity():
    seed = torch.tensor([7], dtype=torch.int64)
    picks, log_u = kernels.philox_draws(seed, 0, 2000, 16, 4, 5)
    assert picks.dtype == torch.int32 and picks.shape == (2000, 16, 2)
    for col, n in ((0, 4), (1, 5)):
        counts = torch.bincount(picks[..., col].reshape(-1).long(),
                                minlength=n).double()
        assert counts.shape[0] == n
        expected = picks.shape[0] * picks.shape[1] / n
        assert float(((counts - expected) ** 2 / expected).sum()) < 30.0
    u = torch.exp(log_u)
    assert float(u.max()) < 1.0 and abs(float(u.mean()) - 0.5) < 0.01
    later, _ = kernels.philox_draws(seed, 1000, 1000, 16, 4, 5)
    assert torch.equal(later, picks[1000:])
    other, _ = kernels.philox_draws(seed + 1, 0, 2000, 16, 4, 5)
    assert not torch.equal(other, picks)


def test_k2_plain_is_k1_plain_fed_its_philox_draws():
    w, b, a = _rbm_params(30)
    configs = _configs(31)
    seed = torch.tensor([12345], dtype=torch.int64)
    n_steps = 2 * kernels._STEP_BLOCK + 40   # crosses the draw blocks
    out = kernels.rbm_sweeps_prng(w, b, a, configs, n_steps, 12345)
    picks, log_u = kernels.philox_draws(seed, 0, n_steps, CHAINS, N // 2,
                                        N // 2)
    ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    assert torch.equal(out.configs, ref.configs)
    assert torch.equal(out.num_accepted, ref.num_accepted)
    torch.testing.assert_close(out.log_amp, ref.log_amp)
    assert (out.configs.sum(dim=1) == 0).all()
    again = kernels.rbm_sweeps_prng(w, b, a, configs, n_steps, seed)
    assert torch.equal(again.configs, out.configs)
    zero = kernels.rbm_sweeps_prng(w, b, a, configs, 0, seed)
    assert torch.equal(zero.configs, configs)


@pytest.mark.parametrize('kernel', ['K1', 'K2'])
def test_sweeps_sample_born_distribution(kernel):
    """The chains of either kernel's plain version sample |ψ|² of the RBM:
    TV distance < 0.08 against the exact distribution over
    enumerate_sz_basis."""
    w, b, a = _rbm_params(15, scale=0.15)
    states = torch.tensor(basis.enumerate_sz_basis(N))
    log_psi = _log_psi(w, b, a, states).double()
    exact = torch.exp(2 * (log_psi - log_psi.max()))
    exact = (exact / exact.sum()).numpy()
    top, bot = basis.make_lin_tables(N)
    lin_of_enum = basis.lin_index(states, top, bot).numpy()
    enum_of_lin = np.empty_like(lin_of_enum)
    enum_of_lin[lin_of_enum] = np.arange(len(lin_of_enum))

    chains = 256
    configs = _configs(16, chains=chains)
    gen = torch.Generator().manual_seed(17)
    counts = np.zeros(states.shape[0])
    for it in range(50):
        if kernel == 'K1':
            picks = kernels.sample_picks(gen, 2 * N, N, chains)
            log_u = torch.log(torch.rand((2 * N, chains), generator=gen))
            configs = kernels.rbm_sweeps(w, b, a, configs, picks,
                                         log_u).configs
        else:
            configs = kernels.rbm_sweeps_prng(w, b, a, configs, 2 * N,
                                              1000 + it).configs
        if it >= 10:
            idx = basis.lin_index(configs, top, bot).numpy()
            np.add.at(counts, enum_of_lin[idx], 1)
    tv = 0.5 * np.abs(counts / counts.sum() - exact).sum()
    assert tv < 0.08, f'TV distance {tv} too large'


def test_cross_chain_batch_mean_variance():
    """Independent chains: the variance of the cross-chain batch mean of
    an observable matches var(single chain) / n_chains within MC slack
    (a shared proposal schedule would inflate it by O(chains))."""
    w, b, a = _rbm_params(30, scale=0.15)
    chains = 512
    gen = torch.Generator().manual_seed(31)

    def sweep(configs, n_steps):
        picks = kernels.sample_picks(gen, n_steps, N, chains)
        log_u = torch.log(torch.rand((n_steps, chains), generator=gen))
        return kernels.rbm_sweeps(w, b, a, configs, picks, log_u).configs

    configs = sweep(_configs(32, chains=chains), 20 * N)
    batch_means, values = [], []
    for _ in range(30):
        configs = sweep(configs, 2 * N)
        obs = (configs[:, 0] * configs[:, 1]).numpy()
        batch_means.append(obs.mean())
        values.append(obs)
    var_single = np.concatenate(values).var()
    var_mean = np.var(batch_means, ddof=1)
    assert var_mean < 6.0 * var_single / chains


# ---------------------------------------------------------------------------
# Wrappers: dispatch and validation.

def test_wrappers_run_plain_on_cpu_without_counting():
    profiling.reset_counters('k1.launches', 'k2.launches')
    w, b, a = _rbm_params(40)
    configs = _configs(41)
    picks, log_u = _streamed(42, 16)
    out = kernels.rbm_sweeps(w, b, a, configs, picks, log_u)
    ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    assert torch.equal(out.configs, ref.configs)
    kernels.rbm_sweeps_prng(w, b, a, configs, 16, 3)
    assert profiling.counter('k1.launches') == 0
    assert profiling.counter('k2.launches') == 0


def test_wrappers_validate_inputs():
    w, b, a = _rbm_params(43)
    configs = _configs(44)
    picks, log_u = _streamed(45, 4)
    with pytest.raises(TypeError):
        kernels.rbm_sweeps(w.double(), b, a, configs, picks, log_u)
    with pytest.raises(ValueError):
        kernels.rbm_sweeps(w, b, a[:-1], configs, picks, log_u)
    with pytest.raises(ValueError):
        kernels.rbm_sweeps(w, b, a, configs, picks.long(), log_u)
    with pytest.raises(ValueError):
        kernels.rbm_sweeps(w, b, a, configs, picks, log_u[:-1])
    with pytest.raises(ValueError, match='half-filled'):
        kernels.rbm_sweeps_prng(w[:-1], b, a[:-1], configs[:, :-1], 4, 0)
    with pytest.raises(ValueError, match='seed'):
        kernels.rbm_sweeps_prng(w, b, a, configs, 4,
                                torch.tensor([1.0]))


# ---------------------------------------------------------------------------
# fast_rbm + registry.

def _pure_rbm(num_layers=0):
    config = Config(num_sites=N, wavefunction_type='rbm',
                    num_fc_layers=num_layers, fc_layer_size=H)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator().manual_seed(0))
    params['onsite']['b'] += 0.7          # exercise the bias fold-in
    return config, wf, params


@pytest.mark.parametrize('use_kernel_prng', [True, False])
def test_fast_rbm_cache_matches_model_apply(use_kernel_prng):
    config, wf, params = _pure_rbm()
    state = metropolis.init_sampler_for(1, wf, params, config, 'cpu', 32)
    state = fast_rbm.run_sweeps(wf, params, state, 5, use_kernel_prng)
    amp = wf.apply(params, state.configs)
    torch.testing.assert_close(state.log_amp, amp.log, rtol=1e-4,
                               atol=1e-4)
    assert (state.configs.sum(dim=1) == 0).all()
    assert float(state.num_proposed[0]) == 5 * N
    rate = float(metropolis.acceptance_rate(state))
    assert 0.0 < rate <= 1.0


def test_fast_rbm_sector_guards():
    config, wf, params = _pure_rbm()
    state = metropolis.init_sampler_for(7, wf, params, config, 'cpu', 4)
    bad = state._replace(configs=torch.ones_like(state.configs))
    with pytest.raises(ValueError, match='Sz=0'):
        fast_rbm.check_sector(bad.configs)
    with pytest.raises(ValueError, match='Sz=0'):
        registry.check_state(wf, config, bad)
    registry.check_state(wf, config, state)
    with pytest.raises(ValueError, match='odd'):
        fast_rbm.run_sweeps(wf, params, state._replace(
            configs=state.configs[:, :-1]), 1)


def test_registry_dispatch():
    config, wf, _ = _pure_rbm()
    assert registry.resolved_name(wf, config) == 'rbm_kernel'
    _, deep_wf, _ = _pure_rbm(num_layers=1)
    assert registry.resolved_name(deep_wf, config) == 'generic'
    assert registry.resolved_name(
        wf, config.replace(use_fast_sampler=False)) == 'generic'
    assert registry.resolved_name(wf, config.replace(total_sz2=2)) \
        == 'generic'
    # Multiple-try Metropolis and tempering outrank the RBM kernels.
    assert registry.resolved_name(
        wf, config.replace(mtm_candidates=4)) == 'mtm'
    assert registry.resolved_name(
        wf, config.replace(pt_replicas=2)) == 'tempering'


# ---------------------------------------------------------------------------
# The generic Metropolis sampler: the statistical oracle.

def test_generic_sampler_born_distribution_and_invariants():
    """Chains of the generic sampler (an RBM with a feature layer) sample
    |ψ|²: TV < 0.05; Sz conserved; amplitude cache consistent."""
    config, wf, params = _pure_rbm(num_layers=1)
    state = metropolis.init_sampler_for(2, wf, params, config, 'cpu', 256)
    state = metropolis.run_sweeps(wf, params, state, 10)
    states = torch.tensor(basis.enumerate_sz_basis(N))
    log_psi = wf.apply(params, states).log.double()
    exact = torch.exp(2 * (log_psi - log_psi.max()))
    exact = (exact / exact.sum()).numpy()
    top, bot = basis.make_lin_tables(N)
    lin_of_enum = basis.lin_index(states, top, bot).numpy()
    enum_of_lin = np.empty_like(lin_of_enum)
    enum_of_lin[lin_of_enum] = np.arange(len(lin_of_enum))
    counts = np.zeros(states.shape[0])
    for _ in range(40):
        state = metropolis.run_sweeps(wf, params, state, 1)
        idx = basis.lin_index(state.configs, top, bot).numpy()
        np.add.at(counts, enum_of_lin[idx], 1)
    tv = 0.5 * np.abs(counts / counts.sum() - exact).sum()
    assert tv < 0.05, f'TV distance {tv} too large'
    assert (state.configs.sum(dim=1) == 0).all()
    torch.testing.assert_close(state.log_amp,
                               wf.apply(params, state.configs).log)
    assert float(state.num_proposed.sum()) == 256 * 50 * N
    assert len(state.num_accepted.unique()) > 3     # not lock-stepped


def test_generic_detailed_balance_two_site_toy():
    """2 sites, Sz=0: two states and a deterministic swap proposal, so the
    empirical occupation must match |ψ|² = (p, 1-p)."""
    wf = models.RestrictedBoltzmannNetwork(2, 0, 1)
    params = {'hidden': {'w': torch.zeros(2, 1), 'b': torch.zeros(1)},
              'onsite': {'w': torch.tensor([[0.35], [-0.35]]),
                         'b': torch.zeros(1)}}
    config = Config(num_sites=2, batch_size=512)
    state = metropolis.init_sampler_for(1, wf, params, config, 'cpu')
    state = metropolis.run_sweeps(wf, params, state, 20)
    counts = np.zeros(2)
    for _ in range(60):
        state = metropolis.run_sweeps(wf, params, state, 1)
        first = state.configs[:, 0]
        counts += [float((first > 0).sum()), float((first < 0).sum())]
    p_plus = np.exp(2 * 0.7) / (np.exp(2 * 0.7) + np.exp(-2 * 0.7))
    tv = 0.5 * np.abs(counts / counts.sum() - [p_plus, 1 - p_plus]).sum()
    assert tv < 0.03, f'TV {tv}: empirical {counts / counts.sum()}'


def test_generic_flip_move_and_refresh():
    config, wf, params = _pure_rbm(num_layers=1)
    flip_config = config.replace(mc_move_type='flip')
    state = metropolis.init_sampler_for(3, wf, params, flip_config, 'cpu',
                                        64)
    state = metropolis.run_sweeps(wf, params, state, 3, move='flip')
    assert len(state.configs.sum(dim=1).unique()) > 1   # leaves the sector
    stale = state._replace(log_amp=state.log_amp + 123.0)
    fixed = metropolis.refresh_amplitudes(wf, params, stale)
    torch.testing.assert_close(fixed.log_amp, state.log_amp)
    reset = metropolis.reset_stats(state)
    assert float(reset.num_proposed.sum()) == 0.0
    ladder = metropolis.init_sampler_for(0, wf, params,
                                         config.replace(pt_replicas=2), 'cpu')
    assert ladder.aux_configs.shape == (config.batch_size, 1,
                                        config.num_sites)
