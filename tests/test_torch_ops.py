"""The port's deterministic building blocks against the JAX package:
signed-log arithmetic, the Sz basis, the RBM's logψ, the Heisenberg local
value, and the optimizer update rules (same inputs, made with numpy from a
seed, through both packages)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu import basis as jax_basis
from cgs_vmc_tpu import lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops import heisenberg as jax_heisenberg
from cgs_vmc_tpu.ops import logamp as jax_logamp
from cgs_vmc_tpu.optim import common as jax_common
from cgs_vmc_tpu.utils import ed
from cgs_vmc_tpu_torch import basis, models
from cgs_vmc_tpu_torch.ops import heisenberg, logamp
from cgs_vmc_tpu_torch.optim import common
from cgs_vmc_tpu_torch.utils import interop

N = 8
H = 16
CHAINS = 32


def _rbm_pair(num_layers=0, seed=0, noise=0.3):
    """The same RBM in both packages: JAX-initialized params, perturbed
    with numpy noise (so biases are nonzero), carried over with interop."""
    config = Config(num_sites=N, wavefunction_type='rbm',
                    num_fc_layers=num_layers, fc_layer_size=H)
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    return (jax_wf, params, models.build_wavefunction(config),
            interop.params_from_numpy(params, 'cpu'))


def _configs(seed, n_sites=N, chains=CHAINS):
    rng = np.random.default_rng(seed)
    template = np.repeat([1.0, -1.0], n_sites // 2).astype(np.float32)
    return np.stack([rng.permutation(template) for _ in range(chains)])


# ---------------------------------------------------------------------------
# ops/logamp.py (rtol 1e-6: float32 elementwise ops, same formulas).

def _logamp_inputs(seed):
    rng = np.random.default_rng(seed)
    log_a = rng.normal(size=64).astype(np.float32)
    log_b = rng.normal(size=64).astype(np.float32)
    sign_a = rng.choice([-1.0, 1.0], size=64).astype(np.float32)
    sign_b = rng.choice([-1.0, 1.0], size=64).astype(np.float32)
    # Cancellations: equal magnitudes, opposite signs (exact zeros), and
    # nearly equal magnitudes (catastrophic cancellation in raw values).
    log_b[:8] = log_a[:8]
    sign_b[:8] = -sign_a[:8]
    log_b[8:16] = log_a[8:16] + 1e-3
    sign_b[8:16] = -sign_a[8:16]
    return sign_a, log_a, sign_b, log_b


@pytest.mark.parametrize('op', ['add', 'sub', 'mul', 'ratio',
                                'log_abs_ratio'])
def test_logamp_binary_ops_match_jax(op):
    sign_a, log_a, sign_b, log_b = _logamp_inputs(0)
    ours = getattr(logamp, op)(
        logamp.LogAmp(torch.tensor(sign_a), torch.tensor(log_a)),
        logamp.LogAmp(torch.tensor(sign_b), torch.tensor(log_b)))
    ref = getattr(jax_logamp, op)(jax_logamp.LogAmp(sign_a, log_a),
                                  jax_logamp.LogAmp(sign_b, log_b))
    for x, y in zip(ours if isinstance(ours, tuple) else [ours],
                    ref if isinstance(ref, tuple) else [ref]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)


def test_logamp_sum_terms_scale_and_values_match_jax():
    rng = np.random.default_rng(1)
    logs = rng.normal(size=(16, 5)).astype(np.float32)
    signs = rng.choice([-1.0, 1.0], size=(16, 5)).astype(np.float32)
    logs[0, :2] = [0.7, 0.7]
    signs[0, :2] = [1.0, -1.0]
    signs[1] = 0.0                     # all-zero terms: log -inf, no nan
    logs[1] = -np.inf
    for axis in (0, -1):
        ours = logamp.sum_terms(torch.tensor(signs), torch.tensor(logs),
                                axis=axis)
        ref = jax_logamp.sum_terms(signs, logs, axis=axis)
        for x, y in zip(ours, ref):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    amp = logamp.LogAmp(torch.tensor(signs[2]), torch.tensor(logs[2]))
    jamp = jax_logamp.LogAmp(signs[2], logs[2])
    for factor in (-2.5, 0.5):
        for x, y in zip(logamp.scale(amp, factor),
                        jax_logamp.scale(jamp, factor)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6)
    values = rng.normal(size=10).astype(np.float32)
    back = logamp.to_value(logamp.from_value(torch.tensor(values)))
    np.testing.assert_allclose(back.numpy(), values, rtol=1e-6)


@pytest.mark.parametrize('activation', sorted(jax_logamp.ACTIVATIONS))
def test_apply_activation_matches_jax(activation):
    pre = np.random.default_rng(2).normal(size=32).astype(np.float32)
    ours = logamp.apply_activation(torch.tensor(pre), activation)
    ref = jax_logamp.apply_activation(jnp.asarray(pre), activation)
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# basis.py: enumeration and Lin tables exactly, random configs by invariants.

@pytest.mark.parametrize('n_sites,n_down', [(8, 4), (7, 3), (10, 6)])
def test_enumeration_and_lin_tables_match_jax(n_sites, n_down):
    states = basis.enumerate_sz_basis(n_sites, n_down)
    np.testing.assert_array_equal(
        states, jax_basis.enumerate_sz_basis(n_sites, n_down))
    n_up = n_sites - n_down
    top, bot = basis.make_lin_tables(n_sites, n_up)
    jtop, jbot = jax_basis.make_lin_tables(n_sites, n_up)
    np.testing.assert_array_equal(top, jtop)
    np.testing.assert_array_equal(bot, jbot)
    idx = basis.lin_index(torch.tensor(states), top, bot).numpy()
    np.testing.assert_array_equal(
        idx, np.asarray(jax_basis.lin_index(states, jtop, jbot)))
    assert sorted(idx.tolist()) == list(range(states.shape[0]))


def test_random_configurations_invariants():
    gen = torch.Generator().manual_seed(0)
    configs = basis.random_configurations(gen, 10, 256)
    assert configs.dtype == torch.float32 and configs.shape == (256, 10)
    assert set(configs.unique().tolist()) == {-1.0, 1.0}
    assert (configs.sum(dim=1) == 0).all()
    # Every site is down in about half the chains (uniform permutations).
    down_share = (configs < 0).float().mean(dim=0)
    assert (down_share - 0.5).abs().max() < 0.12
    assert torch.unique(configs, dim=0).shape[0] > 150
    other = basis.random_configurations(gen, 9, 64, n_down=2)
    assert ((other < 0).sum(dim=1) == 2).all()
    assert basis.n_down_for(8, 2) == jax_basis.n_down_for(8, 2) == 3
    with pytest.raises(ValueError):
        basis.n_down_for(8, 1)
    full = basis.random_spin_configurations(gen, 6, 128)
    assert set(full.unique().tolist()) == {-1.0, 1.0}


# ---------------------------------------------------------------------------
# models: logψ against wf.apply (1e-5).

@pytest.mark.parametrize('num_layers', [0, 1])
def test_rbm_logpsi_matches_jax(num_layers):
    jax_wf, params, wf, tparams = _rbm_pair(num_layers, seed=3)
    configs = _configs(4)
    ours = wf.apply(tparams, torch.tensor(configs))
    ref = jax_wf.apply(params, configs)
    np.testing.assert_allclose(ours.log.numpy(), np.asarray(ref.log),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours.sign.numpy(), np.asarray(ref.sign))


def test_rbm_init_layout_and_interop_round_trip():
    _, params, wf, _ = _rbm_pair()
    ours = wf.init(torch.Generator().manual_seed(0))
    for key in ('hidden', 'onsite'):
        for leaf in ('w', 'b'):
            assert ours[key][leaf].shape == params[key][leaf].shape
    assert ours['hidden']['w'].abs().max() <= 2 * 0.1 / np.sqrt(N) + 1e-7
    back = interop.params_to_numpy(interop.params_from_numpy(params, 'cpu'))
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # Every ansatz of the JAX package is ported: 'made' builds, and an
    # unknown type is a ValueError, as there.
    assert models.build_wavefunction(
        Config(num_sites=N, wavefunction_type='made')).num_sites == N
    with pytest.raises(ValueError, match='not registered'):
        models.build_wavefunction(Config(num_sites=N,
                                         wavefunction_type='maid'))


# ---------------------------------------------------------------------------
# ops/heisenberg.py: local value against JAX (1e-5) and against ED.

@pytest.mark.parametrize('sample_chunk', [0, 5])
@pytest.mark.parametrize('weighted', [False, True])
def test_local_value_matches_jax(sample_chunk, weighted):
    jax_wf, params, wf, tparams = _rbm_pair(seed=5)
    bonds = lattice.chain_bonds(N)
    rng = np.random.default_rng(6)
    couplings = offdiag = None
    if weighted:
        couplings = rng.uniform(0.5, 1.5, len(bonds)).astype(np.float32)
        offdiag = rng.choice([-1.0, 1.0], len(bonds)).astype(np.float32)
    ham = heisenberg.HeisenbergHamiltonian(
        bonds, -1.0, 1.0, sample_chunk=sample_chunk, couplings=couplings,
        offdiag_couplings=offdiag)
    jax_ham = jax_heisenberg.HeisenbergHamiltonian(
        bonds, -1.0, 1.0, sample_chunk=sample_chunk, couplings=couplings,
        offdiag_couplings=offdiag)
    configs = _configs(7)
    ref = np.asarray(jax_ham.local_value(jax_wf, params, configs))
    ours = ham.local_value(wf, tparams, torch.tensor(configs))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    # The caller's amplitudes thread through unchanged.
    amp = wf.apply(tparams, torch.tensor(configs))
    with_amp = ham.local_value(wf, tparams, torch.tensor(configs), amp)
    np.testing.assert_allclose(with_amp.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_local_value_exact_expectation_matches_ed():
    """Σ_R |ψ(R)|² E_loc(R) / Σ|ψ|² over the whole sector equals
    <ψ|H|ψ>/<ψ|ψ> with the ED matrix (float64 reference, rtol 1e-5)."""
    _, _, wf, tparams = _rbm_pair(seed=8)
    bonds = lattice.chain_bonds(N)
    ham = heisenberg.HeisenbergHamiltonian(bonds, -1.0, 1.0)
    states = basis.enumerate_sz_basis(N)
    amp = wf.apply(tparams, torch.tensor(states))
    e_loc = ham.local_value(wf, tparams, torch.tensor(states), amp).double()
    weights = torch.exp(2.0 * (amp.log.double() - amp.log.max()))
    ours = float((weights * e_loc).sum() / weights.sum())
    psi = (amp.sign.double() * torch.exp(amp.log.double())).numpy()
    mat = ed.heisenberg_matrix(N, bonds, j_x=-1.0)
    exact = psi @ mat @ psi / (psi @ psi)
    np.testing.assert_allclose(ours, exact, rtol=1e-5)
    e0, _ = ed.ground_state(N, bonds, j_x=-1.0)
    assert ours >= e0 - 1e-6


def test_heisenberg_rejects_twist():
    """A twist table of the wrong length is refused; one of the right
    length makes the connected weights complex64 with unit-modulus phases
    exp(±i·δ_b) on the antiparallel bonds, equal to the JAX package's."""
    bonds = lattice.chain_bonds(4)
    with pytest.raises(ValueError, match='twist_phases'):
        heisenberg.HeisenbergHamiltonian(bonds, twist_phases=np.zeros(3))
    phases = lattice.twist_phases(4, bonds, 0.8, size_x=4)
    configs = np.array([[1, -1, 1, -1], [1, 1, -1, -1]], np.float32)
    flipped, weights = heisenberg.HeisenbergHamiltonian(
        bonds, twist_phases=phases).connected(torch.tensor(configs))
    ref_flipped, ref_weights = jax_heisenberg.HeisenbergHamiltonian(
        bonds, twist_phases=phases).connected(configs)
    assert weights.dtype == torch.complex64
    np.testing.assert_array_equal(flipped.numpy(), np.asarray(ref_flipped))
    np.testing.assert_allclose(weights.numpy(), np.asarray(ref_weights),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        np.abs(weights.numpy()),
        0.5 * (configs[:, bonds[:, 0]] != configs[:, bonds[:, 1]]),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# optim/common.py: the update rules against optax (rtol 1e-5 over three
# steps; float32 with the bias corrections taken in another precision).

@pytest.mark.parametrize('kind', ['adam', 'gradient', 'rms_prop',
                                  'momentum'])
def test_sgd_update_matches_optax(kind):
    config = Config(optimizer=kind, learning_rates=[0.1, 0.01],
                    learning_rate_stops=[2], beta2=0.99)
    jax_opt = jax_common.make_optax_optimizer(config)
    ours = common.make_sgd_optimizer(config)
    rng = np.random.default_rng(9)
    params = {'hidden': {'w': rng.normal(size=(4, 3)).astype(np.float32),
                         'b': rng.normal(size=3).astype(np.float32)}}
    jax_params, jax_state = params, jax_opt.init(params)
    tparams = interop.params_from_numpy(params, 'cpu')
    state = ours.init(tparams)
    for epoch in range(3):
        grads = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        jax_params, jax_state = jax_opt.update(grads, jax_state, jax_params,
                                               epoch)
        tparams, state = ours.update(
            interop.params_from_numpy(grads, 'cpu'), state, tparams, epoch)
        assert ours.learning_rate(epoch) == pytest.approx(
            float(jax_opt.learning_rate(epoch)))
    jax.tree.map(lambda x, y: np.testing.assert_allclose(
        x, np.asarray(y), rtol=1e-5, atol=1e-7),
        interop.params_to_numpy(tparams), jax.device_get(jax_params))
    with pytest.raises(ValueError):
        common.SgdOptimizer(kind, [0.1], [5])
