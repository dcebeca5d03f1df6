"""t-VMC and linear-response dynamics of the port against the JAX package,
on the CPU: the TDVP direction, a whole TimeEvolution step, the
full-basis oracles (a complete (modulus, phase) parameterization follows
exact Schrödinger dynamics), the quench and the exact linear response, the
spectral transform, the antithetic sampled response and `cli evolve`.

Inputs are made with numpy from a seed (JAX-initialized params perturbed
with numpy noise, Sz=0 chains from permutations) and carried over with
`interop`.  Tolerances, float32 throughout: TDVP directions and steps rtol
1e-4 / atol 1e-5·max|θ̇| with a relative diagonal shift of 1e-2 (the
[M, M] solve is then well conditioned, so both packages' Cholesky
factorizations agree to that bound; the sums run in another order); the
McLachlan residual r2 = <|ε|²> − θ̇·f, a cancellation, within 1e-4·(1 +
<|ε|²>); the exact linear response over 10 steps rtol 1e-3; the
full-basis oracles at tests/test_tvmc.py's bars; spectral_function bit for
bit (float64 numpy, the same code).
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from cgs_vmc_tpu import lattice as jax_lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import FullVector as JaxFullVector
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.models.complex_phase import (
    ComplexPhaseWavefunction as JaxComplexPhase)
from cgs_vmc_tpu.ops import dynamics as jax_dynamics
from cgs_vmc_tpu.ops.heisenberg import HeisenbergHamiltonian as JaxHeisenberg
from cgs_vmc_tpu.optim import tvmc as jax_tvmc
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu_torch import basis, cli, lattice, models
from cgs_vmc_tpu_torch.models.base import tree_map
from cgs_vmc_tpu_torch.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.ops import dynamics, logamp
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.ops.observables import chain_positions
from cgs_vmc_tpu_torch.optim import tvmc
from cgs_vmc_tpu_torch.sampler import metropolis
from cgs_vmc_tpu_torch.train import train
from cgs_vmc_tpu_torch.utils import ed, interop


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The tensors are tiny: with several test workers on one machine,
    torch's intra-op thread pools only fight each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 8
CHAINS = 32
SHIFT = 1e-2
_ANSATZ = {
    'rbm': dict(wavefunction_type='rbm', num_fc_layers=0, fc_layer_size=8),
    'complex': dict(wavefunction_type='complex',
                    composite_wavefunction_types=('rbm', 'fully_connected'),
                    num_fc_layers=1, fc_layer_size=6),
}


def _config(kind, **overrides):
    values = dict(num_sites=N, heisenberg_jx=-1.0, use_fast_sampler=False,
                  sr_diag_shift=SHIFT, **_ANSATZ[kind])
    values.update(overrides)
    return Config(**values)


def _problem(kind, seed=0, chains=CHAINS, **overrides):
    """(config, JAX wf, port wf, numpy params, port params, numpy configs,
    JAX Hamiltonian, port Hamiltonian)."""
    config = _config(kind, **overrides)
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    template = np.repeat([1.0, -1.0], N // 2)
    configs = np.stack([rng.permutation(template) for _ in range(chains)]
                       ).astype(np.float32)
    bonds = lattice.chain_bonds(N)
    return (config, jax_wf, models.build_wavefunction(config), params,
            interop.params_from_numpy(params, 'cpu'), configs,
            JaxHeisenberg(bonds, -1.0, 1.0),
            HeisenbergHamiltonian(bonds, -1.0, 1.0))


def _max_abs(tree):
    return max(float(np.max(np.abs(x))) for x in jax.tree.leaves(tree))


def _assert_trees_close(got, want, rtol=1e-4):
    atol = 1e-5 * _max_abs(want)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=rtol, atol=atol),
        interop.params_to_numpy(got), jax.device_get(want))


@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('kind, mode', [('rbm', 'imag'), ('complex', 'imag'),
                                        ('complex', 'real')])
def test_tdvp_direction_matches_jax(kind, mode, weighted):
    _, jax_wf, wf, np_params, params, configs, jax_ham, ham = _problem(
        kind, seed=1)
    e_loc = np.array(jax_ham.local_value(jax_wf, np_params,
                                         jnp.asarray(configs)))
    assert np.iscomplexobj(e_loc) == (kind == 'complex')
    weights = None
    if weighted:
        w = np.random.default_rng(2).uniform(0.2, 1.0, CHAINS)
        weights = (w / w.sum()).astype(np.float32)
    want = jax_tvmc.tdvp_direction(
        jax_wf, np_params, jnp.asarray(configs), jnp.asarray(e_loc), mode,
        SHIFT, None if weights is None else jnp.asarray(weights))
    got = tvmc.tdvp_direction(
        wf, params, torch.as_tensor(configs), torch.as_tensor(e_loc), mode,
        SHIFT, None if weights is None else torch.as_tensor(weights))
    _assert_trees_close(got[0], want[0])
    np.testing.assert_allclose(complex(got[1]), complex(want[1]), rtol=1e-5)
    eps2 = float(np.sum((weights if weighted else 1.0 / CHAINS)
                        * np.abs(e_loc - complex(want[1])) ** 2))
    assert abs(float(got[2]) - float(want[2])) <= 1e-4 * (1.0 + eps2)


def test_tdvp_chunked_jacobian_is_the_same_direction():
    _, _, wf, _, params, configs, _, ham = _problem('complex', seed=3)
    configs = torch.as_tensor(configs)
    e_loc = ham.local_value(wf, params, configs)
    full = tvmc.tdvp_direction(wf, params, configs, e_loc, 'real', SHIFT)
    chunked = tvmc.tdvp_direction(wf, params, configs, e_loc, 'real', SHIFT,
                                  jacobian_chunk=10)
    _assert_trees_close(chunked[0], interop.params_to_numpy(full[0]),
                        rtol=1e-5)


def test_real_time_requires_complex_ansatz():
    """Both packages refuse a real-time step of a real ansatz, with the same
    message."""
    _, jax_wf, wf, np_params, params, configs, jax_ham, ham = _problem('rbm')
    e_loc = ham.local_value(wf, params, torch.as_tensor(configs))
    with pytest.raises(ValueError) as port_err:
        tvmc.tdvp_direction(wf, params, torch.as_tensor(configs), e_loc,
                            mode='real')
    with pytest.raises(ValueError) as jax_err:
        jax_tvmc.tdvp_direction(jax_wf, np_params, jnp.asarray(configs),
                                jnp.asarray(e_loc.numpy()), mode='real')
    assert str(port_err.value) == str(jax_err.value)
    assert 'complex-log ansatz' in str(port_err.value)
    with pytest.raises(ValueError, match='mode'):
        tvmc.tdvp_direction(wf, params, torch.as_tensor(configs), e_loc,
                            mode='sideways')


@pytest.mark.parametrize('integrator', ['euler', 'heun'])
@pytest.mark.parametrize('kind, mode', [('rbm', 'imag'), ('complex', 'real')])
def test_time_evolution_step_matches_jax(kind, mode, integrator):
    """One TimeEvolution.step with zero decorrelation sweeps, so both
    packages integrate on the same chains: new params and every metric.
    Heun solves twice, the second time at a midpoint the first solve's
    rounding has moved, so the shift is 1e-1 here (at 1e-2 this seed's
    complex system reaches |θ̇| ~ 90 and the two packages' steps differ by
    2.8e-5 of it)."""
    config, jax_wf, wf, np_params, params, configs, jax_ham, ham = _problem(
        kind, seed=4, num_monte_carlo_sweeps=0, sr_diag_shift=0.1)
    amp = jax_wf.apply(np_params, configs)
    log_amp, sign = np.asarray(amp.log), np.asarray(amp.sign)
    zeros = jnp.zeros(CHAINS, jnp.float32)
    jax_sampler = JaxSamplerState(
        jnp.asarray(configs), jnp.asarray(log_amp), jnp.asarray(sign),
        jax.random.split(jax.random.key(0), CHAINS), zeros, zeros)
    jax_evo = jax_tvmc.TimeEvolution(jax_wf, jax_ham, config, dt=0.05,
                                     mode=mode, integrator=integrator)
    want_params, _, want = jax_evo.step(np_params, jax_sampler,
                                        jnp.asarray(0.05, jnp.float32))
    evo = tvmc.TimeEvolution(wf, ham, config, dt=0.05, mode=mode,
                             integrator=integrator)
    sampler = interop.sampler_state_from_numpy(configs, log_amp, sign, 'cpu')
    got_params, new_sampler, got = evo.step(params, sampler)
    torch.testing.assert_close(new_sampler.configs, sampler.configs)
    assert set(got) == set(want)
    _assert_trees_close(got_params, want_params)
    for key in ('energy', 'energy_imag', 'dt'):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(got['integrator_rel_error']),
                               float(want['integrator_rel_error']),
                               rtol=1e-3, atol=1e-6)
    assert abs(float(got['tdvp_r2']) - float(want['tdvp_r2'])) <= 1e-4 * (
        1.0 + abs(float(want['tdvp_r2'])))


def test_adaptive_dt_and_integrator_checks():
    """adaptive_tol rescales dt from the embedded Heun error within
    [0.5, 1.5] a step; it needs heun; unknown integrators are refused."""
    config, _, wf, _, params, _, _, ham = _problem(
        'complex', seed=5, batch_size=64, num_equilibration_sweeps=2)
    evo = tvmc.TimeEvolution(wf, ham, config, dt=0.002, mode='real',
                             adaptive_tol=1e-3)
    sampler = evo.init_state(6, params, 'cpu')
    _, _, records = evo.evolve(params, sampler, 4)
    dts = [r['dt'] for r in records]
    assert len(set(np.round(dts, 8))) > 1, 'dt never adapted'
    for a, b in zip(dts, dts[1:]):
        assert 0.5 * a - 1e-9 <= b <= 1.5 * a + 1e-9
    assert all(np.isfinite(r['energy']) for r in records)
    with pytest.raises(ValueError, match='heun'):
        tvmc.TimeEvolution(wf, ham, config, dt=0.01, integrator='euler',
                           adaptive_tol=1e-3)
    with pytest.raises(ValueError, match='integrator'):
        tvmc.TimeEvolution(wf, ham, config, dt=0.01, integrator='rk4')


# ---------------------------------------------------------------------------
# Full-basis oracles (tests/test_tvmc.py, tests/test_dynamics.py) at N=6.

M = 6


def _j1j2(j2=0.5):
    bonds, mask = lattice.j1j2_chain_bonds(M)
    couplings = (1.0 - mask) + j2 * mask
    dense = np.asarray(ed.heisenberg_matrix(M, bonds, couplings=couplings,
                                            sparse=False))
    return dense, HeisenbergHamiltonian(bonds, couplings=couplings)


def _exact_param_wf(v0, package='port'):
    """A real sector vector as modulus·exp(i·phase), phase 0: a complete
    parameterization of the sector."""
    if package == 'jax':
        wf = JaxComplexPhase(
            JaxFullVector.for_sector(M, v0.astype(np.float32)),
            JaxFullVector.for_sector(M, np.ones_like(v0, np.float32)))
        return wf, wf.init(jax.random.key(0))
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(M, v0.astype(np.float32)),
        FullVector.for_sector(M, np.ones_like(v0, np.float32)))
    return wf, wf.init(torch.Generator())


def _state_vector(wf, params, states):
    with torch.no_grad():
        amp = wf.apply(params, states)
        psi = logamp.to_value(amp._replace(
            log=amp.log - amp.log.real.max())).numpy()
    return psi / np.linalg.norm(psi)


def _evolve_tdvp(wf, params, ham, states, dt, n_steps, mode='real'):
    """Heun integration of TDVP with exact full-basis |psi|² weights."""
    def direction(p):
        with torch.no_grad():
            amp = wf.apply(p, states)
            weights = torch.softmax(2.0 * amp.log.real, dim=0)
            e_loc = ham.local_value(wf, p, states, amp)
        return tvmc.tdvp_direction(wf, p, states, e_loc, mode=mode,
                                   diag_shift=1e-6, weights=weights)

    energies, r2s = [], []
    for _ in range(n_steps):
        k1, e, r2 = direction(params)
        k2, _, _ = direction(tree_map(lambda a, d: a + 0.5 * dt * d,
                                      params, k1))
        params = tree_map(lambda a, d: a + dt * d, params, k2)
        energies.append(complex(e))
        r2s.append(float(r2))
    return params, energies, r2s


def _states():
    return torch.as_tensor(basis.enumerate_sz_basis(M))


def test_tdvp_stationary_ground_state():
    dense, ham = _j1j2()
    vals, vecs = np.linalg.eigh(dense)
    wf, params = _exact_param_wf(vecs[:, 0])
    params, energies, _ = _evolve_tdvp(wf, params, ham, _states(), 0.01, 20)
    assert abs(np.vdot(_state_vector(wf, params, _states()),
                       vecs[:, 0])) > 1 - 1e-6
    np.testing.assert_allclose([e.real for e in energies], vals[0],
                               rtol=1e-5)


def test_tdvp_real_time_quench_matches_expm():
    """The NN-chain ground state under the J1-J2 Hamiltonian tracks
    exp(-iHt)|psi0> (tests/test_tvmc.py:92)."""
    dense, ham = _j1j2()
    _, v_chain = ed.ground_state(M, lattice.chain_bonds(M))
    wf, params = _exact_param_wf(v_chain)
    t_final, n_steps = 0.2, 40
    params, energies, r2s = _evolve_tdvp(wf, params, ham, _states(),
                                         t_final / n_steps, n_steps)
    assert max(r2s) < 1e-4, max(r2s)
    exact = scipy.linalg.expm(-1j * dense * t_final) @ v_chain
    fidelity = abs(np.vdot(_state_vector(wf, params, _states()),
                           exact / np.linalg.norm(exact)))
    assert fidelity > 0.9999, fidelity
    assert abs(energies[-1].real - energies[0].real) < 1e-3 * max(
        1.0, abs(energies[0].real))


def test_tdvp_imaginary_time_descends_to_ground_state():
    dense, ham = _j1j2()
    vals, vecs = np.linalg.eigh(dense)
    v = np.random.default_rng(1).uniform(0.3, 1.0, size=dense.shape[0])
    wf, params = _exact_param_wf(v)
    params, energies, _ = _evolve_tdvp(wf, params, ham, _states(), 0.05, 120,
                                       mode='imag')
    assert energies[-1].real < vals[0] + 1e-3
    # The Majumdar-Ghosh ground state is two-fold degenerate.
    ground = vecs[:, vals < vals[0] + 1e-8]
    assert np.linalg.norm(ground.conj().T @ _state_vector(
        wf, params, _states())) > 0.999


def _probe(package='port'):
    mod = jax_dynamics if package == 'jax' else dynamics
    return mod.FourierSz([np.pi], chain_positions(M))


def test_fourier_probe_and_quench_match_jax():
    """FourierSz's local values at 1e-5, and quench_params (full-basis
    weights) at rtol 1e-4 against the JAX package."""
    _, v0 = ed.ground_state(M, lattice.chain_bonds(M))
    jax_wf, jax_params = _exact_param_wf(v0, 'jax')
    wf, params = _exact_param_wf(v0)
    states = basis.enumerate_sz_basis(M)
    np.testing.assert_allclose(
        _probe().local_value(None, None, torch.as_tensor(states)).numpy(),
        np.asarray(_probe('jax').local_value(None, None,
                                             jnp.asarray(states))),
        rtol=1e-5, atol=1e-6)
    assert _probe().coeff.dtype == np.float32
    np.testing.assert_array_equal(_probe().coeff, _probe('jax').coeff)
    amp = jax_wf.apply(jax_params, jnp.asarray(states))
    want = jax_dynamics.quench_params(
        jax_wf, jax_params, jnp.asarray(states), _probe('jax'), 0.05,
        weights=jax.nn.softmax(2.0 * jnp.real(amp.log)))
    t_states = torch.as_tensor(states)
    with torch.no_grad():
        weights = torch.softmax(2.0 * wf.apply(params, t_states).log.real, 0)
    got = dynamics.quench_params(wf, params, t_states, _probe(), 0.05,
                                 weights=weights)
    _assert_trees_close(got, want)


def test_exact_linear_response_matches_jax_and_dense():
    """exact_linear_response over 10 Heun steps: C(t) and the energies at
    rtol 1e-3 against the JAX package, and C(t) against the dense
    Re<0|O(t) O|0>_c (tests/test_dynamics.py's bound)."""
    dense = np.asarray(ed.heisenberg_matrix(M, lattice.chain_bonds(M),
                                            sparse=False))
    vals, vecs = np.linalg.eigh(dense)
    v0 = vecs[:, 0]
    states = basis.enumerate_sz_basis(M)
    jax_wf, jax_params = _exact_param_wf(v0, 'jax')
    wf, params = _exact_param_wf(v0)
    dt, n_steps, eps = 0.02, 10, 0.05
    want = jax_dynamics.exact_linear_response(
        jax_wf, jax_params, JaxHeisenberg(jax_lattice.chain_bonds(M)),
        _probe('jax'), jnp.asarray(states), eps, dt, n_steps)
    got = dynamics.exact_linear_response(
        wf, params, HeisenbergHamiltonian(lattice.chain_bonds(M)), _probe(),
        torch.as_tensor(states), eps, dt, n_steps)
    np.testing.assert_array_equal(got[0], want[0])
    scale = float(np.abs(want[1]).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3,
                               atol=1e-3 * scale)
    np.testing.assert_allclose(got[2]['energy'], want[2]['energy'],
                               rtol=1e-3)
    assert max(got[2]['tdvp_r2']) < 1e-4

    o_mat = np.diag(0.5 * states.astype(np.float64) @ np.asarray(
        _probe().coeff, np.float64))
    ov = o_mat @ v0
    o0 = float(v0 @ ov)
    dense_c = []
    for t in got[0]:
        u = scipy.linalg.expm(-1j * dense * t)
        dense_c.append(np.real(np.vdot(u @ v0, o_mat @ (u @ ov))) - o0 * o0)
    np.testing.assert_allclose(got[1], dense_c,
                               atol=0.02 * np.abs(dense_c).max() + 5e-4)


def test_spectral_function_equals_jax():
    rng = np.random.default_rng(3)
    times = 0.05 * np.arange(41)
    corr = rng.normal(size=41)
    omegas = np.linspace(0.0, 3 * np.pi, 64)
    for eta in (0.2, 0.5):
        np.testing.assert_array_equal(
            dynamics.spectral_function(times, corr, omegas, eta),
            jax_dynamics.spectral_function(times, corr, omegas, eta))


def test_sampled_linear_response_shares_the_draws():
    """The -eps trajectory draws the random numbers of the +eps one: a
    coupled copy of a sampler sweeps to the same configurations (a fresh
    generator does not), and at eps = 1e-30 the two trajectories are one
    state, so C(t) is exactly 0 — independent draws would make it huge."""
    config, _, wf, _, params, _, _, ham = _problem(
        'complex', seed=7, batch_size=64, num_equilibration_sweeps=2)
    state = metropolis.init_sampler_for(8, wf, params, config, 'cpu')
    sweeps = tvmc.TimeEvolution(wf, ham, config, dt=0.01).sweeps
    coupled = dynamics.coupled_copy(state)
    assert coupled.generator is not state.generator
    a = sweeps(params, state, 1)
    b = sweeps(params, coupled, 1)
    torch.testing.assert_close(a.configs, b.configs, rtol=0, atol=0)
    c = sweeps(params, state._replace(
        generator=torch.Generator().manual_seed(99)), 1)
    assert not torch.equal(a.configs, c.configs)

    probe = dynamics.FourierSz([np.pi], chain_positions(N))
    times, corr, records = dynamics.sampled_linear_response(
        wf, params, ham, probe, config, eps=1e-30, dt=0.02, n_steps=3,
        device='cpu')
    np.testing.assert_array_equal(corr, np.zeros(4))
    assert len(times) == 4 and len(records) == 3
    times, corr, _ = dynamics.sampled_linear_response(
        wf, params, ham, probe, config, eps=0.05, dt=0.02, n_steps=3,
        device='cpu')
    assert np.isfinite(corr).all() and np.any(corr != 0)


@pytest.fixture(scope='module')
def complex_run(tmp_path_factory):
    """A 1-epoch EnergyGradient run of a complex(fc × fc) ansatz, N=6,
    jx = -1 (tests/test_dynamics.py's CLI run)."""
    run_dir = str(tmp_path_factory.mktemp('complex_run'))
    config = Config(
        num_sites=M, num_epochs=1, wavefunction_type='complex',
        wavefunction_optimizer_type='EnergyGradient', heisenberg_jx=-1.0,
        composite_wavefunction_types=('fully_connected', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=6, batch_size=16,
        num_batches_per_epoch=1, num_equilibration_sweeps=1,
        checkpoint_dir=run_dir)
    train(config, 'cpu')
    return run_dir


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize('mode', ['imag', 'real'])
def test_cli_evolve(complex_run, capsys, mode):
    """`evolve` in both modes writes evolution.jsonl: one line a step, the
    JAX CLI's keys (t and TimeEvolution.step's metrics)."""
    capsys.readouterr()
    assert cli.main(['evolve', '--device', 'cpu', '--checkpoint_dir',
                     complex_run, '--dt', '0.01', '--steps', '3', '--mode',
                     mode, '--override', 'num_equilibration_sweeps=2']) == 0
    out = capsys.readouterr().out
    assert f'({mode} time)' in out and 'Final energy:' in out
    lines = _jsonl(os.path.join(complex_run, 'evolution.jsonl'))
    assert len(lines) == 3
    assert set(lines[0]) == {'t', 'energy', 'energy_imag', 'tdvp_r2',
                             'integrator_rel_error', 'dt'}
    np.testing.assert_allclose([r['t'] for r in lines], [0.01, 0.02, 0.03])
    assert all(np.isfinite(r['energy']) for r in lines)


def test_cli_evolve_linear_response(complex_run, capsys):
    capsys.readouterr()
    assert cli.main(['evolve', '--device', 'cpu', '--checkpoint_dir',
                     complex_run, '--linear_response', '1', '--eps', '0.05',
                     '--dt', '0.02', '--steps', '3', '--override',
                     'num_equilibration_sweeps=2']) == 0
    assert 'S(q,omega) peak at omega=' in capsys.readouterr().out
    first, second = _jsonl(os.path.join(complex_run,
                                        'linear_response.jsonl'))
    assert set(first) == {'q_over_pi', 'eps', 'times', 'correlator'}
    assert set(second) == {'omegas', 'spectral_function'}
    assert first['q_over_pi'] == '1' and len(first['times']) == 4
    assert np.isfinite(first['correlator']).all()
    assert len(second['omegas']) == 256
    assert np.isfinite(second['spectral_function']).all()

    assert cli.main(['evolve', '--device', 'cpu', '--checkpoint_dir',
                     complex_run, '--linear_response', '1;1']) == 1
    assert ('--linear_response needs 1 momentum component(s)'
            in capsys.readouterr().err)
