"""The complex-phase path of the port against the JAX package, on the CPU:
complex ansatzes, twisted boundaries, and the complex branches of
EnergyGradient, SR, the six SWO optimizers, the evaluators and the
checkpoint.

Inputs are made with numpy from a seed (JAX-initialized params perturbed
with numpy noise, Sz=0 chains from permutations) and carried over with
`interop`.  Tolerances, float32 / complex64 throughout: logψ and local
values rtol 1e-5 / atol 1e-5; whole epochs and SR updates rtol 1e-4 / atol
1e-6 (the same sums in another order); the CG solvers rtol 5e-3 / atol
5e-4, the bound the JAX package's own tests hold them to against the dense
solve; gradients atol 1e-5·max|g| (the exact gradient of a head bias is 0
and only rounding noise remains in either package).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu import evaluate as jax_evaluate
from cgs_vmc_tpu import lattice as jax_lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.models import complex_phase as jax_complex_phase
from cgs_vmc_tpu.ops import heisenberg as jax_heisenberg
from cgs_vmc_tpu.ops import logamp as jax_logamp
from cgs_vmc_tpu.optim import GROUND_STATE_OPTIMIZERS as JAX_GROUND
from cgs_vmc_tpu.optim import SUPERVISED_OPTIMIZERS as JAX_SUPERVISED
from cgs_vmc_tpu.optim.common import TrainState as JaxTrainState
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu.train import build_hamiltonian as jax_hamiltonian
from cgs_vmc_tpu_torch import basis, evaluate, lattice, models
from cgs_vmc_tpu_torch.models import complex_phase
from cgs_vmc_tpu_torch.ops import heisenberg, logamp
from cgs_vmc_tpu_torch.optim import (
    GROUND_STATE_OPTIMIZERS, SUPERVISED_OPTIMIZERS, TrainState, common)
from cgs_vmc_tpu_torch.sampler import metropolis, registry
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import checkpoint, ed, interop

@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """These tensors are tiny: with several test workers on one machine,
    torch's intra-op thread pools only fight each other for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 8
CHAINS = 24
SOLVERS = ('dense', 'dense_cg', 'sample_cg', 'cg')
_PARTS = {'fc_fc': ('fully_connected', 'fully_connected'),
          'rbm_fc': ('rbm', 'fully_connected')}


def _config(parts='fc_fc', **overrides):
    values = dict(num_sites=N, wavefunction_type='complex',
                  composite_wavefunction_types=_PARTS[parts],
                  num_fc_layers=1, fc_layer_size=6, heisenberg_j2=0.5,
                  batch_size=CHAINS, num_batches_per_epoch=2,
                  num_equilibration_sweeps=0, num_monte_carlo_sweeps=0,
                  optimizer='gradient', learning_rates=[2e-2, 1e-2],
                  learning_rate_stops=[1], sr_diag_shift=1e-2,
                  sr_cg_maxiter=200, sr_cg_tol=1e-8, sr_delta_clip=10.0,
                  use_fast_sampler=False)
    values.update(overrides)
    return Config(**values)


def _noisy_params(jax_wf, seed, noise=0.3):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))


def _configs(seed, n=CHAINS, n_sites=N):
    rng = np.random.default_rng(seed)
    template = np.repeat([1.0, -1.0], n_sites // 2).astype(np.float32)
    return np.stack([rng.permutation(template) for _ in range(n)])


def _pair(config, seed=0):
    """(JAX wf, params as numpy, port wf, params as tensors)."""
    jax_wf = jax_build(config)
    params = _noisy_params(jax_wf, seed)
    return (jax_wf, params, models.build_wavefunction(config),
            interop.params_from_numpy(params, 'cpu'))


def _close(actual, expected, what='', rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=what)


def _assert_trees_close(port_tree, jax_tree, rtol=1e-4, atol=1e-6):
    jax.tree.map(lambda x, y: _close(x, y, 'tree', rtol, atol),
                 interop.params_to_numpy(port_tree), jax.device_get(jax_tree))


def _chains(jax_wf, params, seed, n=CHAINS):
    configs = _configs(seed, n)
    amp = jax_wf.apply(params, configs)
    return configs, np.asarray(amp.log), np.asarray(amp.sign)


def _jax_sampler(configs, log_amp, sign):
    n = configs.shape[0]
    zeros = jnp.zeros(n, jnp.float32)
    return JaxSamplerState(jnp.asarray(configs), jnp.asarray(log_amp),
                           jnp.asarray(sign),
                           jax.random.split(jax.random.key(0), n), zeros,
                           zeros)


# ---------------------------------------------------------------------------
# The ansatz and the log-amplitude arithmetic.

@pytest.mark.parametrize('parts', sorted(_PARTS))
def test_complex_logpsi_matches_jax(parts):
    config = _config(parts, composite_output_activations=('tanh', ''))
    jax_wf, params, wf, tparams = _pair(config, seed=1)
    configs = _configs(2, 64)
    ref = jax_wf.apply(params, configs)
    ours = wf.apply(tparams, torch.tensor(configs))
    assert ours.log.dtype == torch.complex64
    assert ours.sign.dtype == torch.float32
    _close(ours.log, ref.log, 'log', 1e-5, 1e-5)
    np.testing.assert_array_equal(ours.sign.numpy(), np.asarray(ref.sign))
    assert set(tparams) == {'modulus', 'phase'}
    assert complex_phase.is_complex(wf, tparams, N)
    assert jax_complex_phase.is_complex(jax_wf, params, N)
    real = _config(wavefunction_type='rbm')
    real_wf = models.build_wavefunction(real)
    assert not complex_phase.is_complex(
        real_wf, real_wf.init(torch.Generator().manual_seed(0)), N)
    # An init of the port has the same tree and leaf shapes.
    ours_init = wf.init(torch.Generator().manual_seed(0))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.shape, b.shape),
                 interop.params_to_numpy(ours_init), params)
    back = interop.params_to_numpy(interop.params_from_numpy(params, 'cpu'))
    jax.tree.map(np.testing.assert_array_equal, back, params)


def test_complex_logamp_arithmetic_matches_jax():
    """add / sub / sum_terms / ratio with a complex phase, against JAX:
    the phase rides in log's imaginary part, the sign stays real."""
    rng = np.random.default_rng(4)

    def amp(n):
        sign = rng.choice([-1.0, 1.0], n).astype(np.float32)
        log = (rng.standard_normal(n)
               + 1j * rng.uniform(-3, 3, n)).astype(np.complex64)
        return sign, log

    a, b = amp(32), amp(32)
    real_b = (b[0], np.real(b[1]))

    def t(pair):
        return logamp.LogAmp(*(torch.tensor(x) for x in pair))

    def j(pair):
        return jax_logamp.LogAmp(*(jnp.asarray(x) for x in pair))

    for name in ('add', 'sub'):
        for other in (b, real_b):
            ours = getattr(logamp, name)(t(a), t(other))
            ref = getattr(jax_logamp, name)(j(a), j(other))
            _close(logamp.to_value(ours), jax_logamp.to_value(ref), name,
                   1e-5, 1e-6)
            np.testing.assert_array_equal(ours.sign.numpy(),
                                          np.asarray(ref.sign))
    signs, logs = (x.reshape(4, 8) for x in a)
    ours = logamp.sum_terms(torch.tensor(signs), torch.tensor(logs))
    ref = jax_logamp.sum_terms(jnp.asarray(signs), jnp.asarray(logs))
    _close(logamp.to_value(ours), jax_logamp.to_value(ref), 'sum_terms',
           1e-5, 1e-6)
    _close(logamp.ratio(t(a), t(b)), jax_logamp.ratio(j(a), j(b)), 'ratio',
           1e-5, 1e-6)
    _close(logamp.log_abs_ratio(t(a), t(b)),
           jax_logamp.log_abs_ratio(j(a), j(b)), 'log_abs_ratio', 1e-6, 1e-6)


# ---------------------------------------------------------------------------
# Twisted boundaries.

@pytest.mark.parametrize('sample_chunk', [0, 5])
@pytest.mark.parametrize('kind', ['complex', 'real'])
def test_twisted_local_value_matches_jax(kind, sample_chunk):
    config = (_config('rbm_fc') if kind == 'complex'
              else _config(wavefunction_type='rbm', num_fc_layers=0))
    jax_wf, params, wf, tparams = _pair(config, seed=5)
    bonds = lattice.chain_bonds(N)
    phases = lattice.twist_phases(N, bonds, 0.7, size_x=N)
    np.testing.assert_array_equal(
        phases, jax_lattice.twist_phases(N, bonds, 0.7, size_x=N))
    ham = heisenberg.HeisenbergHamiltonian(
        bonds, -1.0, 1.0, sample_chunk=sample_chunk, twist_phases=phases)
    jax_ham = jax_heisenberg.HeisenbergHamiltonian(
        bonds, -1.0, 1.0, sample_chunk=sample_chunk, twist_phases=phases)
    configs = _configs(6, 17)
    ref = np.asarray(jax_ham.local_value(jax_wf, params, configs))
    ours = ham.local_value(wf, tparams, torch.tensor(configs))
    assert ours.dtype == torch.complex64 and np.abs(ref.imag).max() > 1e-3
    _close(ours, ref, 'local value', 1e-5, 1e-5)
    amp = wf.apply(tparams, torch.tensor(configs))
    _close(ham.local_value(wf, tparams, torch.tensor(configs), amp), ref,
           'with amp', 1e-5, 1e-5)


def test_twisted_local_value_matches_ed():
    """E_loc(R) = (Hψ)(R)/ψ(R) with the port's own twisted ED matrix over
    the whole N=8 sector, and the |ψ|²-weighted mean is the Rayleigh
    quotient, real and above the twisted ground energy."""
    config = _config('rbm_fc')
    _, _, wf, tparams = _pair(config, seed=8)
    bonds = lattice.chain_bonds(N)
    phases = lattice.twist_phases(N, bonds, 1.2, size_x=N)
    ham = heisenberg.HeisenbergHamiltonian(bonds, -1.0, 1.0,
                                           twist_phases=phases)
    states = torch.tensor(basis.enumerate_sz_basis(N))
    amp = wf.apply(tparams, states)
    e_loc = ham.local_value(wf, tparams, states, amp).numpy()
    psi = logamp.to_value(amp).numpy().astype(np.complex128)
    mat = ed.heisenberg_matrix(N, bonds, j_x=-1.0, twist_phases=phases)
    _close(e_loc, (mat @ psi) / psi, 'H psi / psi', 1e-4, 1e-4)
    exact = np.vdot(psi, mat @ psi) / np.vdot(psi, psi)
    ours = evaluate.exact_expectation(wf, tparams, ham, N)
    _close(ours, exact.real, 'exact_expectation', 1e-5, 1e-6)
    assert abs(exact.imag) < 1e-10
    e0, _ = ed.ground_state(N, bonds, j_x=-1.0, twist_phases=phases)
    e_plain, _ = ed.ground_state(N, bonds, j_x=-1.0)
    assert ours >= e0 - 1e-6 and e0 > e_plain   # the twist costs energy


def test_build_hamiltonian_twist_matches_jax_and_refuses(tmp_path):
    for override in ('num_sites=16,twist_phi=0.3',
                     'num_sites=16,size_x=4,size_y=4,twist_phi=0.5,'
                     'twist_direction=y',
                     'num_sites=8,heisenberg_j2=0.5,twist_phi=-0.4'):
        config = Config().parse(override)
        ours, theirs = build_hamiltonian(config), jax_hamiltonian(config)
        np.testing.assert_array_equal(ours.bonds, theirs.bonds)
        np.testing.assert_array_equal(ours.twist_phases, theirs.twist_phases)
        assert ours.twist_phases.dtype == np.float32
    assert build_hamiltonian(Config(num_sites=8)).twist_phases is None
    with pytest.raises(ValueError, match='chain/square'):
        build_hamiltonian(Config().parse(
            'num_sites=12,size_x=4,size_y=3,lattice_type=triangular,'
            'twist_phi=0.3'))
    j_file = tmp_path / 'J.txt'
    np.savetxt(j_file, lattice.chain_bonds(8), fmt='%d')
    with pytest.raises(ValueError, match='j_file_path'):
        build_hamiltonian(Config(num_sites=8, twist_phi=0.3,
                                 j_file_path=str(j_file)))


def test_ite_target_and_apply_in_place_match_jax():
    """(1 − βH)|ψ⟩ and H|ψ⟩ as wavefunctions, with a complex ψ and a
    twisted H: the factor's phase z/|z| goes into the sign."""
    config = _config('rbm_fc')
    jax_wf, params, wf, tparams = _pair(config, seed=9)
    bonds = lattice.chain_bonds(N)
    phases = lattice.twist_phases(N, bonds, 0.9, size_x=N)
    configs = _configs(10, 16)
    for twist in (None, phases):
        ham = heisenberg.HeisenbergHamiltonian(bonds, 1.0, 1.0,
                                               twist_phases=twist)
        jax_ham = jax_heisenberg.HeisenbergHamiltonian(bonds, 1.0, 1.0,
                                                       twist_phases=twist)
        pairs = [(heisenberg.ite_target(ham, wf, 0.1),
                  jax_heisenberg.ite_target(jax_ham, jax_wf, 0.1)),
                 (ham.apply(wf), jax_ham.apply(jax_wf))]
        for ours_wf, ref_wf in pairs:
            ours = ours_wf.apply(tparams, torch.tensor(configs))
            ref = ref_wf.apply(params, configs)
            _close(logamp.to_value(ours), jax_logamp.to_value(ref),
                   ours_wf.name, 1e-5, 1e-5)
            _close(torch.abs(ours.sign), np.ones(16), 'unit sign', 1e-6)


# ---------------------------------------------------------------------------
# The pullbacks and the optimizers.

def test_real_pullback_refuses_a_complex_log_and_the_complex_one_agrees():
    config = _config()
    jax_wf, params, wf, tparams = _pair(config, seed=11)
    configs = torch.tensor(_configs(12))
    with pytest.raises(NotImplementedError, match='log_amp_phase_pullback'):
        common.log_derivative_pullback(wf, tparams, configs)
    rng = np.random.default_rng(13)
    w_re, w_im = (rng.standard_normal(CHAINS).astype(np.float32)
                  for _ in range(2))
    from cgs_vmc_tpu.optim import common as jax_common
    amp_ref, pull_ref = jax_common.log_amp_phase_pullback(
        jax_wf, params, configs.numpy())
    amp, pull = common.log_amp_phase_pullback(wf, tparams, configs)
    _close(amp.log, amp_ref.log, 'log', 1e-5, 1e-5)
    assert not amp.log.requires_grad
    _assert_trees_close(pull(torch.tensor(w_re), torch.tensor(w_im)),
                        pull_ref(w_re, w_im), 1e-4, 1e-5)


def _ground_epoch(name, config, seed, extra=None, jax_extra=None):
    """One epoch of a ground-state optimizer in both packages from the
    same chains and params (epoch counter 1)."""
    jax_wf, params, wf, tparams = _pair(config, seed)
    chains = _chains(jax_wf, params, seed + 1)
    jax_opt = JAX_GROUND[name](jax_wf, jax_hamiltonian(config), config)
    jax_state = JaxTrainState(params, jax_opt.optax_opt.init(params),
                              _jax_sampler(*chains),
                              jnp.asarray(1, jnp.int32), jax_extra or {})
    jax_new, jax_metrics = jax.jit(jax_opt.epoch)(jax_state)
    opt = GROUND_STATE_OPTIMIZERS[name](wf, build_hamiltonian(config),
                                        config)
    sampler = interop.sampler_state_from_numpy(*chains, 'cpu')
    assert sampler.log_amp.dtype == torch.complex64
    new, metrics = opt.epoch(TrainState(tparams, opt.sgd.init(tparams),
                                        sampler, 1, extra or {}))
    return (new, metrics), (jax_new, jax_metrics), params


@pytest.mark.parametrize('twist_phi', [0.0, 0.6])
@pytest.mark.parametrize('name', ['EnergyGradient', 'SR'])
def test_complex_ground_state_epoch_matches_jax(name, twist_phi):
    config = _config('rbm_fc', wavefunction_optimizer_type=name,
                     heisenberg_j2=0.0 if twist_phi else 0.5,
                     heisenberg_jx=-1.0 if twist_phi else 1.0,
                     twist_phi=twist_phi)
    (new, metrics), (jax_new, jax_metrics), _ = _ground_epoch(name, config, 3)
    names = ['energy', 'energy_variance', 'grad_norm']
    for metric in names:
        assert not metrics[metric].is_complex()
        _close(metrics[metric], jax_metrics[metric], metric)
    if name == 'SR':
        assert abs(float(metrics['sr_residual_norm'])
                   - float(jax_metrics['sr_residual_norm'])) <= 1e-4 * (
            1 + float(jax_metrics['grad_norm']))
    _assert_trees_close(new.params, jax_new.params)
    assert new.epoch == 2 and new.sampler.log_amp.dtype == torch.complex64


@pytest.mark.parametrize('solver', SOLVERS)
@pytest.mark.parametrize('parts', sorted(_PARTS))
def test_complex_update_from_samples_matches_jax(parts, solver):
    config = _config(parts, wavefunction_optimizer_type='SR',
                     sr_solver=solver, learning_rates=[0.05],
                     learning_rate_stops=[])
    jax_wf, params, wf, tparams = _pair(config, seed=0)
    configs = _configs(1, 48)
    jax_opt = JAX_GROUND['SR'](jax_wf, jax_hamiltonian(config), config)
    e_loc = np.asarray(jax_opt.hamiltonian.local_value(jax_wf, params,
                                                       configs))
    assert np.iscomplexobj(e_loc)
    new_jax, _, res_jax, grad_jax = jax.jit(jax_opt.update_from_samples)(
        params, jax_opt.optax_opt.init(params), jnp.zeros((), jnp.int32),
        jnp.asarray(configs), jnp.asarray(e_loc))
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, build_hamiltonian(config), config)
    new, _, res, grad = opt.update_from_samples(
        tparams, opt.sgd.init(tparams), 0, torch.tensor(configs),
        torch.tensor(e_loc))
    g_max = max(float(np.max(np.abs(x))) for x in jax.tree.leaves(grad_jax))
    g_norm = float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                               for x in jax.tree.leaves(grad_jax))))
    _assert_trees_close(grad, grad_jax, 1e-4, 1e-5 * g_max)
    rtol, atol = (1e-4, 1e-6) if solver == 'dense' else (5e-3, 5e-4)
    _assert_trees_close(new, new_jax, rtol, atol)
    assert abs(float(res) - float(res_jax)) <= 1e-4 * (1 + g_norm)


def test_complex_dense_solve_sees_the_stacked_system():
    """Complex local values double the sample-space system: [2M, P] rows,
    real parts first, each half centered; a non-positive-definite system
    still falls back to the (finite) gradient."""
    config = _config(wavefunction_optimizer_type='SR', sr_diag_shift=-2.0,
                     sr_delta_clip=0.5, learning_rates=[0.05],
                     learning_rate_stops=[])
    _, _, wf, tparams = _pair(config, seed=2)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, build_hamiltonian(config), config)
    configs = torch.tensor(_configs(3, 20))
    jac, _ = opt._centered_jacobian(configs, tparams, stacked=True)
    n_params = sum(x.size for x in jax.tree.leaves(
        interop.params_to_numpy(tparams)))
    assert jac.shape == (40, n_params)
    _close(jac[:20].sum(0), np.zeros(n_params), 'centered', atol=1e-4)
    _close(jac[20:].sum(0), np.zeros(n_params), 'centered', atol=1e-4)
    with torch.no_grad():
        e_loc = opt.hamiltonian.local_value(wf, tparams, configs)
    new, _, _, grad = opt.update_from_samples(tparams, {}, 0, configs, e_loc)
    norm = float(common.grad_global_norm(grad))
    scale = min(1.0, 0.5 / (norm + 1e-12))
    expected = jax.tree.map(
        lambda p, g: p - 0.05 * scale * g, interop.params_to_numpy(tparams),
        interop.params_to_numpy(grad))
    _assert_trees_close(new, expected, 1e-5, 1e-7)


@pytest.mark.parametrize('name', ['ITSWO', 'LogOverlapITSWO'])
def test_complex_imaginary_time_epoch_matches_jax(name):
    config = _config('rbm_fc', wavefunction_optimizer_type=name,
                     time_evolution_beta=0.12,
                     optimizer='adam' if name == 'ITSWO' else 'gradient')
    scalars = ({'ite_normalization': 1.3, 'ema_norm': 1.1,
                'ema_energy': -2.5, 'ema_count': 3.0}
               if name == 'ITSWO' else {})
    jax_wf = jax_build(config)
    params = _noisy_params(jax_wf, 4)
    (new, metrics), (jax_new, jax_metrics), params = _ground_epoch(
        name, config, 4,
        extra={'omega': interop.params_from_numpy(params, 'cpu'),
               **{k: torch.tensor(v) for k, v in scalars.items()}},
        jax_extra={'omega': params,
                   **{k: jnp.float32(v) for k, v in scalars.items()}})
    for metric in (('energy', 'loss') if name == 'ITSWO' else ('energy',)):
        assert not metrics[metric].is_complex()
        _close(metrics[metric], jax_metrics[metric], metric)
    _assert_trees_close(new.params, jax_new.params)
    for key in scalars:
        _close(new.extra[key], jax_new.extra[key], key)


@pytest.mark.parametrize('target', ['complex', 'rbm'])
@pytest.mark.parametrize('name', sorted(SUPERVISED_OPTIMIZERS))
def test_complex_supervised_epoch_matches_jax(name, target):
    log_overlap = name == 'LogOverlapSWO'
    config = _config('fc_fc', wavefunction_optimizer_type=name,
                     optimizer='gradient' if log_overlap else 'adam')
    jax_wf, params, wf, tparams = _pair(config, seed=5)
    t_config = (_config('rbm_fc') if target == 'complex' else
                _config(wavefunction_type='rbm', num_fc_layers=0))
    jax_t, t_params, port_t, _ = _pair(t_config, seed=6)
    dual = name == 'DualSamplingSWO'
    n = CHAINS // 2 if dual else CHAINS
    chains = _chains(jax_wf, params, 7, n)
    jax_opt = JAX_SUPERVISED[name](jax_wf, jax_t, config)
    opt = SUPERVISED_OPTIMIZERS[name](wf, port_t, config)
    jax_extra = {'target': t_params}
    extra = {'target': interop.params_from_numpy(t_params, 'cpu')}
    if dual:
        t_chains = _chains(jax_t, t_params, 8, n)
        jax_extra['target_sampler'] = _jax_sampler(*t_chains)
        extra['target_sampler'] = interop.sampler_state_from_numpy(
            *t_chains, 'cpu', seed=1)
    if name == 'BasisIterSWO':
        key = jax.random.key(9)
        jax_extra['data_key'] = key
        _, perm_key = jax.random.split(key)
        stream = np.asarray(jax_opt._epoch_indices(perm_key, None))
        opt._epoch_indices = lambda generator: torch.tensor(stream)
        extra['data_generator'] = torch.Generator()
    jax_state = JaxTrainState(params, jax_opt.optax_opt.init(params),
                              _jax_sampler(*chains),
                              jnp.asarray(1, jnp.int32), jax_extra)
    jax_new, jax_metrics = jax.jit(jax_opt.epoch)(jax_state)
    new, metrics = opt.epoch(TrainState(
        tparams, opt.sgd.init(tparams),
        interop.sampler_state_from_numpy(*chains, 'cpu'), 1, extra))
    metric = 'mean_ratio' if log_overlap else 'loss'
    assert not metrics[metric].is_complex()
    _close(metrics[metric], jax_metrics[metric], metric)
    _assert_trees_close(new.params, jax_new.params)


# ---------------------------------------------------------------------------
# Sampling, evaluation, checkpoints.

def test_metropolis_reads_the_real_part_and_keeps_the_dtypes():
    config = _config('rbm_fc', use_fast_sampler=True)
    _, _, wf, tparams = _pair(config, seed=14)
    # An RBM modulus inside 'complex' is not a pure RBM: generic sampler.
    assert registry.resolved_name(wf, config) == 'generic'
    state = metropolis.init_sampler_for(3, wf, tparams, config, 'cpu', 64)
    out = metropolis.run_sweeps(wf, tparams, state, 2)
    assert out.log_amp.dtype == torch.complex64
    assert out.sign.dtype == torch.float32
    amp = wf.apply(tparams, out.configs)
    _close(out.log_amp, amp.log, 'cache', 1e-6, 1e-6)
    assert 0.0 < float(metropolis.acceptance_rate(out)) < 1.0
    assert bool((out.configs.sum(dim=1) == 0).all())
    # A phase-only change of the proposal never moves the acceptance.
    flat = models.build_wavefunction(_config(wavefunction_type='rbm'))
    mod_state = metropolis.init_sampler_for(3, flat, tparams['modulus'],
                                            config, 'cpu', 64)
    mod_out = metropolis.run_sweeps(flat, tparams['modulus'], mod_state, 2)
    np.testing.assert_array_equal(out.configs.numpy(),
                                  mod_out.configs.numpy())


def test_complex_evaluators_match_jax(tmp_path):
    config = _config('rbm_fc', batch_size=32, num_evaluation_samples=6,
                     num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
                     checkpoint_dir=str(tmp_path))
    jax_wf, params, wf, tparams = _pair(config, seed=15)
    psi = evaluate.evaluate_vector(wf, tparams, config)
    ref = jax_evaluate.evaluate_vector(
        jax_wf, params, config.replace(checkpoint_dir=''))
    assert np.iscomplexobj(psi)
    _close(psi, ref, 'evaluate_vector', 1e-5, 1e-6)
    lines = (tmp_path / 'wavefunction_epoch_0.txt').read_text().splitlines()
    assert len(lines) == 70 and lines[0].startswith('(')
    _close(evaluate.overlap_with_vector(psi, ref), 1.0, 'overlap', 1e-6)
    _close(evaluate.overlap_with_vector(psi * np.exp(0.7j), ref), 1.0,
           'a global phase drops out', 1e-6)
    ham, jax_ham = build_hamiltonian(config), jax_hamiltonian(config)
    _close(evaluate.exact_expectation(wf, tparams, ham, N),
           jax_evaluate.exact_expectation(jax_wf, params, jax_ham, N),
           'exact_expectation', 1e-5, 1e-6)
    result = evaluate.evaluate_operator(wf, tparams, ham, config, 'cpu')
    assert result.values.dtype == np.float32 and result.values.shape == (6,)
    assert np.isfinite(result.mean) and np.isfinite(result.error)
    e0, _ = ed.ground_state(N, ham.bonds, couplings=ham.couplings)
    assert result.mean > e0 - 0.5


def _train_config(**overrides):
    """The recipe of configs/j1j2_chain8_complex_sr.json."""
    values = dict(num_sites=N, wavefunction_type='complex',
                  composite_wavefunction_types=('fully_connected',
                                                'fully_connected'),
                  num_fc_layers=1, fc_layer_size=16, heisenberg_j2=0.5,
                  batch_size=256, num_batches_per_epoch=4,
                  num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
                  optimizer='gradient', learning_rates=[0.05, 0.02],
                  learning_rate_stops=[40], sr_solver='dense',
                  sr_diag_shift=1e-3, sr_delta_clip=10.0,
                  wavefunction_optimizer_type='SR', seed=7)
    values.update(overrides)
    return Config(**values)


class _Record:
    def __init__(self):
        self.energies = []

    def log(self, epoch, metrics):
        self.energies.append(float(metrics['energy']))


def test_complex_checkpoint_round_trip_and_exact_resume(tmp_path):
    """A complex log_amp in the sampler state survives torch.save /
    torch.load(weights_only=True), and 3 + 3 resumed epochs equal 6
    straight ones bit for bit."""
    config = _train_config(batch_size=32, num_batches_per_epoch=2,
                           num_equilibration_sweeps=1, fc_layer_size=6)
    straight, resumed = _Record(), _Record()
    final = train(config.replace(num_epochs=6,
                                 checkpoint_dir=str(tmp_path / 'a')),
                  'cpu', logger=straight)
    run = config.replace(checkpoint_dir=str(tmp_path / 'b'))
    train(run.replace(num_epochs=3), 'cpu', logger=resumed)
    latest = checkpoint.latest_checkpoint(run.checkpoint_dir)
    restored = checkpoint.restore_checkpoint(latest, 'cpu')
    assert restored.sampler.log_amp.dtype == torch.complex64
    assert restored.epoch == 3
    again = train(run.replace(num_epochs=6), 'cpu', resume=True,
                  logger=resumed)
    assert resumed.energies == straight.energies
    jax.tree.map(np.testing.assert_array_equal,
                 interop.params_to_numpy(again.params),
                 interop.params_to_numpy(final.params))
    np.testing.assert_array_equal(again.sampler.log_amp.numpy(),
                                  final.sampler.log_amp.numpy())
    # A complex sign (an operator applied to ψ) round-trips too.
    state = final._replace(sampler=final.sampler._replace(
        sign=torch.exp(1j * final.sampler.log_amp.imag)))
    path = checkpoint.save_checkpoint(str(tmp_path / 'c'), state, 0)
    back = checkpoint.restore_checkpoint(path, 'cpu')
    assert back.sampler.sign.dtype == torch.complex64
    np.testing.assert_array_equal(back.sampler.sign.numpy(),
                                  state.sampler.sign.numpy())


def test_complex_sr_training_descends():
    """30 epochs of the J1-J2 recipe through `train`: the energy falls by
    more than 1 from the start toward E0 = -3."""
    record = _Record()
    train(_train_config(num_epochs=30), 'cpu', logger=record)
    assert all(np.isfinite(record.energies))
    assert np.mean(record.energies[-5:]) < record.energies[0] - 1.0
    assert np.mean(record.energies[-5:]) > -3.0 - 0.2


@pytest.mark.slow
def test_complex_sr_trains_majumdar_ghosh():
    """configs/j1j2_chain8_complex_sr.json's recipe through `train` for its
    150 epochs: the mean of the last 10 energies below -2.85 and within 5%
    of the exact Majumdar-Ghosh E0 = -3N/8, the bar of the JAX package's
    tests/test_complex.py."""
    record = _Record()
    train(_train_config(num_epochs=150), 'cpu', logger=record)
    e0 = -3.0 * N / 8.0
    final = np.mean(record.energies[-10:])
    assert final < -2.85, f'SR failed to descend: E={final} vs E0={e0}'
    assert abs(final - e0) / abs(e0) < 0.05
