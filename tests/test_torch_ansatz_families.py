"""The Jastrow, MPS, determinant and graph ansatzes and the 'sum' / 'diff' /
'prod' composites of the port against the JAX package, on the CPU.

Params are JAX-initialized, perturbed with numpy noise from a seed, and
carried over with `interop` (the nested trees unchanged); configurations
are seeded permutations of the Sz=0 template.  Tolerances, float32: logψ
and local energies rtol 1e-5 / atol 1e-5 (signs exact); one dense SR update
rtol 1e-4 / atol 1e-6, its gradient atol 1e-5·max|g|.  The SR update runs
at sr_diag_shift 0.1, which holds the [48, 48] system's condition number
near 10², where two float32 Cholesky solves agree to that tolerance for
every family (the graph ansatz on the 2×4 torus, with its repeated
neighbours, sits at 2·10³ with a shift of 0.01).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.models import determinant as jax_determinant
from cgs_vmc_tpu.optim.sr import StochasticReconfiguration as JaxSR
from cgs_vmc_tpu.train import build_hamiltonian as jax_hamiltonian
from cgs_vmc_tpu_torch import lattice, models
from cgs_vmc_tpu_torch.models import determinant
from cgs_vmc_tpu_torch.models.base import (
    ProductOfWavefunctions, ScaledWavefunction, SumOfWavefunctions)
from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
from cgs_vmc_tpu_torch.train import build_hamiltonian
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
_FC = dict(num_fc_layers=1, fc_layer_size=6)
_CONV = dict(num_conv_layers=2, num_conv_filters=4, kernel_size=3)
FAMILIES = {
    'jastrow': dict(wavefunction_type='jastrow'),
    'jastrow_tanh': dict(wavefunction_type='jastrow',
                         output_activation='tanh'),
    'mps': dict(wavefunction_type='mps', bond_dimension=3),
    'pbdg': dict(wavefunction_type='pbdg'),
    'nnb': dict(wavefunction_type='fully_connected_nnb', nonlinearity='tanh',
                **_FC),
    'gnn_bonds': dict(wavefunction_type='gnn', **_CONV),
    'gnn_square': dict(wavefunction_type='gnn', size_x=2, size_y=4, **_CONV),
    'gnn_file': dict(wavefunction_type='gnn', **_CONV),   # path set below
    'sum': dict(wavefunction_type='sum',
                composite_wavefunction_types=('fully_connected', 'rbm'),
                composite_output_activations=('tanh', ''), **_FC),
    'diff': dict(wavefunction_type='diff',
                 composite_wavefunction_types=('fully_connected',
                                               'fully_connected'),
                 composite_output_activations=('', 'tanh'), **_FC),
    'prod': dict(wavefunction_type='prod',
                 composite_wavefunction_types=('jastrow', 'conv_1d'),
                 **_CONV),
    'prod_signed': dict(wavefunction_type='prod',
                        composite_wavefunction_types=('mps',
                                                      'fully_connected'),
                        composite_output_activations=('', 'tanh'),
                        bond_dimension=2, **_FC),
}
# The adjacency file of 'gnn_file': a chain with next-nearest neighbours.
_ADJACENCY = np.array([[(i - 1) % N, (i + 1) % N, (i + 2) % N]
                       for i in range(N)])


@pytest.fixture
def family(request, tmp_path):
    values = dict(num_sites=N, heisenberg_jx=-1.0, **FAMILIES[request.param])
    if request.param == 'gnn_file':
        path = tmp_path / 'adjacency.txt'
        np.savetxt(path, _ADJACENCY, fmt='%d')
        values['adjacency_list_path'] = str(path)
    return Config(**values)


def _pair(config, seed=0):
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    # The graph ansatz sums its output over sites and channels, so the same
    # noise swings its logψ (and the local energies) far more.
    noise = 0.05 if config.wavefunction_type == 'gnn' else 0.2
    params = jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    return (jax_wf, params, models.build_wavefunction(config),
            interop.params_from_numpy(params, 'cpu'))


def _configs(seed, n):
    rng = np.random.default_rng(seed)
    template = np.repeat([1.0, -1.0], N // 2).astype(np.float32)
    return np.stack([rng.permutation(template) for _ in range(n)])


def _close(actual, expected, what, rtol, atol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize('family', sorted(FAMILIES), indirect=True)
def test_logpsi_and_local_energy_match_jax(family):
    jax_wf, params, wf, tparams = _pair(family, seed=1)
    configs = _configs(2, 40)
    ref = jax_wf.apply(params, configs)
    ours = wf.apply(tparams, torch.tensor(configs))
    np.testing.assert_array_equal(ours.sign.numpy(), np.asarray(ref.sign))
    _close(ours.log, ref.log, 'log', 1e-5, 1e-5)
    assert ours.log.dtype == torch.float32 and ours.log.shape == (40,)
    e_ref = jax_hamiltonian(family).local_value(jax_wf, params, configs)
    e_ours = build_hamiltonian(family).local_value(wf, tparams,
                                                   torch.tensor(configs))
    _close(e_ours, e_ref, 'local energy', 1e-5, 1e-5)


@pytest.mark.parametrize('family', sorted(FAMILIES), indirect=True)
def test_init_and_interop_round_trip(family):
    """The port's init has the JAX tree (keys, shapes, float32), and the
    JAX params cross to the port and back unchanged."""
    jax_wf, params, wf, _ = _pair(family, seed=3)
    ours = interop.params_to_numpy(wf.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(ours) == jax.tree.structure(params)
    jax.tree.map(lambda a, b: (np.testing.assert_array_equal(a.shape, b.shape),
                               np.testing.assert_equal(a.dtype, b.dtype)),
                 ours, params)
    assert all(np.isfinite(x).all() for x in jax.tree.leaves(ours))
    amp = wf.apply(interop.params_from_numpy(ours, 'cpu'),
                   torch.tensor(_configs(4, 8)))
    assert bool(torch.isfinite(amp.log).all())
    back = interop.params_to_numpy(interop.params_from_numpy(params, 'cpu'))
    jax.tree.map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize('family', sorted(FAMILIES), indirect=True)
def test_dense_sr_update_matches_jax(family):
    config = family.replace(
        wavefunction_optimizer_type='SR', sr_solver='dense',
        sr_diag_shift=0.1, sr_delta_clip=10.0, optimizer='gradient',
        learning_rates=[0.05], learning_rate_stops=[])
    jax_wf, params, wf, tparams = _pair(config, seed=5)
    configs = _configs(6, 48)
    jax_opt = JaxSR(jax_wf, jax_hamiltonian(config), config)
    e_loc = np.asarray(jax_opt.hamiltonian.local_value(jax_wf, params,
                                                       configs))
    new_jax, _, res_jax, grad_jax = jax.jit(jax_opt.update_from_samples)(
        params, jax_opt.optax_opt.init(params), jnp.zeros((), jnp.int32),
        jnp.asarray(configs), jnp.asarray(e_loc))
    opt = StochasticReconfiguration(wf, build_hamiltonian(config), config)
    new, _, res, grad = opt.update_from_samples(
        tparams, opt.sgd.init(tparams), 0, torch.tensor(configs),
        torch.tensor(e_loc))
    g_max = max(float(np.max(np.abs(x))) for x in jax.tree.leaves(grad_jax))
    g_norm = float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                               for x in jax.tree.leaves(grad_jax))))
    jax.tree.map(lambda x, y: _close(x, y, 'grad', 1e-4, 1e-5 * g_max),
                 interop.params_to_numpy(grad), jax.device_get(grad_jax))
    jax.tree.map(lambda x, y: _close(x, y, 'params', 1e-4, 1e-6),
                 interop.params_to_numpy(new), jax.device_get(new_jax))
    assert abs(float(res) - float(res_jax)) <= 1e-4 * (1 + g_norm)


def test_pairing_submatrix_is_exact():
    """Rows at the up sites, columns at the down sites, both ascending,
    for a shared and a per-sample pairing matrix, equal to the JAX
    package's entry for entry."""
    rng = np.random.default_rng(7)
    configs = _configs(8, 12)
    shared = rng.standard_normal((1, N, N)).astype(np.float32)
    batched = rng.standard_normal((12, N, N)).astype(np.float32)
    for pairing in (shared, batched):
        ours = determinant.pairing_submatrix(torch.tensor(pairing),
                                             torch.tensor(configs))
        ref = jax_determinant.pairing_submatrix(
            jnp.broadcast_to(pairing, (12, N, N)), jnp.asarray(configs))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    up = [i for i in range(N) if configs[0, i] > 0]
    down = [i for i in range(N) if configs[0, i] < 0]
    np.testing.assert_array_equal(ours[0].numpy(), batched[0][up][:, down])
    for cls in (determinant.ProjectedBDG, determinant.FullyConnectedNNB):
        with pytest.raises(ValueError, match='even'):
            cls(7) if cls is determinant.ProjectedBDG else cls(7, 1, 4)
    with pytest.raises(ValueError, match='3 sites'):
        models.MatrixProductState(2, 2)


def test_gnn_adjacency_sources():
    """No adjacency file: the list comes from the config's bonds (the chain,
    or the square lattice when size_x·size_y = N); with a file, from it."""
    chain = models.build_wavefunction(Config(
        num_sites=N, wavefunction_type='gnn', **_CONV))
    np.testing.assert_array_equal(
        chain.adj, lattice.adjacency_from_bonds(lattice.chain_bonds(N), N))
    square = models.build_wavefunction(Config(
        num_sites=N, size_x=2, size_y=4, wavefunction_type='gnn', **_CONV))
    assert square.adj.shape[1] > chain.adj.shape[1]


def test_wavefunction_algebra_operators():
    """wf_a + wf_b, wf_a - wf_b, wf_a * wf_b and c * wf on raw amplitudes,
    with params {'a': ..., 'b': ...}."""
    config = Config(num_sites=N, wavefunction_type='fully_connected',
                    output_activation='tanh', **_FC)
    wf_a = models.build_wavefunction(config)
    wf_b = models.build_wavefunction(config.replace(wavefunction_type='mps'))
    generator = torch.Generator().manual_seed(2)
    configs = torch.tensor(_configs(9, 16))
    from cgs_vmc_tpu_torch.ops import logamp
    for build, combine, cls in (
            (lambda: wf_a + wf_b, lambda a, b: a + b, SumOfWavefunctions),
            (lambda: wf_a - wf_b, lambda a, b: a - b, SumOfWavefunctions),
            (lambda: wf_a * wf_b, lambda a, b: a * b,
             ProductOfWavefunctions)):
        wf = build()
        assert isinstance(wf, cls)
        params = wf.init(generator)
        assert set(params) == {'a', 'b'}
        expected = combine(
            logamp.to_value(wf_a.apply(params['a'], configs)),
            logamp.to_value(wf_b.apply(params['b'], configs)))
        torch.testing.assert_close(logamp.to_value(wf.apply(params, configs)),
                                   expected, rtol=1e-5, atol=1e-6)
    for scaled in (wf_a * -2.5, -2.5 * wf_a):
        assert isinstance(scaled, ScaledWavefunction)
        params = scaled.init(generator)
        torch.testing.assert_close(
            logamp.to_value(scaled.apply(params, configs)),
            -2.5 * logamp.to_value(wf_a.apply(params, configs)),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('wf_type', ['made', 'pixelcnn', 'transformer'])
def test_unported_types_still_raise(wf_type):
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        models.build_wavefunction(Config(num_sites=N,
                                         wavefunction_type=wf_type))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        models.build_wavefunction(Config(
            num_sites=N, wavefunction_type='prod',
            composite_wavefunction_types=('jastrow', wf_type)))
