"""The port's measurement layer against the JAX package, on the CPU: the
observables, the lattice helpers they take their pairs and signs from, the
Rényi-2 swap estimator, the Lanczos-step moments and algebra, and every
form of `cli eval --observable`.

Inputs are made with numpy from a seed (JAX-initialized params perturbed
with numpy noise, Sz=0 chains from permutations) and carried over with
`interop`.  Tolerances: local values, swap values and moment estimators
rtol 1e-5 / atol 1e-5 (float32, the same sums in another order; a moment
of order p is compared relative to its scale); the float64 numpy Lanczos
algebra bit for bit on the same [n, 4] array; `exact_lanczos` rtol 1e-4
against the JAX package and 5e-4 against dense ED (tests/test_lanczos.py's
bound); Monte Carlo estimates within 5 of their errors of the exact value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu import basis as jax_basis
from cgs_vmc_tpu import lattice as jax_lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops import heisenberg as jax_heisenberg
from cgs_vmc_tpu.ops import lanczos as jax_lanczos
from cgs_vmc_tpu.ops import observables as jax_obs
from cgs_vmc_tpu.ops import renyi as jax_renyi
from cgs_vmc_tpu_torch import basis, cli, lattice, models
from cgs_vmc_tpu_torch.evaluate import evaluate_operator, exact_expectation
from cgs_vmc_tpu_torch.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.ops import lanczos, observables, renyi
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
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
_ANSATZ = {
    'rbm': dict(wavefunction_type='rbm', num_fc_layers=0, fc_layer_size=8),
    'complex': dict(wavefunction_type='complex',
                    composite_wavefunction_types=('rbm', 'fully_connected'),
                    num_fc_layers=1, fc_layer_size=6),
}


def _problem(kind, n_sites=N, seed=0, chains=CHAINS, **geometry):
    """(JAX wf, port wf, numpy params, port params, numpy Sz=0 configs)."""
    config = Config(num_sites=n_sites, heisenberg_jx=-1.0, **geometry,
                    **_ANSATZ[kind])
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    template = np.repeat([1.0, -1.0], n_sites // 2)
    configs = np.stack([rng.permutation(template) for _ in range(chains)]
                       ).astype(np.float32)
    return (jax_wf, models.build_wavefunction(config), params,
            interop.params_from_numpy(params, 'cpu'), configs)


def _close(got, want, rtol=1e-5, atol=1e-5, err_msg=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=err_msg)


def _operators(pkg, n_sites, size_x, size_y, chunk):
    """The same observables built by the JAX package (pkg='jax') or the
    port, with mixed pair signs and the Marshall-gauged S²."""
    mod, lat = ((jax_obs, jax_lattice) if pkg == 'jax'
                else (observables, lattice))
    pairs = lat.displacement_pairs(n_sites, size_x, size_y, 1, 1)
    sub = lat.marshall_sublattice(n_sites, size_x, size_y)
    signs = np.where(np.arange(n_sites) % 3 == 0, -1.0, 1.0)
    pos = (mod.square_positions(size_x, size_y) if size_y > 1
           else mod.chain_positions(n_sites))
    q = [0.5 * np.pi] * pos.shape[1]
    return {
        'szsz': mod.SzSzCorrelation(pairs),
        'sq': mod.SpinStructureFactor(q, pos),
        'transverse': mod.TransverseCorrelation(pairs, sample_chunk=chunk),
        'transverse_signs': mod.TransverseCorrelation(
            pairs, sample_chunk=chunk, pair_signs=signs),
        'total_spin2': mod.TotalSpinSquared(n_sites, sample_chunk=chunk),
        'total_spin2_gauged': mod.TotalSpinSquared(
            n_sites, sample_chunk=chunk, sublattice=sub),
        'staggered_m2': mod.StaggeredMagnetizationSquared(sub),
    }


@pytest.mark.parametrize('chunk', [0, 5])
@pytest.mark.parametrize('geometry', [
    dict(), dict(size_x=4, size_y=4)], ids=['chain8', 'square4x4'])
@pytest.mark.parametrize('kind', sorted(_ANSATZ))
def test_local_values_match_jax(kind, geometry, chunk):
    n_sites = 16 if geometry else N
    size_x, size_y = geometry.get('size_x', 1), geometry.get('size_y', 1)
    jax_wf, wf, np_params, params, configs = _problem(
        kind, n_sites, seed=3, **geometry)
    want = _operators('jax', n_sites, size_x, size_y, chunk)
    got = _operators('port', n_sites, size_x, size_y, chunk)
    for name, op in got.items():
        value = op.local_value(wf, params, torch.as_tensor(configs))
        ref = want[name].local_value(jax_wf, np_params, jnp.asarray(configs))
        assert value.shape == (CHAINS,), name
        _close(value, ref, err_msg=name)


@pytest.mark.parametrize('n_sites, size_x, size_y', [
    (8, 1, 1), (16, 4, 4), (12, 3, 4), (10, 1, 10), (12, 12, 1),
    (9, 3, 3)])
def test_lattice_helpers_equal_jax(n_sites, size_x, size_y):
    for dx, dy in ((0, 0), (1, 0), (1, 2), (-1, 3), (5, -2)):
        np.testing.assert_array_equal(
            lattice.displacement_pairs(n_sites, size_x, size_y, dx, dy),
            jax_lattice.displacement_pairs(n_sites, size_x, size_y, dx, dy))
    got = lattice.marshall_sublattice(n_sites, size_x, size_y)
    want = jax_lattice.marshall_sublattice(n_sites, size_x, size_y)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_structure_factor_at_pi_is_n_times_staggered_m2():
    """S(π) on a chain and S(π, π) on the square lattice equal N·m²_stag
    configuration by configuration."""
    for n_sites, size_x, size_y in ((N, 1, 1), (16, 4, 4)):
        _, _, _, _, configs = _problem('rbm', n_sites, seed=5)
        configs = torch.as_tensor(configs)
        if size_y > 1:
            pos, q = observables.square_positions(size_x, size_y), [np.pi] * 2
        else:
            pos, q = observables.chain_positions(n_sites), [np.pi]
        sq = observables.SpinStructureFactor(q, pos)
        m2 = observables.StaggeredMagnetizationSquared(
            lattice.marshall_sublattice(n_sites, size_x, size_y))
        _close(sq.local_value(None, None, configs),
               n_sites * m2.local_value(None, None, configs), atol=1e-6)


def _ed_vector_state(n_sites=N, j_x=1.0):
    e0, v0 = ed.ground_state(n_sites, lattice.chain_bonds(n_sites), j_x=j_x)
    wf = FullVector.for_sector(n_sites, v0.astype(np.float32))
    return e0, v0, wf, wf.init(torch.Generator())


def test_su2_identity_and_singlet_on_the_ed_state():
    """Exact sums on the ED ground state: <SxSx+SySy> = 2<SzSz> (SU(2)),
    and <S²> = 0 in the bare basis and, with the sublattice correction,
    for the Marshall-gauged state."""
    _, _, wf, params = _ed_vector_state()
    for d in (1, 2, 3):
        pairs = lattice.displacement_pairs(N, 1, 1, d)
        perp = exact_expectation(
            wf, params, observables.TransverseCorrelation(pairs), N)
        zz = exact_expectation(wf, params,
                               observables.SzSzCorrelation(pairs), N)
        np.testing.assert_allclose(perp, 2.0 * zz, rtol=1e-3, atol=1e-6)
    assert abs(exact_expectation(
        wf, params, observables.TotalSpinSquared(N), N)) < 5e-4
    _, _, wfg, paramsg = _ed_vector_state(j_x=-1.0)
    gauged = observables.TotalSpinSquared(
        N, sublattice=lattice.marshall_sublattice(N))
    assert abs(exact_expectation(wfg, paramsg, gauged, N)) < 5e-4
    assert abs(exact_expectation(
        wfg, paramsg, observables.TotalSpinSquared(N), N)) > 0.5


def test_mc_observables_match_ed():
    """evaluate_operator (generic sampler) of SzSz and the transverse
    correlator at d = 1 on the ED state, within 5 errors of the exact
    expectation (tests/test_observables.py's bar)."""
    _, _, wf, params = _ed_vector_state()
    config = Config(num_sites=N, batch_size=256,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=60)
    pairs = lattice.displacement_pairs(N, 1, 1, 1)
    for op, floor in ((observables.SzSzCorrelation(pairs), 1e-4),
                      (observables.TransverseCorrelation(pairs), 1e-3)):
        exact = exact_expectation(wf, params, op, N)
        result = evaluate_operator(wf, params, op, config, 'cpu', seed=4)
        assert abs(result.mean - exact) < 5 * max(result.error, floor)


@pytest.mark.parametrize('kind', sorted(_ANSATZ))
def test_swap_values_match_jax(kind):
    jax_wf, wf, np_params, params, configs = _problem(kind, seed=7,
                                                      chains=2 * CHAINS)
    x, y = configs[:CHAINS], configs[CHAINS:]
    # Some pairs keep the region's Sz (kept), others do not (zeroed).
    for region in ([0, 1, 2], [1, 4], list(range(N // 2))):
        got = renyi.swap_values(wf, params, torch.as_tensor(x),
                                torch.as_tensor(y),
                                renyi.region_mask(N, region))
        want = jax_renyi.swap_values(jax_wf, np_params, jnp.asarray(x),
                                     jnp.asarray(y),
                                     jax_renyi.region_mask(N, region))
        _close(got, want)
        assert (np.asarray(got) == 0).any() and (np.asarray(got) != 0).any()
    np.testing.assert_array_equal(renyi.region_mask(N, [0, 3]),
                                  jax_renyi.region_mask(N, [0, 3]))


def test_exact_renyi2_equals_jax_and_the_swap_double_sum():
    """exact_renyi2 equals the JAX package's for a real and a complex
    vector, and the |psi|²-weighted double sum of swap values over the
    whole sector is tr(rho_A²)."""
    states = basis.enumerate_sz_basis(N)
    rng = np.random.default_rng(2)
    vec = rng.normal(size=states.shape[0])
    cvec = vec * np.exp(1j * rng.uniform(-2, 2, size=vec.shape))
    for v in (vec, cvec):
        for region in ([0], [0, 1, 2], [1, 3, 5, 7]):
            assert renyi.exact_renyi2(v, states, region) == \
                jax_renyi.exact_renyi2(v, states, region)
    _, v0, wf, params = _ed_vector_state()
    p = v0 ** 2 / np.sum(v0 ** 2)
    t_states = torch.as_tensor(states)
    dim = states.shape[0]
    region = [0, 1, 2]
    values = renyi.swap_values(
        wf, params, t_states.repeat_interleave(dim, dim=0),
        t_states.repeat(dim, 1), renyi.region_mask(N, region)).numpy()
    swap_mean = float(np.sum((p[:, None] * p[None, :]).reshape(-1) * values))
    np.testing.assert_allclose(
        swap_mean, np.exp(-renyi.exact_renyi2(v0, states, region)),
        rtol=1e-4)


def _hamiltonians(chunk, n_sites=N):
    bonds = lattice.chain_bonds(n_sites)
    return (jax_heisenberg.HeisenbergHamiltonian(bonds, -1.0, 1.0,
                                                 sample_chunk=chunk),
            HeisenbergHamiltonian(bonds, -1.0, 1.0, sample_chunk=chunk))


@pytest.mark.parametrize('shift', [0.0, -3.2])
@pytest.mark.parametrize('kind', sorted(_ANSATZ))
def test_moment_local_values_match_jax(kind, shift):
    """The four moment estimators at rtol 1e-5 (each relative to its own
    scale), with the operator's inner sample_chunk off and on (the same
    numbers either way)."""
    jax_wf, wf, np_params, params, configs = _problem(kind, seed=11)
    results = []
    for chunk in (0, 7):
        jax_ham, ham = _hamiltonians(chunk)
        got = lanczos.moment_local_values(ham, wf, params,
                                          torch.as_tensor(configs),
                                          shift=shift)
        want = jax_lanczos.moment_local_values(
            jax_ham, jax_wf, np_params, jnp.asarray(configs), shift=shift)
        for g, w in zip(got, want):
            scale = float(np.max(np.abs(np.asarray(w))))
            _close(g, w, rtol=1e-5, atol=1e-5 * max(scale, 1.0))
        results.append([g.numpy() for g in got])
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_lanczos_algebra_bit_identical():
    """optimal_alpha, lanczos_energy/variance, _block_jackknife and
    result_from_values: float64 numpy, the same numbers bit for bit."""
    rng = np.random.default_rng(17)
    for n, shift in ((1, 0.0), (2, 0.0), (40, 0.0), (64, -3.5), (200, 7.0)):
        e = rng.normal(-1.0, 0.3, size=n)
        values = np.stack([e, e ** 2 + 0.1, e ** 3 - 0.05 * e,
                           e ** 4 + 0.2], axis=1)
        got = lanczos.result_from_values(values, 0.5, shift)
        want = jax_lanczos.result_from_values(values, 0.5, shift)
        for field in want._fields:
            a, b = getattr(got, field), getattr(want, field)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)
        assert got.alpha_physical == want.alpha_physical
        h = tuple(values.mean(axis=0))
        for floor in (0.0, 1e-3):
            assert (lanczos.optimal_alpha(h, floor)
                    == jax_lanczos.optimal_alpha(h, floor))
        if n > 1:
            assert (lanczos._block_jackknife(values, 1e-4)
                    == jax_lanczos._block_jackknife(values, 1e-4))
    for h in ((1.0, 1.0, 1.0, 1.0), (-2.0, 4.5, -9.0, 21.0),
              (0.0, 1.0, 0.0, 1.0)):
        assert lanczos.optimal_alpha(h) == jax_lanczos.optimal_alpha(h)
        for alpha in (-0.3, 0.0, 0.2):
            assert (lanczos.lanczos_energy(alpha, h)
                    == jax_lanczos.lanczos_energy(alpha, h))
            assert (lanczos.lanczos_variance(alpha, h)
                    == jax_lanczos.lanczos_variance(alpha, h))


def _dense_h():
    return np.asarray(ed.heisenberg_matrix(N, lattice.chain_bonds(N), -1.0,
                                           1.0, sparse=False), np.float64)


@pytest.mark.parametrize('shift', [0.0, -3.0])
def test_exact_lanczos_matches_jax_and_dense_ed(shift):
    """exact_lanczos on a perturbed ED state and on an RBM, against the JAX
    package (rtol 1e-4) and E(alpha) against the dense Rayleigh quotient of
    (1 + alpha H)psi (as tests/test_lanczos.py)."""
    e_exact, v0 = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    vec = v0 + 0.08 * np.random.default_rng(7).normal(size=v0.shape)
    from cgs_vmc_tpu.models import FullVector as JaxFullVector
    jax_wf = JaxFullVector.for_sector(N, vec.astype(np.float32))
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    jax_ham, ham = _hamiltonians(0)
    got = lanczos.exact_lanczos(wf, wf.init(torch.Generator()), ham, N,
                                energy_shift=shift)
    want = jax_lanczos.exact_lanczos(jax_wf, jax_wf.init(jax.random.key(0)),
                                     jax_ham, N, energy_shift=shift)
    for field in ('e0', 'energy', 'variance0', 'variance_alpha',
                  'extrapolated'):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-4, atol=1e-6, err_msg=field)
    np.testing.assert_allclose(got.alpha_physical, want.alpha_physical,
                               rtol=1e-3)
    h_dense = _dense_h()
    unshifted = lanczos.exact_lanczos(wf, wf.init(torch.Generator()), ham, N)
    for alpha in (-0.3, -0.05, 0.02, 0.2):
        psi_a = vec + alpha * (h_dense @ vec)
        rayleigh = float(psi_a @ h_dense @ psi_a / (psi_a @ psi_a))
        np.testing.assert_allclose(
            lanczos.lanczos_energy(alpha, unshifted.moments), rayleigh,
            rtol=5e-4)
    assert e_exact - 1e-6 <= got.energy <= got.e0 - 1e-6

    jax_wf, rbm, np_params, params, _ = _problem('rbm', seed=13)
    got = lanczos.exact_lanczos(rbm, params, ham, N, batch=20)
    want = jax_lanczos.exact_lanczos(jax_wf, np_params, jax_ham, N)
    np.testing.assert_allclose(got.moments, want.moments, rtol=1e-4)
    np.testing.assert_allclose(got.energy, want.energy, rtol=1e-4)


def test_exact_lanczos_eigenstate_fixed_point():
    e_exact, _, wf, params = _ed_vector_state(j_x=-1.0)
    res = lanczos.exact_lanczos(wf, params, _hamiltonians(0)[1], N)
    assert res.alpha == 0.0
    np.testing.assert_allclose(res.energy, e_exact, rtol=1e-5)


def test_mc_lanczos_matches_exact():
    """evaluate_lanczos (chunked, the automatic shift) on a perturbed ED
    state agrees with exact_lanczos within 5 jackknife errors (and a floor
    of 0.02, tests/test_lanczos.py's bar)."""
    e_exact, v0 = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    vec = v0 + 0.1 * np.random.default_rng(11).normal(size=v0.shape)
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    params = wf.init(torch.Generator())
    ham = _hamiltonians(0)[1]
    exact = lanczos.exact_lanczos(wf, params, ham, N)
    config = Config(num_sites=N, batch_size=256,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=64, seed=2)
    res = lanczos.evaluate_lanczos(wf, params, ham, config, 'cpu',
                                   sample_chunk=64, energy_shift='auto')
    assert 0.0 < res.acceptance_rate <= 1.0
    assert abs(res.e0 - exact.e0) < max(5 * res.e0_err, 0.02)
    assert abs(res.energy - exact.energy) < max(5 * res.energy_err, 0.02)
    assert res.energy <= res.e0


def _value(out: str, label: str) -> float:
    return float(out.split(label)[1].split(' +/- ')[0])


@pytest.fixture(scope='module')
def rbm_runs(tmp_path_factory):
    """A 3-epoch SR run of an RBM on the N=8 chain (jx = -1) and a 1-epoch
    run on the 4x4 square lattice."""
    from cgs_vmc_tpu_torch.train import train
    runs = {}
    for name, geometry, epochs in (('chain', dict(num_sites=N), 3),
                                   ('square', dict(num_sites=16, size_x=4,
                                                   size_y=4), 1)):
        config = Config(
            **geometry, wavefunction_type='rbm', num_fc_layers=0,
            fc_layer_size=16, batch_size=64, num_epochs=epochs,
            wavefunction_optimizer_type='SR', heisenberg_jx=-1.0,
            optimizer='gradient', learning_rates=[5e-2],
            learning_rate_stops=[], num_evaluation_samples=8,
            num_equilibration_sweeps=2,
            checkpoint_dir=str(tmp_path_factory.mktemp(name)))
        train(config, 'cpu')
        runs[name] = config.checkpoint_dir
    return runs


def _eval(run_dir, observable, capsys):
    capsys.readouterr()
    rc = cli.main(['eval', '--device', 'cpu', '--checkpoint_dir', run_dir,
                   '--observable', observable])
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def test_cli_eval_every_observable(rbm_runs, capsys):
    chain = rbm_runs['chain']
    out = {}
    for observable, label in (
            ('energy', 'Energy: '), ('szsz:1', 'SzSz(d=1): '),
            ('transverse:1', 'corrected): '), ('sq:1', 'S(q=1pi): '),
            ('staggered_m2', 'Staggered m^2: '),
            ('total_spin2', 'Total spin S^2: '),
            ('renyi2:0-3', 'S2(sites 0..3): '),
            ('lanczos', 'Lanczos energy E(alpha*): ')):
        rc, text, _ = _eval(chain, observable, capsys)
        assert rc == 0, observable
        out[observable] = _value(text, label)
        assert np.isfinite(out[observable]), observable
    assert 'SxSx+SySy(d=1) physical (Marshall-gauge corrected)' in _eval(
        chain, 'transverse:1', capsys)[1]
    # The same seed gives the same samples: S(π) = N·m²_stag exactly.
    np.testing.assert_allclose(out['sq:1'], N * out['staggered_m2'],
                               rtol=1e-5)
    assert -0.25 < out['szsz:1'] < 0.0 and out['transverse:1'] < 0.0
    rc, text, _ = _eval(chain, 'lanczos', capsys)
    for line in ('Energy <H>: ', 'Lanczos step alpha* (of 1 + aH): ',
                 'Variance: ', 'Zero-variance extrapolation: ',
                 'Acceptance rate: '):
        assert line in text

    square = rbm_runs['square']
    for observable in ('szsz:1;0', 'transverse:0;1', 'sq:1;1'):
        rc, text, _ = _eval(square, observable, capsys)
        assert rc == 0 and np.isfinite(_value(text, ': ')), observable
    assert 'SzSz(d=(1,0))' in _eval(square, 'szsz:1;0', capsys)[1]


@pytest.mark.parametrize('run, observable, message', [
    ('square', 'szsz:1', 'needs a displacement VECTOR dx;dy'),
    ('square', 'transverse:2', 'needs a displacement VECTOR dx;dy'),
    ('chain', 'szsz:1;1', 'a chain takes a scalar offset'),
    ('chain', 'sq:1;1', 'S(q) needs 1 momentum component(s)'),
    ('square', 'sq:1', 'S(q) needs 2 momentum component(s)'),
    ('chain', 'magnetization', "Unknown observable 'magnetization'"),
])
def test_cli_eval_error_exits(rbm_runs, capsys, run, observable, message):
    rc, text, err = _eval(rbm_runs[run], observable, capsys)
    assert rc == 1 and message in err and not text
