"""The port's CUDA kernels against their plain torch versions, on a card,
and one epoch of the complex-phase path, of each incremental sampler, of
the exact autoregressive sampler, multiple-try Metropolis, parallel
tempering and the transverse-field Ising model there; the deterministic
holds of the transformer and MADE artifacts, card against host; the
measurement and dynamics layer's deterministic holds (observables, swap
values and Lanczos moments card against host, the Lanczos fixed point, the
full-basis quench against expm, coupled linear-response chains) and one
epoch of each excited-state optimizer with its K2 launches; the EMA slot
and its resume, the profiler trace naming K2, the params-only writer and
the world-1 NCCL path (chip_smoke.py phases 31-34); `entry()` card against
host and the bench's sweep reps (phases 35-36); both kernels against
their lane-order witnesses bit for bit, and the fast Jacobian rows against
the vmap rows on the card (phases 3-4, 36-37).

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one.  The file imports no jax, so on a machine without JAX it runs
without the suite's conftest (which imports jax):

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from cgs_vmc_tpu_torch.sampler import kernels
from cgs_vmc_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    return torch.device('cuda')


def _inputs(n_sites, hidden, chains, seed, device, n_steps=None,
            stray=0.0):
    """RBM weights, Sz=0 configs and K1's draws; a `stray` share of the
    picks lies outside [0, n_sites // 2) (a rejected no-op move)."""
    rng = np.random.default_rng(seed)
    w, b, a = (torch.tensor(0.1 * rng.standard_normal(shape),
                            dtype=torch.float32, device=device)
               for shape in ((n_sites, hidden), (hidden,), (n_sites,)))
    template = np.repeat([1.0, -1.0], n_sites // 2)
    configs = torch.tensor(
        np.stack([rng.permutation(template) for _ in range(chains)]),
        dtype=torch.float32, device=device)
    n_steps = 2 * n_sites if n_steps is None else n_steps
    picks = rng.integers(0, n_sites // 2, size=(n_steps, chains, 2))
    out = rng.random(picks.shape) < stray
    picks[out] = rng.choice([-1, n_sites // 2, n_sites], size=out.sum())
    picks = torch.tensor(picks, dtype=torch.int32, device=device)
    log_u = torch.tensor(np.log(rng.random((n_steps, chains))),
                         dtype=torch.float32, device=device)
    return w, b, a, configs, picks, log_u


def _assert_agree(out, ref, chains):
    """At least 99.9% of chains identical (a warp reduction sums Σ_h in
    another order than torch.sum, which can flip a move sitting exactly on
    the accept threshold); logψ within 1e-4 on those chains."""
    same = ((out.configs == ref.configs).all(dim=1)
            & (out.num_accepted == ref.num_accepted))
    assert int((~same).sum()) <= 0.001 * chains
    torch.testing.assert_close(out.log_amp[same], ref.log_amp[same],
                               rtol=1e-4, atol=1e-4)
    assert (out.configs.sum(dim=1) == 0).all()


# (n_sites, hidden): the bench shape, the slice shape, and the largest the
# kernels take, whose W no longer fits the staged shared memory.
SHAPES = [(36, 64), (40, 160), (256, 512)]


@pytest.mark.parametrize('n_sites,hidden', SHAPES)
def test_streamed_kernel_matches_plain(cuda, n_sites, hidden):
    chains = 2048 if n_sites <= 40 else 256
    w, b, a, configs, picks, log_u = _inputs(n_sites, hidden, chains, 1,
                                             cuda)
    before = profiling.counter('k1.launches')
    out = kernels.rbm_sweeps(w, b, a, configs, picks, log_u)
    ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    torch.cuda.synchronize()
    assert profiling.counter('k1.launches') == before + 1
    _assert_agree(out, ref, chains)


@pytest.mark.parametrize('n_sites,hidden', SHAPES)
def test_philox_kernel_matches_plain(cuda, n_sites, hidden):
    chains = 2048 if n_sites <= 40 else 256
    w, b, a, configs, _, _ = _inputs(n_sites, hidden, chains, 2, cuda)
    seed = torch.tensor([77], dtype=torch.int64, device=cuda)
    before = profiling.counter('k2.launches')
    out = kernels.rbm_sweeps_prng(w, b, a, configs, 2 * n_sites, seed)
    ref = kernels.rbm_sweeps_prng_plain(w, b, a, configs, 2 * n_sites, seed)
    torch.cuda.synchronize()
    assert profiling.counter('k2.launches') == before + 1
    _assert_agree(out, ref, chains)


@pytest.mark.parametrize('n_sites,hidden', SHAPES)
def test_kernels_equal_their_lane_order_witnesses(cuda, n_sites, hidden):
    """K1 and K2 at every width they take against the witness that sums
    Σ_h in their order: every output bit for bit on every chain."""
    chains = 2048 if n_sites <= 40 else 256
    w, b, a, configs, picks, log_u = _inputs(n_sites, hidden, chains, 6,
                                             cuda, stray=0.05)
    theta = configs @ w + b
    seed = torch.tensor([2 ** 31 + 6], dtype=torch.int64, device=cuda)
    n_steps = picks.shape[0]
    for lanes in kernels.LANES:
        if -(-hidden // lanes) > kernels.MAX_UNITS_PER_LANE:
            continue
        pairs = (
            (kernels._rbm_sweeps(w, b, a, configs, picks, log_u, lanes),
             kernels.rbm_sweeps_lanes_plain(w, b, a, configs, theta, picks,
                                            log_u, lanes)),
            (kernels._rbm_sweeps_prng(w, b, a, configs, n_steps, seed,
                                      lanes),
             kernels.rbm_sweeps_prng_lanes_plain(w, b, a, configs, theta,
                                                 n_steps, seed, lanes)))
        for out, ref in pairs:
            assert all(torch.equal(x, y) for x, y in zip(out, ref))


def test_fast_jacobian_rows_on_the_card(cuda):
    """The symmetrized conv's fast rows on the card against its vmap rows
    there, at the JAX test's tolerance, on params moved off init (at init
    the zero biases put relu inputs exactly on the kink wherever a conv
    reads only zeros, and cuDNN's rounding there picks another
    subgradient than the GEMM's)."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.optim import fast_jacobian
    from cgs_vmc_tpu_torch.optim.sr import flatten_params, jacobian_rows
    from cgs_vmc_tpu_torch.utils.device import resolve_device
    resolve_device(cuda)            # TF32 off, as every entry point has it
    config = Config(num_sites=36, size_x=6, size_y=6,
                    wavefunction_type='conv_2d', num_conv_layers=3,
                    num_conv_filters=8, kernel_size=3, symmetrize=True)
    wf = models.build_wavefunction(config)
    generator = torch.Generator(device=cuda).manual_seed(0)
    params = tree_map(lambda x: x + 0.05 * torch.randn(
        x.shape, generator=generator, device=cuda),
        wf.init(generator))
    w, b, a, configs, _, _ = _inputs(36, 4, 64, 7, cuda)
    flat, unflatten = flatten_params(params)
    want = jacobian_rows(
        lambda p, c: wf.apply(unflatten(p), c[None, :]).log[0], flat,
        configs, 0)
    got = fast_jacobian.rows_fn_for(wf)(params, configs, 16)
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= 3e-5 * scale + 2e-4 * want.abs())
                .all())


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, b, a, configs, picks, log_u = _inputs(40, 160, 64, 3, cuda)
    with pytest.raises(ValueError, match='n_sites'):
        big = torch.ones((64, 258), device=cuda)
        kernels.rbm_sweeps_prng(torch.zeros((258, 8), device=cuda),
                                torch.zeros(8, device=cuda),
                                torch.zeros(258, device=cuda), big, 4, 0)
    with pytest.raises(ValueError, match='contiguous'):
        kernels.rbm_sweeps(w, b, a, configs, picks, log_u.t().contiguous().t())


# Every width the kernels are built for, at the bench and slice shapes.
@pytest.mark.parametrize('lanes', kernels.LANES)
@pytest.mark.parametrize('n_sites,hidden', SHAPES[:2])
def test_forced_widths_match_plain(cuda, n_sites, hidden, lanes):
    chains = 2048
    w, b, a, configs, picks, log_u = _inputs(n_sites, hidden, chains, 4,
                                             cuda)
    seed = torch.tensor([91], dtype=torch.int64, device=cuda)
    out = kernels._rbm_sweeps(w, b, a, configs, picks, log_u, lanes)
    _assert_agree(out, kernels.rbm_sweeps_plain(w, b, a, configs, picks,
                                                log_u), chains)
    n_steps = picks.shape[0]
    out = kernels._rbm_sweeps_prng(w, b, a, configs, n_steps, seed, lanes)
    _assert_agree(out, kernels.rbm_sweeps_prng_plain(w, b, a, configs,
                                                     n_steps, seed), chains)


# The edges of the layout: one bitmask word and eight, one unit (whole
# lanes empty), 33 units (a ragged last slot), 512 (W through L2), a
# partial warp (3 chains) and one chain past a whole number of warps
# (2049), no steps, and G + 1 steps (a ragged last draw block).
EDGES = [(n_sites, hidden, chains) for n_sites in (2, 256)
         for hidden in (1, 33, 512) for chains in (3, 2049)]


@pytest.mark.parametrize('n_sites,hidden,chains', EDGES)
def test_edge_shapes_match_plain(cuda, n_sites, hidden, chains):
    seed = torch.tensor([5], dtype=torch.int64, device=cuda)
    for lanes in kernels.LANES:
        if -(-hidden // lanes) > kernels.MAX_UNITS_PER_LANE:
            continue
        for n_steps in (0, lanes + 1):
            w, b, a, configs, picks, log_u = _inputs(
                n_sites, hidden, chains, lanes + n_steps, cuda, n_steps,
                stray=0.05)
            out = kernels._rbm_sweeps(w, b, a, configs, picks, log_u, lanes)
            ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
            torch.cuda.synchronize()
            _assert_agree(out, ref, chains)
            out = kernels._rbm_sweeps_prng(w, b, a, configs, n_steps, seed,
                                           lanes)
            ref = kernels.rbm_sweeps_prng_plain(w, b, a, configs, n_steps,
                                                seed)
            torch.cuda.synchronize()
            _assert_agree(out, ref, chains)
            if n_steps == 0:
                assert torch.equal(out.configs, configs)
                assert not out.num_accepted.any()


def test_branch_free_log1p_is_log1pf(cuda):
    """Every float of [0, 1], the range exp(-2|x|) takes: the kernels'
    log1p agrees with the library's log1pf bit for bit."""
    assert kernels.log1p_mismatches(cuda) == 0


def test_rule_and_launch_checks(cuda):
    for hidden in (1, 33, 64, 160, 512):
        lanes = kernels.instance(36, hidden)[0]
        assert lanes in kernels.LANES
        assert -(-hidden // lanes) <= kernels.MAX_UNITS_PER_LANE
    w, b, a, configs, picks, log_u = _inputs(36, 64, 8, 6, cuda)
    with pytest.raises(ValueError, match='lanes_per_chain'):
        kernels._rbm_sweeps(w, b, a, configs, picks, log_u, 8)
    # Sixteen lanes cannot hold 512 units (32 a lane > 16): refused.
    w, b, a, configs, picks, log_u = _inputs(36, 512, 8, 6, cuda)
    with pytest.raises(ValueError, match='units a lane'):
        kernels._rbm_sweeps(w, b, a, configs, picks, log_u, 16)


def test_instance_is_the_fixed_rule(cuda):
    """rbm_sweep_instance, called with its four arguments, gives the rule
    of csrc/rbm_sweep.cu: 16 lanes a chain up to 256 hidden units, else 32
    (or the lanes asked for); the power of two of bitmask words that holds
    the sites; the fewest unit slots of (2, 4, 5, 8, 10, 16) that hold a
    lane's units.  A shape with no such instance raises."""
    for n_sites, hidden, lanes in ((36, 1, 0), (40, 33, 0), (100, 256, 0),
                                   (256, 257, 0), (36, 64, 32),
                                   (129, 160, 16), (36, 512, 0)):
        g = lanes or (16 if hidden <= 256 else 32)
        words = 1
        while words * 32 < n_sites:
            words *= 2
        slots = min(s for s in (2, 4, 5, 8, 10, 16) if s >= -(-hidden // g))
        assert kernels.instance(n_sites, hidden, lanes) == (g, words, slots)
    for n_sites, hidden, lanes in ((36, 513, 0), (36, 512, 16), (1, 8, 0),
                                   (257, 8, 0), (36, 8, 8)):
        with pytest.raises(RuntimeError, match='rbm_sweep_instance'):
            kernels.instance(n_sites, hidden, lanes)


def _rbm_config(name, n_sites, hidden, chains):
    from cgs_vmc_tpu_torch.config import Config
    return Config(num_sites=n_sites, wavefunction_type='rbm',
                  num_fc_layers=0, fc_layer_size=hidden, batch_size=chains,
                  num_batches_per_epoch=4, num_equilibration_sweeps=10,
                  num_monte_carlo_sweeps=1, heisenberg_jx=-1.0,
                  optimizer='adam', learning_rates=[1e-3],
                  learning_rate_stops=[], wavefunction_optimizer_type=name)


def test_itswo_epoch_launches_k2(cuda):
    """One ITSWO epoch at the chain40 shape (N=40, H=160, 2048 chains): K2
    once for equilibration and once a batch; finite metrics; ω and the
    EMA scalars on the card."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.optim import ImaginaryTimeSWO
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = _rbm_config('ITSWO', 40, 160, 2048)
    opt = ImaginaryTimeSWO(models.build_wavefunction(config),
                           build_hamiltonian(config), config)
    state = opt.init_state(0, cuda)
    before = profiling.counter('k2.launches')
    state, metrics = opt.epoch(state)
    torch.cuda.synchronize()
    assert profiling.counter('k2.launches') == (
        before + 1 + config.num_batches_per_epoch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.extra['ema_count'].device.type == 'cuda'
    assert state.extra['omega']['hidden']['w'].device.type == 'cuda'


def test_dual_sampling_epoch_launches_k2(cuda):
    """One DualSamplingSWO epoch toward the N=8 ED vector: the RBM student's
    chains on K2 (once a batch), the FullVector target's on the generic
    sampler; finite metrics."""
    from cgs_vmc_tpu_torch import lattice, models
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.optim import DualSamplingSWO
    from cgs_vmc_tpu_torch.utils import ed
    config = _rbm_config('DualSamplingSWO', 8, 16, 512)
    _, v0 = ed.ground_state(8, lattice.chain_bonds(8), j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    opt = DualSamplingSWO(models.build_wavefunction(config),
                          FullVector.for_sector(8, vector), config)
    state = opt.init_state(0, cuda, {'ed_vector': torch.tensor(vector)})
    before = profiling.counter('k2.launches')
    state, metrics = opt.epoch(state)
    torch.cuda.synchronize()
    assert profiling.counter('k2.launches') == (
        before + config.num_batches_per_epoch)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert state.extra['target_sampler'].configs.shape == (256, 8)


def test_complex_sr_epoch_on_the_card(cuda):
    """One dense-SR epoch of complex(rbm x fc) under a boundary twist: the
    sampler state keeps a complex64 log on the card, the energy is a finite
    real number and the parameters stay real and move."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.base import tree_leaves
    from cgs_vmc_tpu_torch.optim import StochasticReconfiguration
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = Config(num_sites=16, wavefunction_type='complex',
                    composite_wavefunction_types=['rbm', 'fully_connected'],
                    num_fc_layers=1, fc_layer_size=48, batch_size=512,
                    num_batches_per_epoch=2, num_equilibration_sweeps=4,
                    heisenberg_jx=-1.0, twist_phi=0.3, sr_solver='dense',
                    optimizer='gradient', learning_rates=[0.05],
                    learning_rate_stops=[],
                    wavefunction_optimizer_type='SR')
    opt = StochasticReconfiguration(models.build_wavefunction(config),
                                    build_hamiltonian(config), config)
    state = opt.init_state(0, cuda)
    before = [p.clone() for p in tree_leaves(state.params)]
    state, metrics = opt.epoch(state)
    torch.cuda.synchronize()
    assert state.sampler.log_amp.dtype == torch.complex64
    assert state.sampler.log_amp.device.type == 'cuda'
    assert not metrics['energy'].is_complex()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    after = tree_leaves(state.params)
    assert all(not p.is_complex() for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize('wf_type,extra,sampler', [
    ('jastrow', {}, 'jastrow_delta'),
    ('pbdg', {}, 'pbdg_sherman_morrison'),
    ('mps', {'mps_incremental_sweeps': True}, 'mps_env'),
])
def test_fast_sampler_epoch_on_the_card(cuda, wf_type, extra, sampler):
    """One SR epoch with each incremental sampler on the card: the registry
    resolves it, the chains stay in the Sz=0 sector and the cached logψ
    equals a fresh forward."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.optim import StochasticReconfiguration
    from cgs_vmc_tpu_torch.sampler import registry
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = Config(num_sites=16, wavefunction_type=wf_type, batch_size=256,
                    num_batches_per_epoch=2, num_equilibration_sweeps=4,
                    heisenberg_jx=-1.0, sr_solver='dense',
                    sr_diag_shift=1e-2, sr_delta_clip=1.0,
                    optimizer='gradient', learning_rates=[0.05],
                    learning_rate_stops=[],
                    wavefunction_optimizer_type='SR', **extra)
    wf = models.build_wavefunction(config)
    assert registry.resolved_name(wf, config) == sampler
    opt = StochasticReconfiguration(wf, build_hamiltonian(config), config)
    state, metrics = opt.epoch(opt.init_state(0, cuda))
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    sampler_state = state.sampler
    assert sampler_state.configs.device.type == 'cuda'
    assert (sampler_state.configs.sum(dim=1) == 0).all()
    # The epoch's sweeps ran under the params before the update; one more
    # sweep under the new ones ends with the sampler's own exact forward.
    sweeps = registry.resolve_sweeps_fn(wf, config)
    sampler_state = sweeps(state.params, sampler_state, 1)
    with torch.no_grad():
        fresh = wf.apply(state.params, sampler_state.configs)
    torch.testing.assert_close(sampler_state.log_amp, fresh.log,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('name,fields', [
    ('heisenberg_6x6_transformer', dict(
        wavefunction_type='transformer', num_attention_layers=4,
        attention_dim=64, num_attention_heads=8, symmetrize=True)),
    ('heisenberg_6x6_made', dict(
        wavefunction_type='made', num_fc_layers=1, fc_layer_size=256)),
])
def test_artifact_log_psi_on_the_card_equals_the_host(cuda, name, fields):
    """The committed transformer and MADE artifacts: logψ of 64 numpy-seeded
    configurations on the card within 1e-4 of the host's."""
    import os
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.utils import checkpoint
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    config = Config(num_sites=36, size_x=6, size_y=6, **fields)
    wf = models.build_wavefunction(config)
    host = checkpoint.restore_params_only(
        os.path.join(repo, 'artifacts', f'{name}.msgpack'),
        wf.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(4)
    template = np.repeat([1.0, -1.0], 18)
    configs = torch.tensor(np.stack([rng.permutation(template)
                                     for _ in range(64)]),
                           dtype=torch.float32)
    with torch.no_grad():
        ref = wf.apply(host, configs).log
        got = wf.apply(tree_map(lambda x: x.to(cuda), host),
                       configs.to(cuda)).log
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('wf_type,extra,sampler', [
    ('made', dict(num_fc_layers=1, fc_layer_size=64),
     'exact_autoregressive'),
    ('pixelcnn', dict(size_x=4, size_y=4, num_conv_layers=2,
                      num_conv_filters=8), 'exact_autoregressive'),
    ('jastrow', dict(mtm_candidates=4), 'mtm'),
    ('jastrow', dict(pt_replicas=3), 'tempering'),
])
def test_new_sampler_epoch_on_the_card(cuda, wf_type, extra, sampler):
    """One EnergyGradient epoch on the card with the exact autoregressive
    sampler (acceptance exactly 1), multiple-try Metropolis and parallel
    tempering: finite metrics, chains in the Sz=0 sector, the cached logψ
    equal to a fresh forward."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
    from cgs_vmc_tpu_torch.sampler import registry
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = Config(num_sites=16, wavefunction_type=wf_type, batch_size=256,
                    num_batches_per_epoch=2, num_equilibration_sweeps=2,
                    heisenberg_jx=-1.0,
                    wavefunction_optimizer_type='EnergyGradient', **extra)
    wf = models.build_wavefunction(config)
    assert registry.resolved_name(wf, config) == sampler
    opt = GROUND_STATE_OPTIMIZERS['EnergyGradient'](
        wf, build_hamiltonian(config), config)
    state, metrics = opt.epoch(opt.init_state(0, cuda))
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    if sampler == 'exact_autoregressive':
        assert float(metrics['acceptance_rate']) == 1.0
    sampler_state = registry.resolve_sweeps_fn(wf, config)(
        state.params, state.sampler, 1)
    assert sampler_state.configs.device.type == 'cuda'
    assert (sampler_state.configs.sum(dim=1) == 0).all()
    with torch.no_grad():
        fresh = wf.apply(state.params, sampler_state.configs)
    torch.testing.assert_close(sampler_state.log_amp, fresh.log,
                               rtol=1e-4, atol=1e-4)


def test_tfim_sr_epoch_on_the_card(cuda):
    """One dense-SR epoch of configs/tfim_chain16_sr.json's model on the
    card: full-space chains under the flip move, finite metrics, and the
    local energies of the card equal the host's at 1e-4."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.optim import StochasticReconfiguration
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = Config(num_sites=16, wavefunction_type='rbm', num_fc_layers=0,
                    fc_layer_size=32, batch_size=256,
                    num_batches_per_epoch=2, hamiltonian_type='ising',
                    mc_move_type='flip', use_fast_sampler=False,
                    sr_solver='dense', sr_diag_shift=1e-2,
                    optimizer='gradient', learning_rates=[0.05],
                    learning_rate_stops=[],
                    wavefunction_optimizer_type='SR')
    wf = models.build_wavefunction(config)
    ham = build_hamiltonian(config)
    opt = StochasticReconfiguration(wf, ham, config)
    state, metrics = opt.epoch(opt.init_state(0, cuda))
    torch.cuda.synchronize()
    assert all(np.isfinite(float(v)) for v in metrics.values())
    configs = state.sampler.configs
    assert len(configs.sum(dim=1).unique()) > 1
    with torch.no_grad():
        on_card = ham.local_value(wf, state.params, configs)
        on_host = ham.local_value(
            wf, tree_map(lambda x: x.cpu(), state.params), configs.cpu())
    torch.testing.assert_close(on_card.cpu(), on_host, rtol=1e-4, atol=1e-4)


def _numpy_rbm(n_sites, hidden, chains, seed, device):
    """An RBM with numpy-seeded weights and Sz=0 configs, on `device`."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.base import tree_map
    config = Config(num_sites=n_sites, wavefunction_type='rbm',
                    num_fc_layers=0, fc_layer_size=hidden)
    wf = models.build_wavefunction(config)
    rng = np.random.default_rng(seed)
    params = tree_map(lambda x: torch.tensor(
        0.1 * rng.standard_normal(tuple(x.shape)), dtype=torch.float32,
        device=device), wf.init(torch.Generator()))
    template = np.repeat([1.0, -1.0], n_sites // 2)
    configs = torch.tensor(
        np.stack([rng.permutation(template) for _ in range(chains)]),
        dtype=torch.float32, device=device)
    return wf, params, configs


def test_measurements_on_the_card_equal_the_host(cuda):
    """Every observable's local value, the Rényi swap values and the four
    Lanczos moment estimators (shifted) of an RBM at N=16 on 256
    configurations: the card within 1e-4 of the host, relative to each
    quantity's largest magnitude (S² and the moments sum up to 120
    amplitude ratios in float32, in another order on each side)."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.ops import observables as obs
    from cgs_vmc_tpu_torch.ops.dynamics import FourierSz
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_tpu_torch.ops.lanczos import moment_local_values
    from cgs_vmc_tpu_torch.ops.renyi import region_mask, swap_values
    n = 16
    wf, params, configs = _numpy_rbm(n, 32, 256, 5, cuda)
    host = tree_map(lambda x: x.cpu(), params)
    pairs = lattice.displacement_pairs(n, 1, 1, 2)
    sub = lattice.marshall_sublattice(n)
    positions = obs.chain_positions(n)
    operators = [obs.SzSzCorrelation(pairs),
                 obs.TransverseCorrelation(
                     pairs, sample_chunk=64,
                     pair_signs=sub[pairs[:, 0]] * sub[pairs[:, 1]]),
                 obs.SpinStructureFactor([np.pi], positions),
                 obs.StaggeredMagnetizationSquared(sub),
                 obs.TotalSpinSquared(n, sample_chunk=64, sublattice=sub),
                 FourierSz([0.5 * np.pi], positions)]
    with torch.no_grad():
        for op in operators:
            want = op.local_value(wf, host, configs.cpu())
            torch.testing.assert_close(
                op.local_value(wf, params, configs).cpu(), want, rtol=1e-4,
                atol=1e-4 * max(float(want.abs().max()), 1.0))
        mask = region_mask(n, range(n // 2))
        x, y = configs[:128], configs[128:]
        torch.testing.assert_close(
            swap_values(wf, params, x, y, mask).cpu(),
            swap_values(wf, host, x.cpu(), y.cpu(), mask),
            rtol=1e-4, atol=1e-4)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(n), -1.0, 1.0,
                                sample_chunk=32)
    on_card = moment_local_values(ham, wf, params, configs, shift=-7.0)
    on_host = moment_local_values(ham, wf, host, configs.cpu(), shift=-7.0)
    for got, want in zip(on_card, on_host):
        scale = max(float(want.abs().max()), 1.0)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


def test_exact_lanczos_on_the_card_is_the_ed_fixed_point(cuda):
    """The N=12 ED ground state as an ed_vector: exact_lanczos on the card
    takes no step (alpha* = 0) and returns the ED energy at 1e-5."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_tpu_torch.ops.lanczos import exact_lanczos
    from cgs_vmc_tpu_torch.utils import ed
    n = 12
    e0, v0 = ed.ground_state(n, lattice.chain_bonds(n), j_x=-1.0)
    wf = FullVector.for_sector(n, v0.astype(np.float32))
    params = tree_map(lambda x: x.to(cuda), wf.init(torch.Generator()))
    res = exact_lanczos(wf, params, HeisenbergHamiltonian(
        lattice.chain_bonds(n), -1.0, 1.0), n)
    assert res.alpha == 0.0
    np.testing.assert_allclose(res.energy, e0, rtol=1e-5)


def test_full_basis_quench_on_the_card_matches_expm(cuda):
    """tests/test_tvmc.py's quench on the card: the N=6 chain ground state,
    a complete (modulus, phase) parameterization, Heun steps under the
    J1-J2 (j2 = 0.5) Hamiltonian with full-basis weights, against
    expm(-iHt) at that test's bars."""
    import scipy.linalg
    from cgs_vmc_tpu_torch import basis, lattice
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.models.complex_phase import (
        ComplexPhaseWavefunction)
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.ops import logamp
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_tpu_torch.optim.tvmc import tdvp_direction
    from cgs_vmc_tpu_torch.utils import ed
    n, t_final, n_steps = 6, 0.2, 40
    bonds, mask = lattice.j1j2_chain_bonds(n)
    couplings = (1.0 - mask) + 0.5 * mask
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    _, v0 = ed.ground_state(n, lattice.chain_bonds(n))
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(n, v0.astype(np.float32)),
        FullVector.for_sector(n, np.ones_like(v0, np.float32)))
    params = tree_map(lambda x: x.to(cuda), wf.init(torch.Generator()))
    states = torch.as_tensor(basis.enumerate_sz_basis(n), device=cuda)

    def direction(p):
        with torch.no_grad():
            amp = wf.apply(p, states)
            weights = torch.softmax(2.0 * amp.log.real, dim=0)
            e_loc = ham.local_value(wf, p, states, amp)
        return tdvp_direction(wf, p, states, e_loc, mode='real',
                              diag_shift=1e-6, weights=weights)

    dt, r2s, energies = t_final / n_steps, [], []
    for _ in range(n_steps):
        k1, e, r2 = direction(params)
        k2, _, _ = direction(tree_map(lambda a, d: a + 0.5 * dt * d,
                                      params, k1))
        params = tree_map(lambda a, d: a + dt * d, params, k2)
        r2s.append(float(r2))
        energies.append(float(e.real))
    with torch.no_grad():
        amp = wf.apply(params, states)
        psi = logamp.to_value(amp._replace(
            log=amp.log - amp.log.real.max())).cpu().numpy()
    dense = np.asarray(ed.heisenberg_matrix(n, bonds, couplings=couplings,
                                            sparse=False))
    exact = scipy.linalg.expm(-1j * dense * t_final) @ v0
    fidelity = abs(np.vdot(psi / np.linalg.norm(psi),
                           exact / np.linalg.norm(exact)))
    assert max(r2s) < 1e-4, max(r2s)
    assert fidelity > 0.9999, fidelity
    assert abs(energies[-1] - energies[0]) < 1e-3 * max(1.0,
                                                        abs(energies[0]))


def test_coupled_linear_response_chains_on_the_card(cuda):
    """The -eps trajectory of sampled_linear_response clones the card's
    generator: at eps = 1e-30 both trajectories are one state on the same
    draws, so C(t) is exactly 0."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.ops import dynamics
    from cgs_vmc_tpu_torch.ops.observables import chain_positions
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = Config(num_sites=16, wavefunction_type='complex',
                    composite_wavefunction_types=['rbm', 'fully_connected'],
                    num_fc_layers=1, fc_layer_size=16, batch_size=256,
                    num_equilibration_sweeps=2, heisenberg_jx=-1.0)
    wf = models.build_wavefunction(config)
    params = tree_map(lambda x: x.to(cuda),
                      wf.init(torch.Generator().manual_seed(3)))
    probe = dynamics.FourierSz([np.pi], chain_positions(16))
    times, corr, records = dynamics.sampled_linear_response(
        wf, params, build_hamiltonian(config), probe, config, eps=1e-30,
        dt=0.02, n_steps=3, device=cuda)
    np.testing.assert_array_equal(corr, np.zeros(4))
    assert len(times) == 4 and len(records) == 3


@pytest.mark.parametrize('name', ['ExcitedPenalty', 'ExcitedSR'])
def test_excited_epoch_launches_k2(cuda, name):
    """One epoch of each excited-state optimizer at the chain40 shape
    (N=40, H=160, 2048 chains) against a frozen RBM: K2 samples the
    variational chains (equilibration + one call a batch) and the frozen
    ones (one call a batch under ExcitedPenalty, one an epoch under
    ExcitedSR); finite metrics."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = _rbm_config(name, 40, 160, 2048).replace(
        optimizer='gradient', learning_rates=[1e-2], sr_diag_shift=1e-2)
    wf = models.build_wavefunction(config)
    frozen = wf.init(torch.Generator().manual_seed(7))
    opt = GROUND_STATE_OPTIMIZERS[name](wf, build_hamiltonian(config),
                                        config, lower_states=[(wf, frozen)])
    state = opt.init_state(0, cuda)
    batches = config.num_batches_per_epoch
    before = profiling.counter('k2.launches')
    state, metrics = opt.epoch(state)
    torch.cuda.synchronize()
    assert profiling.counter('k2.launches') - before == (
        1 + 2 * batches if name == 'ExcitedPenalty' else 2 + batches)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    (lower,) = state.extra['lower_samplers']
    assert lower.configs.device.type == 'cuda'
    assert 0.0 <= float(metrics['overlap'])


def _flat(params):
    from cgs_vmc_tpu_torch.optim.sr import flatten_params
    return flatten_params(params)[0]


def test_ema_slot_and_resume_on_the_card(cuda, tmp_path):
    """chip_smoke.py phase 31 at a cut depth: the EMA slot against the
    host average of every epoch's params (rtol 1e-6), and a resume bit for
    bit, K2 launched."""
    from cgs_vmc_tpu_torch.train import train
    from cgs_vmc_tpu_torch.utils import checkpoint
    config = _rbm_config('EnergyGradient', 40, 160, 2048).replace(
        num_epochs=4, param_ema_decay=0.9, checkpoint_frequency=1,
        max_checkpoints_to_keep=10, checkpoint_dir=str(tmp_path / 'a'))
    before = profiling.counter('k2.launches')
    state = train(config, cuda)
    assert profiling.counter('k2.launches') > before
    ema = None
    for epoch in range(5):
        p = _flat(checkpoint.restore_params_from_checkpoint(
            str(tmp_path / 'a' / f'ckpt_epoch_{epoch}.pt'), 'cpu')).double()
        ema = p if ema is None else 0.9 * ema + 0.1 * p
    torch.testing.assert_close(_flat(state.extra['ema_params']).cpu().double(),
                               ema, rtol=1e-6, atol=1e-8)
    again = train(config.replace(checkpoint_dir=str(tmp_path / 'b'),
                                 num_epochs=2), cuda)
    again = train(config.replace(checkpoint_dir=str(tmp_path / 'b')), cuda,
                  resume=True)
    assert torch.equal(_flat(again.params), _flat(state.params))
    assert torch.equal(_flat(again.extra['ema_params']),
                       _flat(state.extra['ema_params']))


def test_profile_trace_names_k2_on_the_card(cuda, tmp_path):
    """chip_smoke.py phase 33: the trace of the second epoch holds K2's
    device events, one a launch."""
    import glob
    import json
    from cgs_vmc_tpu_torch.train import train
    config = _rbm_config('EnergyGradient', 40, 160, 2048).replace(
        num_epochs=2, profile_dir=str(tmp_path / 'trace'))
    train(config, cuda)
    (trace,) = glob.glob(str(tmp_path / 'trace' / '*.pt.trace.json'))
    with open(trace) as f:
        events = json.load(f)['traceEvents']
    k2 = [e for e in events if str(e.get('cat', '')).lower() == 'kernel'
          and 'rbm_sweep_kernel' in e.get('name', '')
          and 'PhiloxDraws' in e.get('name', '')]
    assert len(k2) == 1 + config.num_batches_per_epoch


def test_params_only_writer_on_the_card(cuda, tmp_path):
    """chip_smoke.py phase 32: card params written and read back bit for
    bit."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.utils import checkpoint
    config = _rbm_config('EnergyGradient', 40, 160, 2048)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator(device=cuda).manual_seed(3))
    path = checkpoint.save_params_only(str(tmp_path), params, 'p')
    back = checkpoint.restore_params_only(
        path, wf.init(torch.Generator(device=cuda)))
    assert torch.equal(_flat(back), _flat(params))


def test_nccl_world_one_is_the_plain_path(cuda, tmp_path):
    """chip_smoke.py phase 34: under a 1-rank NCCL group (num_devices=1
    shards) an EnergyGradient run is bit for bit the run without one."""
    import torch.distributed as dist
    from cgs_vmc_tpu_torch.parallel import mesh
    from cgs_vmc_tpu_torch.train import train
    config = _rbm_config('EnergyGradient', 40, 160, 2048).replace(
        num_epochs=2)
    plain = train(config, cuda)
    mesh.initialize_distributed('nccl', 'file://' + str(tmp_path / 'rdv'),
                                1, 0)
    try:
        before = profiling.counter('k2.launches')
        sharded = train(config, cuda)
        assert profiling.counter('k2.launches') > before
    finally:
        dist.destroy_process_group()
    assert torch.equal(_flat(sharded.params), _flat(plain.params))


def test_entry_on_the_card_equals_the_host(cuda):
    """chip_smoke.py phase 35: `entry()`'s forward step on the card against
    the same inputs' forward on the CPU (TF32 off), rtol 1e-4."""
    from cgs_vmc_tpu_torch import entry
    fn, (params, configs) = entry.entry(cuda)
    assert configs.is_cuda
    log_psi, e_loc = fn(params, configs)
    host_fn, host_args = entry.entry('cpu')
    host_log, host_e = host_fn(*host_args)
    torch.testing.assert_close(log_psi.cpu(), host_log, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(e_loc.cpu(), host_e, rtol=1e-4, atol=1e-4)


def test_bench_sweep_reps_on_the_card(cuda):
    """chip_smoke.py phase 36, cut: the bench's K2 reps at its shape (N=36,
    H=64, 2048 chains) for 10 sweeps a call count their launches and land
    in the acceptance band; the K1 call of `finalize` launches K1."""
    from cgs_vmc_tpu_torch import bench
    before = (profiling.counter('k2.launches'),
              profiling.counter('k1.launches'))
    sweeps = bench.SweepBench(cuda, sweeps_per_call=10)
    for _ in range(2):
        sweeps.rep()
    out = sweeps.finalize()
    assert 0.05 < out['acceptance'] < 0.98
    assert profiling.counter('k2.launches') == before[0] + 3
    assert profiling.counter('k1.launches') == before[1] + 2
    assert bool((sweeps.out.configs.sum(dim=1) == 0).all())


# ----------------------------------------------------------------------
# The compiled epoch: train / distill replaying CUDA graphs against the
# same runs eager (utils/cuda_graph.py; chip_smoke.py phase 38 at full
# width).
# ----------------------------------------------------------------------

class _Records:
    def __init__(self):
        self.rows = []

    def log(self, epoch, metrics):
        self.rows.append((epoch, {k: float(v) for k, v in metrics.items()}))


def _both_ways(run, config, cuda, **kwargs):
    """(eager, graph): each (final state, metric rows, K2 launches) of
    run(config, cuda, replay=..., logger=...)."""
    out = {}
    for replay in ('eager', 'graph'):
        records = _Records()
        before = profiling.counter('k2.launches')
        state = run(config, cuda, replay=replay, logger=records, **kwargs)
        torch.cuda.synchronize()
        out[replay] = (state, records.rows,
                       profiling.counter('k2.launches') - before)
    return out['eager'], out['graph']


def _assert_same_run(eager, graph):
    """Every tensor of the states, every generator's state and every metric
    bit for bit, and the same K2 launches."""
    from cgs_vmc_tpu_torch.utils import tree
    skel_e, leaves_e = tree.flatten(eager[0])
    skel_g, leaves_g = tree.flatten(graph[0])
    assert len(leaves_e) == len(leaves_g)
    for a, b in zip(leaves_e, leaves_g):
        assert torch.equal(a, b)
    gens_e = tree.generators(skel_e)
    gens_g = tree.generators(skel_g)
    assert len(gens_e) == len(gens_g) >= 1
    for a, b in zip(gens_e, gens_g):
        assert torch.equal(a.get_state(), b.get_state())
    assert eager[1] == graph[1]
    assert eager[2] == graph[2]


def _graph_config(**fields):
    from cgs_vmc_tpu_torch.config import Config
    values = dict(num_sites=16, wavefunction_type='rbm', num_fc_layers=0,
                  fc_layer_size=32, batch_size=256, num_batches_per_epoch=4,
                  num_equilibration_sweeps=4, heisenberg_jx=-1.0,
                  optimizer='adam', learning_rates=[1e-2, 5e-3],
                  learning_rate_stops=[4], num_epochs=7,
                  param_ema_decay=0.9, sr_diag_shift=1e-2)
    values.update(fields)
    return Config(**values)


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('name', ['EnergyGradient', 'SR', 'ITSWO',
                                  'LogOverlapITSWO'])
def test_graph_train_is_the_eager_run(cuda, name, k):
    """The RBM on K2 under each ground-state optimizer, 7 epochs with an LR
    stop at 4 (inside a replayed block), adam and the EMA slot: the graph
    run equals the eager run bit for bit, and K2 is counted 5 an epoch
    either way."""
    from cgs_vmc_tpu_torch.train import train
    config = _graph_config(wavefunction_optimizer_type=name,
                           epochs_per_call=k)
    eager, graph = _both_ways(train, config, cuda)
    _assert_same_run(eager, graph)
    assert graph[2] == 7 * (1 + config.num_batches_per_epoch)


@pytest.mark.parametrize('fields', [
    dict(wavefunction_type='conv_2d', size_x=4, size_y=4,
         num_conv_layers=2, num_conv_filters=4, num_fc_layers=1,
         fc_layer_size=8, wavefunction_optimizer_type='ITSWO'),
    dict(wavefunction_type='conv_2d', size_x=4, size_y=4, symmetrize=True,
         num_conv_layers=2, num_conv_filters=4, num_fc_layers=1,
         fc_layer_size=8, wavefunction_optimizer_type='SR',
         optimizer='gradient', learning_rates=[0.02, 0.01],
         sr_reject_residual=0.5, sr_delta_clip=1.0),
    dict(wavefunction_type='complex',
         composite_wavefunction_types=['rbm', 'fully_connected'],
         num_fc_layers=1, fc_layer_size=16, twist_phi=0.3,
         wavefunction_optimizer_type='SR', optimizer='gradient',
         learning_rates=[0.05, 0.02]),
    dict(wavefunction_type='jastrow', pt_replicas=3,
         wavefunction_optimizer_type='EnergyGradient'),
    dict(wavefunction_type='jastrow', mtm_candidates=4,
         wavefunction_optimizer_type='EnergyGradient'),
    dict(wavefunction_type='made', num_fc_layers=1, fc_layer_size=32,
         wavefunction_optimizer_type='EnergyGradient'),
    dict(wavefunction_type='pixelcnn', size_x=4, size_y=4,
         num_conv_layers=2, num_conv_filters=4, sr_fast_jacobian=True,
         wavefunction_optimizer_type='SR', optimizer='gradient',
         learning_rates=[0.02, 0.01]),
    dict(wavefunction_type='transformer', size_x=4, size_y=4,
         attention_dim=16, num_attention_heads=2, num_attention_layers=1,
         batch_size=64, wavefunction_optimizer_type='SR',
         optimizer='gradient', learning_rates=[0.02, 0.01]),
    dict(hamiltonian_type='ising', mc_move_type='flip',
         use_fast_sampler=False, wavefunction_optimizer_type='SR',
         optimizer='gradient', learning_rates=[0.05, 0.02]),
    dict(wavefunction_type='jastrow', wavefunction_optimizer_type='SR',
         optimizer='gradient', learning_rates=[0.05, 0.02]),
    dict(wavefunction_type='mps', bond_dimension=4,
         mps_incremental_sweeps=True, wavefunction_optimizer_type='SR',
         optimizer='gradient', learning_rates=[0.05, 0.02]),
    dict(wavefunction_type='pbdg',
         wavefunction_optimizer_type='EnergyGradient'),
    dict(wavefunction_type='fully_connected_nnb', num_fc_layers=1,
         fc_layer_size=16, wavefunction_optimizer_type='EnergyGradient'),
    dict(wavefunction_type='prod',
         composite_wavefunction_types=['jastrow', 'conv_1d'],
         num_conv_layers=2, num_conv_filters=4, kernel_size=3,
         wavefunction_optimizer_type='SR', optimizer='gradient',
         learning_rates=[0.05, 0.02]),
    dict(wavefunction_type='fully_connected', num_fc_layers=2,
         fc_layer_size=16, sr_solver='cg',
         wavefunction_optimizer_type='SR', optimizer='gradient',
         learning_rates=[0.05, 0.02]),
], ids=['generic-conv-itswo', 'symmetrized-conv-sr', 'complex-sr',
        'tempering', 'mtm', 'made-exact', 'pixelcnn-fast-rows-sr',
        'transformer-sr', 'tfim-sr', 'jastrow-delta-sr', 'mps-env-sr',
        'pbdg-energy-gradient', 'nnb-energy-gradient', 'prod-sr',
        'fc-sr-cg'])
def test_graph_train_other_paths(cuda, monkeypatch, fields):
    """The generic sampler on a conv (square44_itswo's path), the
    symmetrized conv under dense SR (the flagship's), the best-effort
    paths, the incremental samplers and the other ansatz families and
    solvers: each captured and bit for bit with its eager run.  cuDNN's
    deterministic algorithms both ways: its default conv weight gradients
    sum with atomics, so two eager conv runs part in the last bits too."""
    from cgs_vmc_tpu_torch.train import train
    monkeypatch.setattr(torch.backends.cudnn, 'deterministic', True)
    config = _graph_config(num_epochs=4, **fields)
    _assert_same_run(*_both_ways(train, config, cuda))


@pytest.mark.parametrize('fields', [
    dict(wavefunction_type='pbdg', wavefunction_optimizer_type='SR',
         optimizer='gradient', learning_rates=[0.05, 0.02]),
    dict(wavefunction_type='fully_connected_nnb', num_fc_layers=1,
         fc_layer_size=16, wavefunction_optimizer_type='SR',
         sr_solver='cg', optimizer='gradient', learning_rates=[0.05, 0.02]),
], ids=['pbdg-sr', 'nnb-sr-cg'])
def test_eager_table_paths_say_so_and_run_eagerly(cuda, capsys, fields):
    """The determinant ansatzes under SR (cuda_graph.EAGER_PATHS): by
    default a run on the card says it runs eagerly, and its numbers are
    the eager run's; asking for graphs fails at capture (nothing falls
    back)."""
    from cgs_vmc_tpu_torch.train import train
    config = _graph_config(num_epochs=3, **fields)
    eager = train(config, cuda, replay='eager')
    capsys.readouterr()
    default = train(config, cuda)
    assert 'Epochs run eagerly' in capsys.readouterr().out
    assert torch.equal(_flat(eager.params), _flat(default.params))
    with pytest.raises(RuntimeError):
        train(config, cuda, replay='graph')


@pytest.mark.parametrize('name', ['ExcitedPenalty', 'ExcitedSR'])
def test_graph_train_excited(cuda, tmp_path, name):
    """`train --orthogonal_to` under both excited-state optimizers: graph
    and eager bit for bit (the frozen chains' generators registered)."""
    from cgs_vmc_tpu_torch.train import train
    lower = _graph_config(wavefunction_optimizer_type='EnergyGradient',
                          num_epochs=2, param_ema_decay=0.0,
                          checkpoint_dir=str(tmp_path / 'lower'))
    train(lower, cuda, replay='eager')
    config = _graph_config(wavefunction_optimizer_type=name, num_epochs=4,
                           optimizer='gradient', learning_rates=[1e-2, 5e-3],
                           orthogonal_to=[str(tmp_path / 'lower')])
    _assert_same_run(*_both_ways(train, config, cuda))


@pytest.mark.parametrize('name', ['SWO', 'LogOverlapSWO', 'DualSamplingSWO',
                                  'BasisIterSWO'])
def test_graph_distill_is_the_eager_run(cuda, name):
    """`distill` of the N=8 ED state into an RBM (K2) by each supervised
    optimizer, one graph an epoch: bit for bit with the eager run,
    BasisIterSWO's host-drawn permutations included."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.train import distill
    from cgs_vmc_tpu_torch.utils import ed
    config = _graph_config(num_sites=8, fc_layer_size=16, batch_size=128,
                           wavefunction_optimizer_type=name, num_epochs=5)
    _, v0 = ed.ground_state(8, lattice.chain_bonds(8), j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    target = {'ed_vector': torch.tensor(vector, device=cuda)}
    _assert_same_run(*_both_ways(
        distill, config, cuda, target_wf=FullVector.for_sector(8, vector),
        target_params=target))


def test_graph_replays_draw_anew_and_resume_exactly(cuda, tmp_path):
    """Successive replays of one captured epoch draw new configs; the
    generator after the replays is the eager run's; a run resumed from a
    checkpoint (a fresh warm-up and capture) equals the uninterrupted
    run bit for bit; K2 counted 5 a replay."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
    from cgs_vmc_tpu_torch.train import (_scan_epochs, build_hamiltonian,
                                         train)
    from cgs_vmc_tpu_torch.utils.cuda_graph import EpochRunner
    config = _graph_config(wavefunction_optimizer_type='EnergyGradient',
                           param_ema_decay=0.0)
    opt = GROUND_STATE_OPTIMIZERS['EnergyGradient'](
        models.build_wavefunction(config), build_hamiltonian(config), config)
    runner = EpochRunner(lambda k: _scan_epochs(opt.epoch, k), cuda, 'graph')
    state, _ = runner.run(opt.init_state(0, cuda), 1)   # the warm-up
    seen = []
    for _ in range(3):
        before = profiling.counter('k2.launches')
        state, _ = runner.run(state, 1)
        torch.cuda.synchronize()
        assert profiling.counter('k2.launches') - before == 5
        seen.append(state.sampler.configs.clone())
    assert not torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[1], seen[2])
    assert runner.blocks[1].nodes > 0
    eager = opt.init_state(0, cuda)
    for _ in range(4):
        eager, _ = opt.epoch(eager)
    assert torch.equal(eager.sampler.configs, state.sampler.configs)
    assert torch.equal(eager.sampler.generator.get_state(),
                       state.sampler.generator.get_state())

    whole = train(config.replace(checkpoint_dir=str(tmp_path / 'a')), cuda)
    train(config.replace(checkpoint_dir=str(tmp_path / 'b'), num_epochs=3),
          cuda)
    resumed = train(config.replace(checkpoint_dir=str(tmp_path / 'b')),
                    cuda, resume=True)
    assert torch.equal(_flat(whole.params), _flat(resumed.params))
    assert torch.equal(whole.sampler.generator.get_state(),
                       resumed.sampler.generator.get_state())


def test_graph_train_transformer_at_published_widths(cuda):
    """The 6×6 transformer at its published widths (d = 64, 8 heads of 8,
    4 layers, C4v × spin flip) under dense SR at 64 chains: the graph run
    equals the eager run bit for bit, one block of rows (all fit), and the
    counters `encoder.images` and `sr.row_blocks` grow alike both ways (a
    replay adds what its capture counted): 16 images a board of every
    forward, the proposals, the connected boards and the rows.  The
    eager run chooses its block as the graph run's warm-up does."""
    from cgs_vmc_tpu_torch.train import train
    config = _graph_config(
        num_epochs=3, num_sites=36, size_x=6, size_y=6, symmetrize=True,
        wavefunction_type='transformer', attention_dim=64,
        num_attention_heads=8, num_attention_layers=4, batch_size=64,
        num_batches_per_epoch=2, num_equilibration_sweeps=1,
        num_monte_carlo_sweeps=1, energy_chunk_samples=64,
        wavefunction_optimizer_type='SR', optimizer='gradient',
        learning_rates=[0.02, 0.01], param_ema_decay=0.0)
    names = ('encoder.images', 'sr.row_blocks')
    counts = []
    for replay in ('eager', 'graph'):
        before = [profiling.counter(n) for n in names]
        records = _Records()
        state = train(config, cuda, replay=replay, logger=records)
        torch.cuda.synchronize()
        counts.append([profiling.counter(n) - b
                       for n, b in zip(names, before)])
        if replay == 'eager':
            eager = (state, records.rows, 0)
    _assert_same_run(eager, (state, records.rows, 0))
    chains, m = 64, 128
    boards = chains * (1 + (1 + 2 * 1) * 36) + m * (1 + 72 + 1)
    # The sampler's init evaluates the chains once, before the loop.
    assert counts[0] == counts[1] == [16 * (chains + 3 * boards), 3]
