"""The port's CUDA kernels against their plain torch versions, on a card,
and one epoch of the complex-phase path and of each incremental sampler
there.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one.  The file imports no jax, so on a machine without JAX it runs
without the suite's conftest (which imports jax):

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from cgs_vmc_tpu_torch.sampler import kernels

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
    before = kernels.rbm_sweeps.launches
    out = kernels.rbm_sweeps(w, b, a, configs, picks, log_u)
    ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    torch.cuda.synchronize()
    assert kernels.rbm_sweeps.launches == before + 1
    _assert_agree(out, ref, chains)


@pytest.mark.parametrize('n_sites,hidden', SHAPES)
def test_philox_kernel_matches_plain(cuda, n_sites, hidden):
    chains = 2048 if n_sites <= 40 else 256
    w, b, a, configs, _, _ = _inputs(n_sites, hidden, chains, 2, cuda)
    seed = torch.tensor([77], dtype=torch.int64, device=cuda)
    before = kernels.rbm_sweeps_prng.launches
    out = kernels.rbm_sweeps_prng(w, b, a, configs, 2 * n_sites, seed)
    ref = kernels.rbm_sweeps_prng_plain(w, b, a, configs, 2 * n_sites, seed)
    torch.cuda.synchronize()
    assert kernels.rbm_sweeps_prng.launches == before + 1
    _assert_agree(out, ref, chains)


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
    before = kernels.rbm_sweeps_prng.launches
    state, metrics = opt.epoch(state)
    torch.cuda.synchronize()
    assert kernels.rbm_sweeps_prng.launches == (
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
    before = kernels.rbm_sweeps_prng.launches
    state, metrics = opt.epoch(state)
    torch.cuda.synchronize()
    assert kernels.rbm_sweeps_prng.launches == (
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
