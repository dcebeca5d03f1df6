"""The port's bench (cgs_vmc_tpu_torch/bench.py) on the CPU, against the
JAX package's root bench.py where they share a formula.

The JAX side is read in a subprocess: importing the root bench.py sets a
persistent JAX compilation cache for the whole process (under $HOME, here a
temporary directory).  The measured parts run at cut sizes with the plain
versions of the kernels; the timings fed to `report` are fixed numbers.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from cgs_vmc_tpu_torch import bench, models
from cgs_vmc_tpu_torch.models.base import tree_leaves
from cgs_vmc_tpu_torch.sampler import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_SIDE = '''
import dataclasses, json
import jax
import bench
from cgs_vmc_tpu.models import build_wavefunction
cfg = bench._flagship_config()
n = sum(p.size for p in jax.tree.leaves(
    build_wavefunction(cfg).init(jax.random.key(0))))
names = ('N_SITES', 'N_CHAINS', 'A100_MOVES_PER_SEC', 'A100_SWEEPS_PER_SEC',
         'REFERENCE_SWEEPS_PER_SEC', 'A100_EFFECTIVE_FLOPS',
         'SWEEPS_PER_CALL', 'SWEEP_REPS', 'EPOCH_REPS', 'FUSED_REPS',
         'K_FUSED', 'SPREAD_THRESHOLD', 'MAX_PASSES')
print(json.dumps({
    'config': dataclasses.asdict(cfg), 'n_params': int(n),
    'flops': int(bench._flagship_epoch_flops(cfg, int(n))),
    'constants': {k: getattr(bench, k) for k in names},
    'spread': bench._spread([1.0, 1.5, 1.2, 0.9]),
}))
'''


@pytest.fixture(scope='module')
def jax_bench(tmp_path_factory):
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               HOME=str(tmp_path_factory.mktemp('home')))
    proc = subprocess.run([sys.executable, '-c', _JAX_SIDE], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_flagship_config_params_and_flops_match_jax(jax_bench):
    cfg = bench._flagship_config()
    # Through JSON as the JAX side came (tuples read back as lists).
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == \
        jax_bench['config']
    wf = models.build_wavefunction(cfg)
    n_params = sum(p.numel() for p in tree_leaves(
        wf.init(torch.Generator().manual_seed(0))))
    assert n_params == jax_bench['n_params']
    assert bench._flagship_epoch_flops(cfg, n_params) == jax_bench['flops']


def test_constants_and_spread_match_jax(jax_bench):
    for name, value in jax_bench['constants'].items():
        assert getattr(bench, name) == value, name
    assert bench._spread([1.0, 1.5, 1.2, 0.9]) == jax_bench['spread']


def test_measure_interleaved_takes_reps_in_turns():
    calls = []

    def rep(label):
        def fn():
            calls.append(label)
            return 1.0
        return fn

    sweep_t, percall_t, fused_t = bench._measure_interleaved(
        rep('S'), rep('P'), rep('F'))
    assert ''.join(calls) == 'PSF' * 3 + 'PS' * 2
    assert (len(sweep_t), len(percall_t), len(fused_t)) == (
        bench.SWEEP_REPS, bench.EPOCH_REPS, bench.FUSED_REPS)


def test_measure_passes_repeats_noisy_passes_and_keeps_the_quietest():
    # Pass 1: a sweep spread of 0.5; pass 2: 0.05 (at most the
    # threshold) ends the loop and wins.
    sweeps = iter([1.0, 1.5, 1.0, 1.0, 1.0] + [1.0, 1.05, 1.0, 1.0, 1.0])
    sweep_t, percall_t, fused_t, passes = bench.measure_passes(
        lambda: next(sweeps), lambda: 2.0, lambda: 3.0)
    assert passes == 2
    assert sweep_t == [1.0, 1.05, 1.0, 1.0, 1.0]
    assert percall_t == [2.0] * 5 and fused_t == [3.0] * 3
    # Never quiet: MAX_PASSES passes, the lowest spread kept.
    noisy = iter([1.0, 2.0, 1.0, 1.0, 1.0] + [1.0, 1.2, 1.0, 1.0, 1.0]
                 + [1.0, 1.5, 1.0, 1.0, 1.0])
    sweep_t, _, _, passes = bench.measure_passes(
        lambda: next(noisy), lambda: 2.0, lambda: 3.0)
    assert passes == bench.MAX_PASSES
    assert sweep_t == [1.0, 1.2, 1.0, 1.0, 1.0]


def test_sweep_rep_on_the_cpu_counts_and_checks_the_band():
    sweeps = bench.SweepBench('cpu', n_sites=8, hidden=8, n_chains=16,
                              sweeps_per_call=2)
    assert sweeps.n_steps == 16 and sweeps.seed == 100
    for _ in range(2):
        assert sweeps.rep() > 0
    assert sweeps.proposals == 2 * 16 * 16
    assert sweeps.seed == 102
    assert 0 < sweeps.accepted <= sweeps.proposals
    out = sweeps.finalize()
    assert out['kernel'] == 'in-kernel prng (rbm_sweeps_prng)'
    assert out['acceptance'] == sweeps.accepted / sweeps.proposals
    assert out['streamed_kernel_sweeps_per_sec'] > 0
    # The timed K1 call is kept with its inputs.
    configs, picks, log_u, k1 = sweeps.streamed_call
    assert picks.shape == (16, 16, 2) and log_u.shape == (16, 16)
    plain = kernels.rbm_sweeps_plain(sweeps.w, sweeps.b, sweeps.a, configs,
                                     picks, log_u)
    assert all(torch.equal(x, y) for x, y in zip(k1, plain))
    assert bool((sweeps.out.configs.sum(dim=1) == 0).all())
    # Zero weights make every move neutral: acceptance 1, out of band.
    flat = bench.SweepBench('cpu', n_sites=8, hidden=8, n_chains=16,
                            sweeps_per_call=2)
    flat.w.zero_()
    flat.rep()
    with pytest.raises(RuntimeError, match='implausible acceptance'):
        flat.finalize()


def _small_flagship():
    # A 4x4 conv_2d 2x4 cut of the flagship config, 8 chains, short sweeps.
    return bench._flagship_config().replace(
        num_sites=16, size_x=4, size_y=4, num_conv_layers=2,
        num_conv_filters=4, batch_size=8, num_batches_per_epoch=2,
        num_equilibration_sweeps=1, num_monte_carlo_sweeps=1)


def test_fused_rep_leaves_the_params_of_k_percall_reps():
    per = bench.FlagshipEpochBench('cpu', _small_flagship())
    fused = bench.FlagshipEpochBench('cpu', _small_flagship())
    for a, b in zip(tree_leaves(per.state.params),
                    tree_leaves(fused.state.params)):
        assert torch.equal(a, b)
    for _ in range(bench.K_FUSED):
        assert per.percall_rep() > 0
    assert fused.fused_rep() > 0
    assert per.state.epoch == fused.state.epoch == 1 + bench.K_FUSED
    for a, b in zip(tree_leaves(per.state.params),
                    tree_leaves(fused.state.params)):
        assert torch.equal(a, b)
    summary = per.finalize(0.5, 0.4)
    assert summary['sr_epoch_wall_s'] == 0.4
    assert summary['sr_epoch_samples_per_sec_percall'] == 32.0


def test_made_draws_are_sz0_boards():
    out = bench.bench_made_exact_sampling('cpu', batch=8)
    assert out['made_exact_samples_per_sec'] > 0
    bench.check_made_draws(torch.tensor([[1.0, -1.0] * 18] * 8), 8)
    with pytest.raises(RuntimeError, match='shape'):
        bench.check_made_draws(torch.ones(8, 35), 8)
    with pytest.raises(RuntimeError, match='Sz = 0'):
        bench.check_made_draws(torch.ones(8, 36), 8)


def test_report_from_fixed_timings():
    timings = bench.Timings(
        sweep_t=[0.02, 0.016, 0.018, 0.017, 0.025],
        percall_t=[5.2, 5.0, 5.4, 5.1, 5.3], fused_t=[5.0, 5.1, 4.9],
        passes=2, dispatch_ms_before=0.03, dispatch_ms_after=0.04)
    cfg = bench._flagship_config()
    epoch = bench._flagship_summary(cfg, 37312, 5.2, 5.0)
    line = bench.report(timings, [{'kernel': 'k'}, epoch])
    assert line['metric'] == ('metropolis_sweeps_per_sec_per_chip_6x6_rbm_'
                              '2048chains')
    assert line['unit'] == 'sweeps/s'
    sps = 800 / 0.018
    assert line['value'] == round(sps, 3)
    assert line['vs_baseline'] == round(
        sps / (2.0e12 / 600.0 / (2048 * 36)), 4)
    extra = line['extra']
    assert extra['moves_per_sec'] == round(sps * 2048 * 36)
    assert extra['vs_reference_architecture'] == round(sps / (1000 / 36), 1)
    assert extra['sweep_rep_spread'] == round((0.025 - 0.016) / 0.018, 3)
    assert extra['sweep_rep_spread_sweeps_per_sec'] == round(
        800 / 0.016 - 800 / 0.025, 1)
    assert extra['epoch_percall_spread'] == round(0.4 / 5.2, 3)
    assert extra['epoch_fused_spread'] == round(0.2 / 5.0, 3)
    assert extra['measurement_passes'] == 2
    assert extra['dispatch_latency_ms_after'] == 0.04
    assert extra['kernel'] == 'k'
    flops = bench._flagship_epoch_flops(cfg, 37312)
    assert extra['sr_epoch_wall_s'] == 5.0
    assert extra['sr_epoch_wall_s_percall'] == 5.2
    assert extra['sr_epoch_samples_per_sec'] == round(4096 / 5.0, 1)
    assert extra['sr_epoch_flops_est'] == float(f'{flops:.3e}')
    assert extra['sr_epoch_a100_roofline_s'] == round(flops / 78e12, 4)
    assert extra['sr_epoch_vs_a100_roofline'] == round(
        flops / 78e12 / 5.0, 3)
    json.dumps(line)


def test_without_cuda_it_exits_nonzero_with_no_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, '-m', 'cgs_vmc_tpu_torch.bench'], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '{' not in proc.stdout
    assert 'CUDA is not available' in proc.stderr
