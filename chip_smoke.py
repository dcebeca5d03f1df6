#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line, each failing the run (non-zero exit)
when a check does not hold:

1. device: the card's name and its nvidia-smi name and power limit;
2. build: nvcc builds the sweep kernels from cgs_vmc_tpu_torch/csrc;
3. K1 (streamed draws) against its plain torch version on the same draws,
   at the bench shape (N=36, H=64) and the slice shape (N=40, H=160),
   2048 chains, 2 sweeps, and at the slice shape for 10 sweeps (the main
   path's equilibration call): configs and accept counts identical in
   >= 99.9% of chains, logψ within 1e-4 on those chains;
4. K2 (in-kernel Philox) against its plain version, same criterion; and
   K2's equilibrium acceptance within 0.01 of K1's at the bench shape;
5. the slice's training: the port's `train` on configs/chain40_sr.json
   (EnergyGradient, adam, lr 1e-2) for 20 epochs on cuda;
6. the slice's evaluation: `evaluate_operator` on the trained params, once
   with the default sampler (K2) and once with the streamed kernel (K1);
   E/N finite and above the finite-size Bethe value −0.44366 minus 5 errors;
7. times of the kernels and their plain versions, and the mean epoch time.

The launch counters are zeroed just before phase 5 and read after phase 6:
both kernels must have run in the main path.  The last two lines are a JSON
object describing each kernel and the JSON result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CHAINS = 2048
AGREE = 0.999              # share of chains that must match exactly
TOL = 1e-4                 # |Δlogψ| <= TOL·(1 + |logψ|), as the JAX tests
ACC_TOL = 0.01             # K2 vs K1 equilibrium acceptance
BETHE_E_PER_SITE = -0.44366  # finite-size Bethe estimate for N=40
EPOCHS = 20
SHAPES = {'bench': (36, 64), 'slice': (40, 160)}
# Kernel/plain comparisons: (shape, sweeps).  2 sweeps at both shapes, and
# the slice's 10-sweep equilibration call, the longest the main path makes.
COMPARISONS = (('bench', 2), ('slice', 2), ('slice', 10))
TIMING_SWEEPS = 10


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f'chip_smoke FAILED: {what}')


def rbm_inputs(n_sites: int, hidden: int, seed: int, device):
    """RBM weights and Sz=0 configs made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    w = 0.1 * rng.standard_normal((n_sites, hidden))
    b = 0.1 * rng.standard_normal(hidden)
    a = 0.1 * rng.standard_normal(n_sites)
    template = np.repeat([1.0, -1.0], n_sites // 2)
    configs = np.stack([rng.permutation(template) for _ in range(CHAINS)])
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (w, b, a, configs)]


def streamed_draws(n_sites: int, n_steps: int, seed: int, device):
    rng = np.random.default_rng(seed)
    half = n_sites // 2
    picks = rng.integers(0, half, size=(n_steps, CHAINS, 2))
    log_u = np.log(rng.random((n_steps, CHAINS)))
    return (torch.tensor(picks, dtype=torch.int32, device=device),
            torch.tensor(log_u, dtype=torch.float32, device=device))


def compare(label: str, out, ref) -> float:
    """Checks a kernel result against its plain version; returns the
    largest |Δlogψ| over the chains whose trajectories agree."""
    torch.cuda.synchronize()
    same = ((out.configs == ref.configs).all(dim=1)
            & (out.num_accepted == ref.num_accepted))
    n_differ = int((~same).sum())
    err = (out.log_amp - ref.log_amp)[same].abs()
    bound = TOL * (1.0 + ref.log_amp[same].abs())
    theta_err = float((out.theta - ref.theta)[same].abs().max())
    max_err = float(err.max())
    print(f'{label}: {n_differ} of {CHAINS} chains differ; '
          f'max |dlogpsi| {max_err:.3e}, max |dtheta| {theta_err:.3e}',
          flush=True)
    require(n_differ <= (1.0 - AGREE) * CHAINS,
            f'{label}: {n_differ} chains differ from the plain version')
    require(bool((err <= bound).all()) and theta_err <= TOL,
            f'{label}: logpsi/theta disagree beyond {TOL}')
    require(bool(torch.isfinite(out.log_amp).all()),
            f'{label}: non-finite logpsi')
    return max_err


def time_call(fn, reps: int) -> float:
    """Mean seconds of fn() over reps calls, synchronized inside."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / reps


class EpochTimer:
    """MetricsLogger stand-in: keeps each epoch's metrics and wall time."""

    def __init__(self):
        self.records = []
        torch.cuda.synchronize()
        self._last = time.perf_counter()

    def log(self, epoch, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        record = {k: float(v) for k, v in metrics.items()}
        record['epoch'] = epoch
        record['epoch_time_s'] = now - self._last
        self._last = now
        self.records.append(record)
        print('train epoch {epoch}: E={energy:.6f} acc={acceptance_rate:.4f}'
              ' grad_norm={grad_norm:.4g} t={epoch_time_s:.4f}s'.format(
                  **record), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script runs on a '
              'GPU only', file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from cgs_vmc_tpu.config import Config
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.sampler import fast_rbm, kernels
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    from cgs_vmc_tpu_torch.utils.device import resolve_device

    # 1. Device.
    device = resolve_device('cuda')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f'[{smi}]'
    print(f'phase 1 device: {name}; nvidia-smi: {smi}; torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}', flush=True)

    # 2. Build.
    start = time.perf_counter()
    kernels.build()
    print(f'phase 2 build: kernels loaded in '
          f'{time.perf_counter() - start:.2f} s', flush=True)

    # 3./4. Kernels against their plain versions.
    errs = {'rbm_sweeps': 0.0, 'rbm_sweeps_prng': 0.0}
    for i, (shape, sweeps) in enumerate(COMPARISONS):
        n_sites, hidden = SHAPES[shape]
        where = f'{shape} N={n_sites} H={hidden}, {sweeps} sweeps'
        w, b, a, configs = rbm_inputs(n_sites, hidden, 10 + i, device)
        n_steps = sweeps * n_sites
        picks, log_u = streamed_draws(n_sites, n_steps, 20 + i, device)
        out = kernels.rbm_sweeps(w, b, a, configs, picks, log_u)
        ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
        errs['rbm_sweeps'] = max(errs['rbm_sweeps'], compare(
            f'phase 3 K1 vs plain, {where}', out, ref))
        seed = torch.tensor([123457 + i], dtype=torch.int64, device=device)
        out = kernels.rbm_sweeps_prng(w, b, a, configs, n_steps, seed)
        ref = kernels.rbm_sweeps_prng_plain(w, b, a, configs, n_steps, seed)
        errs['rbm_sweeps_prng'] = max(errs['rbm_sweeps_prng'], compare(
            f'phase 4 K2 vs plain, {where}', out, ref))

    n_sites, hidden = SHAPES['bench']
    w, b, a, configs = rbm_inputs(n_sites, hidden, 30, device)
    generator = torch.Generator(device=device).manual_seed(31)
    rates = {}
    for kernel in ('K1', 'K2'):
        state = configs
        for phase in ('equilibrate', 'measure'):
            n_steps = 20 * n_sites
            if kernel == 'K1':
                picks = kernels.sample_picks(generator, n_steps, n_sites,
                                             CHAINS)
                log_u = torch.log(torch.rand((n_steps, CHAINS),
                                             generator=generator,
                                             device=device))
                out = kernels.rbm_sweeps(w, b, a, state, picks, log_u)
            else:
                seed = torch.randint(0, 2 ** 32, (1,), generator=generator,
                                     device=device, dtype=torch.int64)
                out = kernels.rbm_sweeps_prng(w, b, a, state, n_steps, seed)
            state = out.configs
        rates[kernel] = float(out.num_accepted.sum()) / (n_steps * CHAINS)
    print(f'phase 4 equilibrium acceptance at bench shape: K1 '
          f'{rates["K1"]:.5f}, K2 {rates["K2"]:.5f}', flush=True)
    require(abs(rates['K1'] - rates['K2']) < ACC_TOL,
            'K2 acceptance differs from K1 by more than 0.01')
    require(bool((state.sum(dim=1) == 0).all()), 'K2 left the Sz=0 sector')

    # 5. Slice: training, launch counters zeroed just before.
    config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
    config = config.parse(
        'wavefunction_optimizer_type=EnergyGradient,optimizer=adam,'
        f'learning_rates=[1e-2],learning_rate_stops=[],num_epochs={EPOCHS}')
    config = config.replace(
        checkpoint_dir=os.path.join(repo, 'build', 'chip_smoke_run'))
    for old in ([os.path.join(config.checkpoint_dir, f)
                 for f in os.listdir(config.checkpoint_dir)]
                if os.path.isdir(config.checkpoint_dir) else []):
        os.remove(old)
    kernels.reset_launch_counts()
    timer = EpochTimer()
    state = train(config, 'cuda', logger=timer)
    energies = [r['energy'] for r in timer.records]
    acc = timer.records[-1]['acceptance_rate']
    print(f'phase 5 train: {len(energies)} epochs, E first '
          f'{energies[0]:.6f}, mean of last 5 {np.mean(energies[-5:]):.6f}, '
          f'acceptance {acc:.4f}, K2 launches {kernels.rbm_sweeps_prng.launches}',
          flush=True)
    require(len(energies) == EPOCHS and all(np.isfinite(energies)),
            'non-finite training energy')
    require(np.mean(energies[-5:]) < energies[0],
            'training energy did not fall over 20 epochs')
    require(0.05 < acc < 0.98, f'implausible acceptance rate {acc}')
    require(kernels.rbm_sweeps_prng.launches > 0,
            'training did not launch the K2 kernel')

    # 6. Slice: evaluation, with K2 (the default) and with K1.
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    n = config.num_sites
    results = {
        'K2': evaluate_operator(wf, state.params, hamiltonian, config,
                                'cuda'),
        'K1': evaluate_operator(
            wf, state.params, hamiltonian, config, 'cuda',
            sweeps_fn=lambda p, s, k: fast_rbm.run_sweeps(
                wf, p, s, k, use_kernel_prng=False)),
    }
    launches = {'rbm_sweeps': kernels.rbm_sweeps.launches,
                'rbm_sweeps_prng': kernels.rbm_sweeps_prng.launches}
    for label, res in results.items():
        e, err = res.mean / n, res.error / n
        print(f'phase 6 eval ({label} sampler): E/N = {e:.6f} +/- '
              f'{err:.6f}, acceptance {res.acceptance_rate:.4f}', flush=True)
        require(np.isfinite(e) and np.isfinite(err), 'non-finite E/N')
        require(e >= BETHE_E_PER_SITE - 5 * err,
                f'E/N {e} below the variational bound')
    gap = abs(results['K1'].mean - results['K2'].mean) / n
    sigma = np.hypot(results['K1'].error, results['K2'].error) / n
    print(f'phase 6 K1 vs K2 evaluation: |dE/N| {gap:.6f}, '
          f'{gap / sigma:.2f} sigma', flush=True)
    require(gap <= 5 * sigma, 'K1 and K2 evaluations disagree')
    print(f'main path launches: {launches}', flush=True)
    require(all(v > 0 for v in launches.values()),
            'a kernel of the main path was never launched')

    # 7. Times at the bench shape (same calls for kernel and plain).
    n_sites, hidden = SHAPES['bench']
    w, b, a, configs = rbm_inputs(n_sites, hidden, 40, device)
    n_steps = TIMING_SWEEPS * n_sites
    picks, log_u = streamed_draws(n_sites, n_steps, 41, device)
    seed = torch.tensor([99], dtype=torch.int64, device=device)
    times = {
        'rbm_sweeps': (
            time_call(lambda: kernels.rbm_sweeps(w, b, a, configs, picks,
                                                 log_u), 20),
            time_call(lambda: kernels.rbm_sweeps_plain(w, b, a, configs,
                                                       picks, log_u), 2)),
        'rbm_sweeps_prng': (
            time_call(lambda: kernels.rbm_sweeps_prng(w, b, a, configs,
                                                      n_steps, seed), 20),
            time_call(lambda: kernels.rbm_sweeps_prng_plain(
                w, b, a, configs, n_steps, seed), 2)),
    }
    for label, (t_kernel, t_plain) in times.items():
        print(f'phase 7 {label} at N={n_sites} H={hidden} {CHAINS} chains, '
              f'{TIMING_SWEEPS} sweeps a call: kernel {t_kernel * 1e3:.4f} ms'
              f' ({TIMING_SWEEPS / t_kernel:.1f} sweeps/s), plain '
              f'{t_plain * 1e3:.2f} ms ({TIMING_SWEEPS / t_plain:.2f} '
              f'sweeps/s) {card}', flush=True)
    epoch_times = [r['epoch_time_s'] for r in timer.records[1:]]
    print(f'phase 7 slice epoch (N=40, H=160, {config.batch_size} chains, '
          f'EnergyGradient): mean {np.mean(epoch_times) * 1e3:.2f} ms over '
          f'epochs 2-{EPOCHS} {card}', flush=True)

    source = 'cgs_vmc_tpu_torch/csrc/rbm_sweep.cu'
    replaces = {'rbm_sweeps': 'cgs_vmc_tpu/sampler/kernels.py:77',
                'rbm_sweeps_prng': 'cgs_vmc_tpu/sampler/kernels.py:324'}
    report = {'kernels': [
        {'name': label, 'route': 'cuda', 'source': source,
         'replaces': replaces[label], 'launches': launches[label],
         'max_abs_err': errs[label], 'ms': times[label][0] * 1e3,
         'plain_ms': times[label][1] * 1e3}
        for label in ('rbm_sweeps', 'rbm_sweeps_prng')]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
