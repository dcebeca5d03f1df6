#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line, each failing the run (non-zero exit)
when a check does not hold:

1. device: the card's name and its nvidia-smi name and power limit;
2. build: nvcc builds the sweep kernels from cgs_vmc_tpu_torch/csrc;
   their branch-free log1p against the library's log1pf on every float in
   [0, 1] (bit for bit); ptxas's registers and spills of the instances the
   bench and slice shapes run;
3. K1 (streamed draws) against its plain torch version on the same draws,
   at the bench shape (N=36, H=64) and the slice shape (N=40, H=160),
   2048 chains, 2 sweeps, and at the slice shape for 10 sweeps (the main
   path's equilibration call): configs and accept counts identical in
   >= 99.9% of chains, logψ within 1e-4 on those chains; the same at the
   bench and slice shapes with every width (lanes a chain) forced; and at
   the edge shapes: n_sites 2 and 256, H 1, 33 and 512, 3 and 2049 chains,
   0 and G + 1 steps;
4. K2 (in-kernel Philox) against its plain version, same criterion and
   shapes; and K2's equilibrium acceptance within 0.01 of K1's at the
   bench shape;
5. the slice's training: the port's `train` on configs/chain40_sr.json
   (EnergyGradient, adam, lr 1e-2) for 20 epochs on cuda;
6. the slice's evaluation: `evaluate_operator` on the trained params, once
   with the default sampler (K2) and once with the streamed kernel (K1);
   E/N finite and above the finite-size Bethe value −0.44366 minus 5 errors;
7. times of the kernels and their plain versions, and the mean epoch time;
   then each kernel alone (its C entry point, CUDA events) at the bench
   shape (10 sweeps) and the slice shape (1 and 10 sweeps), with the rule's
   width and the other width, beside its bound and its share of it;
8. artifacts: artifacts/heisenberg_6x6_deep48.msgpack through the port's
   own msgpack reader; logψ over the 512 committed samples within 1e-3 of
   tests/data/flagship_6x6_deep48_logpsi.npy, their importance-weighted
   E/N within 1e-3 of QMC −0.678872 (tests/test_flagship_pin.py), and the
   eight tests/test_artifacts.py fingerprints in their bands (std < 0.06),
   on the exact configurations that test draws (FINGERPRINT_CONFIGS);
9. evaluate_operator on deep48 from 512 chains started at the committed
   samples: 5 equilibration sweeps, 50 measurements 2 sweeps apart; E/N
   finite and within 1e-3 + 5σ of QMC;
10. SR training through `train`: (a) configs/square66_conv_sr.json (the
   symmetrized 5×32 conv_2d, dense minSR) for 10 epochs, (b)
   configs/chain40_sr.json (RBM H=160, dense SR, sampled by K2) for 20
   epochs; energies finite and the mean of the last 3 below the first,
   sr_residual_norm finite, acceptance in (0.05, 0.98), and K2 launched
   on path (b);
11. times: the flagship SR epoch (sr_epoch_wall_s) and its parts —
   sampling, local energies, Jacobian rows, the [M, M] assembly and
   Cholesky solve — and the chain40 SR epoch;
12. ITSWO, then LogOverlapITSWO, through `train` on configs/chain40_sr.json
   (adam 1e-3) for 20 epochs each: energies finite, the mean of the last 3
   below the first, acceptance in (0.05, 0.98), K2 launched 1 +
   num_batches_per_epoch times an epoch; the mean epoch time;
13. configs/square44_itswo.json (conv_2d 3×8, ITSWO, generic sampler)
   unmodified but for 40 epochs: energies finite and falling; epoch time;
14. distillation of the 4×4 ED ground state (FullVector of |V0|, 12,870
   states) into an RBM (H=64, K2) by SWO, LogOverlapSWO, DualSamplingSWO
   and BasisIterSWO, 60 epochs each through `distill`: each optimizer's
   fidelity (evaluate_vector + overlap_with_vector) at least the JAX
   package's on the CPU with the same config and seed, less 0.02
   (examples/swo_distill_bars.py measured those);
15. `distill` from phase 12's ITSWO run directory into an RBM H=160 by
   LogOverlapSWO (2048 chains, 5 epochs): mean_ratio finite, K2 launched, a
   checkpoint written; then `evaluate_operator` on the student, E/N finite
   and above the Bethe value minus 5 errors;
16. configs/j1j2_chain8_complex_sr.json unmodified (complex(fc × fc), dense
   SR on the stacked [2M, 2M] system, 150 epochs) through `train`, then
   `evaluate_operator`: the mean of the last 10 training energies below
   −2.85 and within 5% of the Majumdar–Ghosh E0 = −3 (the bar of
   tests/test_complex.py); the evaluated energy beside the JAX package's on
   the CPU (examples/twisted_chain16_bars.py measured it);
17. configs/twisted_chain16_sr.json unmodified (N=16, twist φ=0.3, 350
   epochs): the evaluated energy not below the twisted ED ground energy
   (5 errors allowed) and its relative error at most the JAX package's on
   the CPU for the same config and seed plus TWIST_MARGIN; then the spin-
   stiffness ansatz of examples/spin_stiffness_chain16.py (complex(rbm ×
   fc 48), 512 chains × 2) through `train` at φ = 0 and φ = 1.2, ΔE
   printed beside twisted ED's (not gated);
18. the sampler cells at 6×6 (N=36), 2048 chains, each ansatz's generic
   sweeps against its incremental sampler as the registry resolves them:
   pbdg / pbdg_sherman_morrison, jastrow / jastrow_delta, mps (Config's
   default bond dimension 4, and 16) / mps_env; sweeps/s printed (the
   median of calls taken in turns); the
   cached logψ within 1e-4 of a fresh forward after every call, and the
   acceptance rates of fast and generic within 0.02 (jastrow, pbdg; the
   MPS sampler's adjacent exchanges are another move);
19. one short SR 'dense' `train` run on the N=16 chain for each of mps (on
   mps_env), pbdg, fully_connected_nnb, gnn, jastrow and 'prod' (jastrow ×
   conv_1d; the gnn on an adjacency file with a self column): energies
   finite, the mean of the last 3 below the first.

The launch counters are zeroed just before phase 5 and read after phase 6,
and zeroed again before each of phases 10(b), 12 (per optimizer), 13, 14
(per optimizer) and 15 and read after it: both kernels must have run in
the slice-1 path, K2 in the SR, ITSWO, SWO and distill paths.  The last two
lines are a JSON object describing each kernel (launches from phases 5-6;
times and bound at the bench shape, 10 sweeps) and the JSON result line.
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
# The layout's edges: (n_sites, hidden, chains), each at 0 and G + 1 steps.
EDGE_SHAPES = tuple((n, h, c) for n in (2, 256) for h in (1, 33, 512)
                    for c in (3, 2049))
TIMING_SWEEPS = 10
# Kernel-alone times: (shape, sweeps a call), CUDA events over KERNEL_REPS.
KERNEL_TIMINGS = (('bench', 10), ('slice', 1), ('slice', 10))
KERNEL_REPS = 50
# The bound, the least time the card could take: ~11 f32 operations a
# hidden unit a step (Δθ, θ+Δθ, |x|, ×−2, exp, log1p, +, −log 2,
# difference, sum) at the H100 SXM's 67 TFLOP/s f32, or the bytes in and
# out at 3.35 TB/s.
OPS_PER_UNIT = 11
F32_PEAK = 67e12
HBM_RATE = 3.35e12
SR_EPOCHS = {'square66_conv_sr': 10, 'chain40_sr': 20}
SR_TIMING_REPS = 2
# 12.-15. Imaginary-time SWO and distillation.
ITSWO_EPOCHS = 20
SQUARE44_EPOCHS = 40
# The 4x4 distillation: the JAX package's distill test's rates and batches
# (tests/test_training.py), at 4x4 with an H=64 RBM student.
DISTILL = dict(num_sites=16, size_x=4, size_y=4, wavefunction_type='rbm',
               num_fc_layers=0, fc_layer_size=64, batch_size=512,
               num_batches_per_epoch=10, num_monte_carlo_sweeps=1,
               heisenberg_jx=-1.0, optimizer='adam',
               learning_rates=[1e-2, 3e-3], learning_rate_stops=[40], seed=14)
DISTILL_EPOCHS = 60
# Fidelity the JAX package reaches with DISTILL, DISTILL_EPOCHS and the
# same seed on the CPU (its generic sampler), by examples/swo_distill_bars.py;
# the port must reach each less FIDELITY_MARGIN.  The raw-L2 fits move by
# several hundredths from seed to seed in either package, so the seed is the
# one of 1-15 whose JAX fidelities sit near the middle of that spread.
JAX_FIDELITY = {'BasisIterSWO': 0.924120, 'DualSamplingSWO': 0.859464,
                'LogOverlapSWO': 0.988948, 'SWO': 0.971562}
FIDELITY_MARGIN = 0.02
DISTILL_RUN_EPOCHS = 5
# 16.-17. The complex-phase path.  The relative errors of the evaluated
# energies the JAX package reaches on the CPU with the same configs and
# seeds (JAX_PLATFORMS=cpu python examples/twisted_chain16_bars.py); the
# port must come within TWIST_MARGIN of the twisted one.  That recipe ends on
# a plateau 24% above ED in either package, where the same seed lands 0.238
# to 0.251 from one random stream to another (the JAX package and the port on
# the CPU, the port on an H100): the margin is about twice that spread.
MG_E0 = -3.0                 # J1-J2 chain, N=8, J2/J1 = 0.5 (Majumdar-Ghosh)
MG_BAR = -2.85
JAX_COMPLEX_REL_ERR = {'j1j2_chain8_complex_sr': 0.006201,
                       'twisted_chain16_sr': 0.242352}
TWIST_MARGIN = 0.03
STIFFNESS_PHIS = (0.0, 1.2)
STIFFNESS_EPOCHS = 200
STIFFNESS_TAIL = 30
# 18. Sampler cells: (ansatz, config overrides, the fast entry's name,
# whether the acceptance rates of fast and generic are comparable).
SAMPLER_CELLS = (
    ('pbdg', {}, 'pbdg_sherman_morrison', True),
    ('jastrow', {}, 'jastrow_delta', True),
    ('mps', {'bond_dimension': 4, 'mps_incremental_sweeps': True},
     'mps_env', False),
    ('mps', {'bond_dimension': 16, 'mps_incremental_sweeps': True},
     'mps_env', False),
)
SAMPLER_WARM_SWEEPS = 2
SAMPLER_SWEEPS = 3
SAMPLER_REPS = 5
SAMPLER_ACC_TOL = 0.02
# 19. The ansatz families under SR 'dense' on the N=16 chain.
FAMILY_EPOCHS = 25
FAMILY_BASE = dict(num_sites=16, batch_size=256, num_batches_per_epoch=2,
                   num_equilibration_sweeps=4, num_monte_carlo_sweeps=1,
                   heisenberg_jx=-1.0, wavefunction_optimizer_type='SR',
                   sr_solver='dense', sr_diag_shift=1e-2, sr_delta_clip=1.0,
                   optimizer='gradient', learning_rates=[0.05],
                   learning_rate_stops=[], num_epochs=FAMILY_EPOCHS, seed=19)
FAMILIES = (
    # The MPS falls slowest (~0.03 an epoch against ~0.1 of noise): more
    # epochs, so that the check is not a coin toss.
    ('mps', dict(wavefunction_type='mps', bond_dimension=8,
                 mps_incremental_sweeps=True, num_epochs=40), 'mps_env'),
    ('pbdg', dict(wavefunction_type='pbdg'), 'pbdg_sherman_morrison'),
    ('fully_connected_nnb', dict(wavefunction_type='fully_connected_nnb',
                                 num_fc_layers=1, fc_layer_size=32),
     'generic'),
    # Its adjacency list comes from a file whose rows are (site, left,
    # right): the list made from the bonds has no self column, and on a
    # bipartite lattice neighbours of neighbours never join the sublattices.
    ('gnn', dict(wavefunction_type='gnn', num_conv_layers=2,
                 num_conv_filters=8), 'generic'),
    ('jastrow', dict(wavefunction_type='jastrow'), 'jastrow_delta'),
    ('prod', dict(wavefunction_type='prod',
                  composite_wavefunction_types=['jastrow', 'conv_1d'],
                  num_conv_layers=2, num_conv_filters=8, kernel_size=3),
     'generic'),
)
QMC_E_PER_SITE = -0.678872   # Sandvik QMC, square-lattice Heisenberg 6x6
PIN_BAND = 1e-3
PIN_SAMPLES = 'tests/data/flagship_6x6_deep48_samples.npy'
PIN_LOGPSI = 'tests/data/flagship_6x6_deep48_logpsi.npy'
# tests/test_artifacts.py CASES: (artifact, conv layers, filters, lattice
# side, fingerprint mean E/N over the seeded batch, band).
FINGERPRINTS = (
    ('heisenberg_6x6_deep48', 7, 48, 6, -0.678510, 0.004),
    ('heisenberg_6x6_symconv48_v2', 5, 48, 6, -0.681685, 0.004),
    ('heisenberg_6x6_symconv_v2', 5, 32, 6, -0.679797, 0.004),
    ('heisenberg_10x10_symconv_v3', 5, 32, 10, -0.655397, 0.008),
    ('heisenberg_10x10_deep32_cont', 7, 32, 10, -0.660801, 0.008),
    ('heisenberg_12x12_symconv', 5, 32, 12, -0.663586, 0.010),
    ('heisenberg_12x12_deep32', 7, 32, 12, -0.668395, 0.010),
    ('heisenberg_12x12_deep32_anneal', 7, 32, 12, -0.668431, 0.010),
)
# The fingerprints' configurations, basis.random_configurations(
# jax.random.key(1234), n_sites, n) of the JAX package, one hex bitmask a
# configuration (bit i set: spin +1 at site i).  Another random batch does
# not land in the bands; tests/test_torch_conv.py holds this table to the
# JAX draw.
FINGERPRINT_CONFIGS = {
    36: ('657122d1f', '417bb41f1', 'a5adc451b', '09b29fac3', '7500dfc8b',
         '565d063ce', '5e3eed006', '4b3a24bea', '515b504fb', 'c6c559e4c',
         '7833d9427', '7343b345a'),
    100: ('48c15d16a56fec93f89d968d0', '07d8e364b8f92957096b92b6c',
          '45819f8b5b12598f1af9670dc', '2303f6a8623dd37ad56050ff8',
          '9eb5f9c93a3e4e50c647a0a52', 'f0d829b6390e45a1d3f1b9d94',
          '0aedc73ea24411364e5ea5ece', '001e5f8bf014e95ca2bbcb1f9'),
    144: ('7d9252f19667a5c9f265ff91ca156b21a041',
          '45fea9bd81859c19c1eb2643506593f17f15',
          '65806b28aaeeaa9d42ecc336712e96b71f38',
          '84b469f192a78b2d3d1aebc92ce415c167dc',
          '4f436e95c7fcb8cc7a5f1605018809fa5ed2',
          '79496cc6958c05d38d0e4c59b8fce1535e9b'),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f'chip_smoke FAILED: {what}')


def rbm_inputs(n_sites: int, hidden: int, seed: int, device,
               chains: int = CHAINS):
    """RBM weights and Sz=0 configs made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    w = 0.1 * rng.standard_normal((n_sites, hidden))
    b = 0.1 * rng.standard_normal(hidden)
    a = 0.1 * rng.standard_normal(n_sites)
    template = np.repeat([1.0, -1.0], n_sites // 2)
    configs = np.stack([rng.permutation(template) for _ in range(chains)])
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (w, b, a, configs)]


def streamed_draws(n_sites: int, n_steps: int, seed: int, device,
                   chains: int = CHAINS):
    rng = np.random.default_rng(seed)
    half = n_sites // 2
    picks = rng.integers(0, half, size=(n_steps, chains, 2))
    log_u = np.log(rng.random((n_steps, chains)))
    return (torch.tensor(picks, dtype=torch.int32, device=device),
            torch.tensor(log_u, dtype=torch.float32, device=device))


def compare(label: str, out, ref) -> float:
    """Checks a kernel result against its plain version; returns the
    largest |Δlogψ| over the chains whose trajectories agree."""
    torch.cuda.synchronize()
    chains = ref.configs.shape[0]
    same = ((out.configs == ref.configs).all(dim=1)
            & (out.num_accepted == ref.num_accepted))
    n_differ = int((~same).sum())
    require(n_differ <= (1.0 - AGREE) * chains,
            f'{label}: {n_differ} of {chains} chains differ from the plain '
            'version')
    err = (out.log_amp - ref.log_amp)[same].abs()
    bound = TOL * (1.0 + ref.log_amp[same].abs())
    theta_err = float((out.theta - ref.theta)[same].abs().max())
    max_err = float(err.max())
    print(f'{label}: {n_differ} of {chains} chains differ; '
          f'max |dlogpsi| {max_err:.3e}, max |dtheta| {theta_err:.3e}',
          flush=True)
    require(bool((err <= bound).all()) and theta_err <= TOL,
            f'{label}: logpsi/theta disagree beyond {TOL}')
    require(bool(torch.isfinite(out.log_amp).all()),
            f'{label}: non-finite logpsi')
    require(bool((out.configs.sum(dim=1) == 0).all()),
            f'{label}: a chain left the Sz=0 sector')
    return max_err


def compare_both(where: str, w, b, a, configs, n_steps: int, seed: int,
                 lanes: int, kernels, errs: dict) -> None:
    """K1 (phase 3) and K2 (phase 4) on `lanes` lanes a chain (0: the
    rule) against their plain versions on the same inputs and draws."""
    n_sites = configs.shape[1]
    picks, log_u = streamed_draws(n_sites, n_steps, seed, configs.device,
                                  configs.shape[0])
    out = kernels._rbm_sweeps(w, b, a, configs, picks, log_u, lanes)
    ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    errs['rbm_sweeps'] = max(errs['rbm_sweeps'], compare(
        f'phase 3 K1 vs plain, {where}', out, ref))
    seed = torch.tensor([123457 + seed], dtype=torch.int64,
                        device=configs.device)
    out = kernels._rbm_sweeps_prng(w, b, a, configs, n_steps, seed, lanes)
    ref = kernels.rbm_sweeps_prng_plain(w, b, a, configs, n_steps, seed)
    errs['rbm_sweeps_prng'] = max(errs['rbm_sweeps_prng'], compare(
        f'phase 4 K2 vs plain, {where}', out, ref))


def sweep_bound(kernel: str, chains: int, n_sites: int, hidden: int,
                n_steps: int):
    """(seconds, 'operations' or 'bytes'): the least time the card could
    take for a sweeps call, the larger of its f32 operations over the f32
    peak and the bytes it must move (each input read once, each output
    written once; K1 also reads its draws) over the memory rate."""
    ops = chains * n_steps * hidden * OPS_PER_UNIT
    nbytes = 4 * (2 * chains * n_sites + chains * hidden + n_sites * hidden
                  + n_sites + chains)
    if kernel == 'K1':
        nbytes += 12 * n_steps * chains
    t_ops, t_bytes = ops / F32_PEAK, nbytes / HBM_RATE
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (CUDA events,
    after one warm-up launch)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def raw_launcher(lib, kernel: str, x: dict, lanes: int):
    """A function launching `kernel`'s C entry point once on the inputs x,
    on `lanes` lanes a chain (0: the rule)."""
    n_chains, n_sites = x['configs'].shape
    hidden, n_steps = x['w'].shape[1], x['picks'].shape[0]
    head = [x[k].data_ptr() for k in ('configs', 'theta', 'w', 'a')]
    outs = [x['out'].data_ptr(), x['accepted'].data_ptr()]
    tail = [n_chains, n_sites, hidden, n_steps, lanes]
    if kernel == 'K1':
        fn = lib.rbm_sweeps_streamed_f32
        args = head + [x['picks'].data_ptr(), x['log_u'].data_ptr()] + outs
    else:
        fn = lib.rbm_sweeps_philox_f32
        args = head + [x['seed'].data_ptr(), n_sites // 2,
                       n_sites - n_sites // 2] + outs

    def launch():
        err = fn(*args, *tail, torch.cuda.current_stream().cuda_stream)
        require(err == 0, f'{kernel} launch failed with CUDA error {err}')
    return launch


def phase_kernel_times(kernels, device, card: str) -> dict:
    """7. Each kernel alone, through its C entry point, timed by CUDA
    events: the rule's width and the other width the shape allows.
    Returns {(kernel, shape, sweeps): {variant: ms}} and prints the bound
    and share beside each time."""
    resources = kernels.kernel_resources()
    table = {}
    for i, (shape, sweeps) in enumerate(KERNEL_TIMINGS):
        n_sites, hidden = SHAPES[shape]
        n_steps = sweeps * n_sites
        w, b, a, configs = rbm_inputs(n_sites, hidden, 50 + i, device)
        picks, log_u = streamed_draws(n_sites, n_steps, 60 + i, device)
        x = {'configs': configs, 'theta': configs @ w + b, 'w': w, 'a': a,
             'picks': picks, 'log_u': log_u,
             'seed': torch.tensor([7], dtype=torch.int64, device=device),
             'out': torch.empty_like(configs),
             'accepted': torch.empty(CHAINS, device=device)}
        rule = kernels.instance(n_sites, hidden)[0]
        widths = [g for g in kernels.LANES
                  if -(-hidden // g) <= kernels.MAX_UNITS_PER_LANE]
        for kernel in ('K1', 'K2'):
            bound, bound_by = sweep_bound(kernel, CHAINS, n_sites, hidden,
                                          n_steps)
            variants = [(f'rule G={rule}', 0)] + [
                (f'G={g}', g) for g in widths if g != rule]
            times = {}
            for label, lanes in variants:
                ms = event_ms(raw_launcher(kernels._lib(), kernel, x, lanes),
                              KERNEL_REPS)
                times[label] = ms
                rec = resources.get((kernel, *kernels.instance(
                    n_sites, hidden, lanes)), {})
                res = (f', {rec.get("registers")} registers, spills '
                       f'{rec.get("spill_stores")}/'
                       f'{rec.get("spill_loads")} B')
                print(f'phase 7 kernel alone {kernel} {shape} N={n_sites} '
                      f'H={hidden} {CHAINS} chains {sweeps} sweeps, '
                      f'{label}: {ms:.4f} ms ({sweeps / ms * 1e3:.1f} '
                      f'sweeps/s); bound {bound * 1e3:.5f} ms '
                      f'({bound_by}), {bound * 1e3 / ms:.2%} of it{res} '
                      f'{card}', flush=True)
            table[(kernel, shape, sweeps)] = times
    return table


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
    """MetricsLogger stand-in: keeps each epoch's metrics and wall time, and
    prints every `every`-th epoch's."""

    def __init__(self, label: str = 'train', every: int = 1):
        self.records = []
        self.label = label
        self.every = every
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
        if epoch % self.every == 0:
            values = ' '.join(f'{k}={v:.6g}' for k, v in metrics_items(
                record))
            print(f'{self.label} epoch {epoch}: {values} '
                  f't={record["epoch_time_s"]:.4f}s', flush=True)

    def mean_epoch_ms(self) -> float:
        """Mean wall time of the epochs after the first, in ms."""
        return float(np.mean([r['epoch_time_s']
                              for r in self.records[1:]])) * 1e3


def metrics_items(record: dict):
    return [(k, v) for k, v in record.items()
            if k not in ('epoch', 'epoch_time_s')]


def fresh_run_dir(repo: str, name: str) -> str:
    """build/{name}, emptied of an earlier run's files."""
    path = os.path.join(repo, 'build', name)
    for old in (os.listdir(path) if os.path.isdir(path) else []):
        os.remove(os.path.join(path, old))
    return path


def timed(fn):
    """(fn(), seconds), synchronized on both sides."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def fingerprint_configs(n_sites: int) -> np.ndarray:
    """FINGERPRINT_CONFIGS[n_sites] as a [n, n_sites] ±1 float32 array."""
    return np.array([[1.0 if int(mask, 16) >> i & 1 else -1.0
                      for i in range(n_sites)]
                     for mask in FINGERPRINT_CONFIGS[n_sites]], np.float32)


def conv_config(layers: int, filters: int, side: int, **overrides):
    """The symmetrized conv_2d of the artifacts on the side × side torus."""
    from cgs_vmc_tpu_torch.config import Config
    return Config(num_sites=side * side, size_x=side, size_y=side,
                  wavefunction_type='conv_2d', num_conv_layers=layers,
                  num_conv_filters=filters, kernel_size=3, symmetrize=True,
                  heisenberg_jx=-1.0, **overrides)


def load_artifact(repo: str, name: str, config, device):
    """(wavefunction, params on `device`) of artifacts/{name}.msgpack."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.utils import checkpoint
    wf = models.build_wavefunction(config)
    return wf, checkpoint.restore_params_only(
        os.path.join(repo, 'artifacts', f'{name}.msgpack'),
        wf.init(torch.Generator(device=device)))


def square_hamiltonian(side: int, sample_chunk: int = 0):
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    return HeisenbergHamiltonian(lattice.square_lattice_bonds(side, side),
                                 -1.0, 1.0, sample_chunk=sample_chunk)


def phase_artifacts(repo: str, device) -> None:
    """8. The deep48 pin (drift, weighted E/N) and the fingerprints."""
    start = time.perf_counter()
    wf, params = load_artifact(repo, 'heisenberg_6x6_deep48',
                               conv_config(7, 48, 6), device)
    samples = torch.tensor(np.load(os.path.join(repo, PIN_SAMPLES)),
                           dtype=torch.float32, device=device)
    log_ref = np.load(os.path.join(repo, PIN_LOGPSI))
    with torch.no_grad():
        log_new = wf.apply(params, samples).log.double().cpu().numpy()
        e_loc = square_hamiltonian(6, sample_chunk=64).local_value(
            wf, params, samples).double().cpu().numpy()
    drift = float(np.max(np.abs(log_new - log_ref)))
    shift = log_new - log_ref
    weights = np.exp(2.0 * (shift - shift.max()))
    e_pin = float((weights / weights.sum() * e_loc).sum()) / 36
    print(f'phase 8 deep48 pin: {len(log_ref)} samples, max |dlogpsi| '
          f'{drift:.3e}, weighted E/N {e_pin:.6f} (QMC {QMC_E_PER_SITE}, '
          f'band {PIN_BAND})', flush=True)
    require(drift < PIN_BAND, f'deep48 logpsi drift {drift}')
    require(abs(e_pin - QMC_E_PER_SITE) < PIN_BAND,
            f'deep48 weighted E/N {e_pin} off QMC')
    for name, layers, filters, side, expected, band in FINGERPRINTS:
        wf, params = load_artifact(repo, name,
                                   conv_config(layers, filters, side), device)
        configs = torch.tensor(fingerprint_configs(side * side),
                               device=device)
        with torch.no_grad():
            e_loc = square_hamiltonian(side).local_value(
                wf, params, configs).double().cpu().numpy() / side ** 2
        mean, std = float(e_loc.mean()), float(e_loc.std())
        print(f'phase 8 fingerprint {name}: E/N {mean:.6f} (recorded '
              f'{expected}, band {band}), std {std:.4f}', flush=True)
        require(bool(np.isfinite(e_loc).all()), f'{name}: non-finite E_loc')
        require(abs(mean - expected) < band, f'{name}: fingerprint drifted')
        require(std < 0.06, f'{name}: local-energy std {std} blown up')
    print(f'phase 8 wall time {time.perf_counter() - start:.2f} s',
          flush=True)


def phase_eval(repo: str, device) -> None:
    """9. evaluate_operator on deep48, 512 chains started at the
    committed samples (drawn from |psi|^2), 50 measurements."""
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.utils import interop
    start = time.perf_counter()
    configs = np.load(os.path.join(repo, PIN_SAMPLES))
    config = conv_config(7, 48, 6, batch_size=len(configs),
                         num_equilibration_sweeps=5,
                         num_evaluation_samples=50,
                         num_monte_carlo_sweeps=2)
    wf, params = load_artifact(repo, 'heisenberg_6x6_deep48', config, device)
    state = interop.sampler_state_from_numpy(
        configs, np.zeros(len(configs)), np.ones(len(configs)), device,
        seed=9)
    result = evaluate_operator(wf, params,
                               square_hamiltonian(6, sample_chunk=128),
                               config, device, state=state)
    e, err = result.mean / 36, result.error / 36
    print(f'phase 9 deep48 evaluation: E/N = {e:.6f} +/- {err:.6f} '
          f'(QMC {QMC_E_PER_SITE}), acceptance '
          f'{result.acceptance_rate:.4f}, wall time '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    require(np.isfinite(e) and np.isfinite(err), 'non-finite deep48 E/N')
    require(abs(e - QMC_E_PER_SITE) < PIN_BAND + 5 * err,
            f'deep48 evaluation E/N {e} off QMC')


def phase_sr_train(repo: str, device, name: str, epochs: int):
    """10. `train` on configs/{name}.json, unmodified but for num_epochs
    and the checkpoint directory.  Returns (config, final state, timer)."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import train
    start = time.perf_counter()
    config = Config.load(os.path.join(repo, 'configs', f'{name}.json'))
    config = config.replace(num_epochs=epochs, checkpoint_dir=fresh_run_dir(
        repo, f'chip_smoke_{name}'))
    timer = EpochTimer()
    state = train(config, device, logger=timer)
    energies = [r['energy'] for r in timer.records]
    residuals = [r['sr_residual_norm'] for r in timer.records]
    acc = timer.records[-1]['acceptance_rate']
    print(f'phase 10 SR train {name}: {len(energies)} epochs, E first '
          f'{energies[0]:.6f}, mean of last 3 {np.mean(energies[-3:]):.6f}, '
          f'acceptance {acc:.4f}, wall time '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    require(len(energies) == epochs and all(np.isfinite(energies)),
            f'{name}: non-finite SR training energy')
    require(np.mean(energies[-3:]) < energies[0],
            f'{name}: SR training energy did not fall')
    require(all(np.isfinite(residuals)), f'{name}: non-finite SR residual')
    require(0.05 < acc < 0.98, f'{name}: implausible acceptance rate {acc}')
    return config, state, timer


def phase_sr_times(config, state) -> dict:
    """11. The SR epoch's wall time and its parts, each synchronized, mean
    of SR_TIMING_REPS runs after the training epochs."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.models.base import tree_leaves
    from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    wf = models.build_wavefunction(config)
    ham = build_hamiltonian(config)
    opt = StochasticReconfiguration(wf, ham, config)
    params = state.params
    times = {k: 0.0 for k in ('sr_epoch_wall_s', 'sampling_s',
                              'local_energy_s', 'jacobian_s', 'solve_s')}

    def energies(configs):
        with torch.no_grad():
            return ham.local_value(wf, params, configs,
                                   wf.apply(params, configs))

    for _ in range(SR_TIMING_REPS):
        _, t_epoch = timed(lambda: opt.epoch(state))
        (_, configs), t_sample = timed(
            lambda: opt.sample(params, state.sampler))
        e_loc, t_energy = timed(lambda: energies(configs))
        (jac, _), t_jac = timed(
            lambda: opt._centered_jacobian(configs, params))
        _, t_solve = timed(lambda: opt._solve_sample_space(
            jac, e_loc - torch.mean(e_loc)))
        del jac
        for key, t in zip(times, (t_epoch, t_sample, t_energy, t_jac,
                                  t_solve)):
            times[key] += t / SR_TIMING_REPS
    times['samples'] = int(configs.shape[0])
    times['params'] = sum(p.numel() for p in tree_leaves(params))
    return times


def phase_itswo(repo: str, device, kernels, card: str) -> str:
    """12. ITSWO and LogOverlapITSWO through `train` on chain40 (adam 1e-3,
    square44_itswo.json's first rate), the counts zeroed before each run.
    Returns the ITSWO run directory (phase 15's supervisor)."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import train
    run_dirs = {}
    for name in ('ITSWO', 'LogOverlapITSWO'):
        config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
        config = config.parse(
            f'wavefunction_optimizer_type={name},optimizer=adam,'
            'learning_rates=[1e-3],learning_rate_stops=[],'
            f'num_epochs={ITSWO_EPOCHS}')
        config = config.replace(checkpoint_dir=fresh_run_dir(
            repo, f'chip_smoke_{name}'))
        timer = EpochTimer(f'phase 12 {name}')
        kernels.reset_launch_counts()
        train(config, device, logger=timer)
        launches = kernels.rbm_sweeps_prng.launches
        energies = [r['energy'] for r in timer.records]
        acc = timer.records[-1]['acceptance_rate']
        expected = 1 + config.num_batches_per_epoch
        print(f'phase 12 {name} chain40 (RBM H=160, {config.batch_size} '
              f'chains x {config.num_batches_per_epoch} batches, beta '
              f'{config.time_evolution_beta}): {len(energies)} epochs, E '
              f'first {energies[0]:.6f}, mean of last 3 '
              f'{np.mean(energies[-3:]):.6f}, acceptance {acc:.4f}; K2 '
              f'launches {launches} ({launches / ITSWO_EPOCHS:g} an epoch, '
              f'expected {expected}); mean epoch {timer.mean_epoch_ms():.2f} '
              f'ms over epochs 2-{ITSWO_EPOCHS} {card}', flush=True)
        require(len(energies) == ITSWO_EPOCHS and all(np.isfinite(energies)),
                f'{name}: non-finite energy')
        require(np.mean(energies[-3:]) < energies[0],
                f'{name}: energy did not fall')
        require(0.05 < acc < 0.98, f'{name}: implausible acceptance {acc}')
        require(launches == expected * ITSWO_EPOCHS,
                f'{name}: K2 launched {launches} times, expected '
                f'{expected * ITSWO_EPOCHS}')
        run_dirs[name] = config.checkpoint_dir
    return run_dirs['ITSWO']


def phase_square44(repo: str, device, kernels, card: str) -> None:
    """13. configs/square44_itswo.json, unmodified but for the epochs."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import train
    config = Config.load(os.path.join(repo, 'configs', 'square44_itswo.json'))
    config = config.replace(num_epochs=SQUARE44_EPOCHS,
                            checkpoint_dir=fresh_run_dir(
                                repo, 'chip_smoke_square44_itswo'))
    timer = EpochTimer('phase 13 square44_itswo', every=10)
    kernels.reset_launch_counts()
    train(config, device, logger=timer)
    energies = [r['energy'] for r in timer.records]
    print(f'phase 13 square44_itswo (conv_2d {config.num_conv_layers}x'
          f'{config.num_conv_filters}, {config.batch_size} chains x '
          f'{config.num_batches_per_epoch} batches, generic sampler): '
          f'{len(energies)} epochs, E first {energies[0]:.6f}, mean of last '
          f'3 {np.mean(energies[-3:]):.6f}, acceptance '
          f'{timer.records[-1]["acceptance_rate"]:.4f}, K2 launches '
          f'{kernels.rbm_sweeps_prng.launches}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms over epochs 2-{SQUARE44_EPOCHS} '
          f'{card}', flush=True)
    require(len(energies) == SQUARE44_EPOCHS and all(np.isfinite(energies)),
            'square44_itswo: non-finite energy')
    require(np.mean(energies[-3:]) < energies[0],
            'square44_itswo: energy did not fall')


def phase_distill_exact(device, kernels, card: str) -> None:
    """14. The four supervised optimizers distill the 4x4 ED ground state
    into an RBM through `distill`; each reaches its JAX bar."""
    from cgs_vmc_tpu_torch import basis, lattice, models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import (evaluate_vector,
                                            overlap_with_vector)
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.optim import SUPERVISED_OPTIMIZERS
    from cgs_vmc_tpu_torch.train import distill
    from cgs_vmc_tpu_torch.utils import ed
    start = time.perf_counter()
    e0, v0 = ed.ground_state(16, lattice.square_lattice_bonds(4, 4),
                             j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    target = FullVector.for_sector(16, vector)
    target_params = {'ed_vector': torch.tensor(vector, device=device)}
    states = basis.enumerate_sz_basis(16)
    print(f'phase 14 target: 4x4 ED E0 = {e0:.6f}, {len(states)} states, '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    for name in sorted(SUPERVISED_OPTIMIZERS):
        config = Config(**DISTILL, wavefunction_optimizer_type=name,
                        num_epochs=DISTILL_EPOCHS)
        timer = EpochTimer(f'phase 14 {name}', every=20)
        kernels.reset_launch_counts()
        state = distill(config, device, target_params=target_params,
                        target_wf=target, logger=timer)
        launches = kernels.rbm_sweeps_prng.launches
        wf = models.build_wavefunction(config)
        fidelity = overlap_with_vector(
            evaluate_vector(wf, state.params, config, basis_array=states),
            vector)
        bar = JAX_FIDELITY[name] - FIDELITY_MARGIN
        last = ' '.join(f'{k}={v:.6g}'
                        for k, v in metrics_items(timer.records[-1]))
        expected = (0 if name == 'BasisIterSWO'
                    else DISTILL_EPOCHS * config.num_batches_per_epoch)
        print(f'phase 14 {name}: fidelity {fidelity:.6f} (JAX on the CPU '
              f'{JAX_FIDELITY[name]:.6f}, bar {bar:.6f}); last epoch {last}; '
              f'K2 launches {launches} (expected {expected}); mean epoch '
              f'{timer.mean_epoch_ms():.2f} ms {card}', flush=True)
        require(np.isfinite(fidelity) and fidelity >= bar,
                f'{name}: fidelity {fidelity} below its bar {bar}')
        require(launches == expected,
                f'{name}: K2 launched {launches} times, expected {expected}')


def phase_distill_run(repo: str, device, kernels, supervisor_dir: str,
                      card: str) -> None:
    """15. `distill` from phase 12's ITSWO run directory (the CLI's path),
    then `evaluate_operator` on the student."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.train import build_hamiltonian, distill
    from cgs_vmc_tpu_torch.utils import checkpoint
    config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
    config = config.parse(
        'wavefunction_optimizer_type=LogOverlapSWO,optimizer=adam,'
        'learning_rates=[1e-2],learning_rate_stops=[],'
        f'num_epochs={DISTILL_RUN_EPOCHS}')
    config = config.replace(
        supervisor_dir=supervisor_dir,
        checkpoint_dir=fresh_run_dir(repo, 'chip_smoke_distill'))
    timer = EpochTimer('phase 15 distill')
    kernels.reset_launch_counts()
    state = distill(config, device, logger=timer)
    launches = kernels.rbm_sweeps_prng.launches
    ratios = [r['mean_ratio'] for r in timer.records]
    latest = checkpoint.latest_checkpoint(config.checkpoint_dir)
    result = evaluate_operator(models.build_wavefunction(config),
                               state.params, build_hamiltonian(config),
                               config, device)
    n = config.num_sites
    e, err = result.mean / n, result.error / n
    print(f'phase 15 distill LogOverlapSWO from {supervisor_dir} (RBM H='
          f'{config.fc_layer_size}, {config.batch_size} chains, '
          f'{DISTILL_RUN_EPOCHS} epochs): mean_ratio {ratios}, K2 launches '
          f'{launches} ({launches / DISTILL_RUN_EPOCHS:g} an epoch), '
          f'checkpoint {latest}; student E/N = {e:.6f} +/- '
          f'{err:.6f}, acceptance {result.acceptance_rate:.4f}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms {card}', flush=True)
    require(all(np.isfinite(ratios)), 'distill: non-finite mean_ratio')
    expected = DISTILL_RUN_EPOCHS * config.num_batches_per_epoch
    require(launches == expected,
            f'distill launched K2 {launches} times, expected {expected}')
    require(latest is not None
            and checkpoint.checkpoint_epoch(latest) == DISTILL_RUN_EPOCHS,
            'distill wrote no final checkpoint')
    require(np.isfinite(e) and np.isfinite(err), 'non-finite student E/N')
    require(e >= BETHE_E_PER_SITE - 5 * err,
            f'student E/N {e} below the variational bound')


def exact_energy(hamiltonian, n_sites: int) -> float:
    """ED ground energy (Sz=0 sector) of the Hamiltonian a config builds:
    its bonds, couplings and twist phases."""
    from cgs_vmc_tpu_torch.utils import ed
    return ed.ground_state(
        n_sites, hamiltonian.bonds, j_x=hamiltonian.j_x, j_z=hamiltonian.j_z,
        couplings=hamiltonian.couplings,
        offdiag_couplings=hamiltonian.offdiag_couplings,
        twist_phases=hamiltonian.twist_phases)[0]


def phase_complex_config(repo: str, device, phase: int, name: str, card: str):
    """16.-17. configs/{name}.json unmodified through `train` (its own
    epochs and seed), then `evaluate_operator`.  Returns (tail mean of the
    training energies, evaluation result, ED energy, relative error)."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.sampler import registry
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    start = time.perf_counter()
    config = Config.load(os.path.join(repo, 'configs', f'{name}.json'))
    config = config.replace(checkpoint_dir=fresh_run_dir(
        repo, f'chip_smoke_{name}'))
    timer = EpochTimer(f'phase {phase} {name}', every=50)
    state = train(config, device, logger=timer)
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    result = evaluate_operator(wf, state.params, hamiltonian, config, device)
    e0 = exact_energy(hamiltonian, config.num_sites)
    energies = [r['energy'] for r in timer.records]
    tail = float(np.mean(energies[-10:]))
    rel = (result.mean - e0) / abs(e0)
    samples = config.batch_size * config.num_batches_per_epoch
    print(f'phase {phase} {name} (complex('
          f'{" x ".join(config.composite_wavefunction_types)}), '
          f'{config.batch_size} chains x {config.num_batches_per_epoch} '
          f'batches, dense SR on [{2 * samples}, {2 * samples}], twist '
          f'{getattr(config, "twist_phi", 0.0)}, sampler '
          f'{registry.resolved_name(wf, config)}): {len(energies)} epochs, '
          f'E first {energies[0]:.6f}, mean of last 10 {tail:.6f}; evaluated '
          f'E = {result.mean:.6f} +/- {result.error:.6f}, ED {e0:.6f}, rel '
          f'err {rel:.5f} (the JAX package on the CPU: '
          f'{JAX_COMPLEX_REL_ERR[name]:.5f}), log_amp dtype '
          f'{state.sampler.log_amp.dtype}, acceptance '
          f'{result.acceptance_rate:.4f}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms {card}; wall time '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    require(len(energies) == config.num_epochs
            and all(np.isfinite(energies)), f'{name}: non-finite energy')
    require(state.sampler.log_amp.dtype == torch.complex64,
            f'{name}: the sampler state lost its complex log')
    require(np.isfinite(result.mean) and np.isfinite(result.error),
            f'{name}: non-finite evaluated energy')
    require(result.mean >= e0 - 5 * result.error,
            f'{name}: evaluated E {result.mean} below the ED energy {e0}')
    return tail, result, e0, rel


def phase_stiffness(device, card: str) -> None:
    """17. The spin-stiffness ansatz at phi = 0 and 1.2 through `train`
    (cold starts); the energy difference beside twisted ED's."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    found = {}
    for phi in STIFFNESS_PHIS:
        config = Config(
            num_sites=16, wavefunction_type='complex',
            composite_wavefunction_types=['rbm', 'fully_connected'],
            num_fc_layers=1, fc_layer_size=48, batch_size=512,
            num_batches_per_epoch=2, num_equilibration_sweeps=4,
            num_monte_carlo_sweeps=1, learning_rates=[0.05, 0.02],
            learning_rate_stops=[STIFFNESS_EPOCHS // 2],
            optimizer='gradient', heisenberg_jx=-1.0, sr_diag_shift=1e-3,
            sr_solver='dense', sr_delta_clip=1.0, twist_phi=phi,
            wavefunction_optimizer_type='SR', num_epochs=STIFFNESS_EPOCHS,
            seed=3)
        timer = EpochTimer(f'phase 17 stiffness phi={phi}', every=100)
        train(config, device, logger=timer)
        tail = np.array([r['energy']
                         for r in timer.records[-STIFFNESS_TAIL:]])
        found[phi] = (float(tail.mean()), float(
            tail.std() / np.sqrt(len(tail))),
            exact_energy(build_hamiltonian(config), 16),
            timer.mean_epoch_ms())
        require(bool(np.isfinite(tail).all()),
                f'stiffness phi={phi}: non-finite energy')
    (e_a, err_a, ed_a, ms_a), (e_b, err_b, ed_b, ms_b) = (
        found[phi] for phi in STIFFNESS_PHIS)
    print(f'phase 17 spin stiffness, complex(rbm x fc 48), N=16, 512 chains '
          f'x 2, {STIFFNESS_EPOCHS} epochs each (tail {STIFFNESS_TAIL}): '
          f'E(0) = {e_a:.5f} +/- {err_a:.5f} (ED {ed_a:.5f}), '
          f'E({STIFFNESS_PHIS[1]}) = {e_b:.5f} +/- {err_b:.5f} (ED '
          f'{ed_b:.5f}); dE = {e_b - e_a:+.5f} +/- '
          f'{np.hypot(err_a, err_b):.5f}, twisted ED dE = '
          f'{ed_b - ed_a:+.5f}; mean epoch {ms_a:.2f} / {ms_b:.2f} ms '
          f'{card}', flush=True)


def phase_sampler_cells(device, card: str) -> None:
    """18. Generic against incremental sweeps at 6x6, 2048 chains.  The two
    samplers of a cell take turns, SAMPLER_REPS timed calls each, and the
    median rate is the cell's: the calls are host-bound, and the host's
    speed drifts more between seconds than the samplers differ."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.sampler import metropolis, registry
    for wf_type, extra, fast_name, same_move in SAMPLER_CELLS:
        config = Config(num_sites=36, size_x=6, size_y=6,
                        wavefunction_type=wf_type, batch_size=CHAINS, **extra)
        generic = config.replace(use_fast_sampler=False,
                                 mps_incremental_sweeps=False)
        wf = models.build_wavefunction(config)
        params = wf.init(torch.Generator(device=device).manual_seed(18))
        sweeps, states, rates = {}, {}, {}
        for label, cfg in (('generic', generic), (fast_name, config)):
            require(registry.resolved_name(wf, cfg) == label,
                    f'{wf_type}: the registry resolved '
                    f'{registry.resolved_name(wf, cfg)}, not {label}')
            sweeps[label] = registry.resolve_sweeps_fn(wf, cfg)
            state = metropolis.init_sampler_for(18, wf, params, cfg, device)
            states[label] = metropolis.reset_stats(
                sweeps[label](params, state, SAMPLER_WARM_SWEEPS))
            rates[label] = []
        for _ in range(SAMPLER_REPS):
            for label in sweeps:
                states[label], seconds = timed(lambda: sweeps[label](
                    params, states[label], SAMPLER_SWEEPS))
                rates[label].append(SAMPLER_SWEEPS / seconds)
                state = states[label]
                with torch.no_grad():
                    fresh = wf.apply(params, state.configs)
                gap = float(((state.log_amp - fresh.log).abs()
                             / (1.0 + fresh.log.abs())).max())
                require(gap <= TOL and torch.equal(state.sign, fresh.sign),
                        f'{wf_type} {label}: cached logpsi off a fresh '
                        f'forward by {gap}')
                require(bool((state.configs.sum(dim=1) == 0).all()),
                        f'{wf_type} {label}: a chain left the Sz=0 sector')
        accs = {label: float(metropolis.acceptance_rate(state))
                for label, state in states.items()}
        rate = {label: float(np.median(r)) for label, r in rates.items()}
        detail = ', '.join(f'{k}={v}' for k, v in extra.items()
                           if k != 'mps_incremental_sweeps')
        print(f'phase 18 sampler cell {wf_type}{" " + detail if detail else ""}'
              f', N=36, {CHAINS} chains, median of {SAMPLER_REPS} calls of '
              f'{SAMPLER_SWEEPS} sweeps taken in turns: generic '
              f'{rate["generic"]:.2f} sweeps/s (acceptance '
              f'{accs["generic"]:.4f}; calls '
              f'{", ".join(f"{r:.2f}" for r in rates["generic"])}), '
              f'{fast_name} {rate[fast_name]:.2f} sweeps/s (acceptance '
              f'{accs[fast_name]:.4f}; calls '
              f'{", ".join(f"{r:.2f}" for r in rates[fast_name])}), ratio '
              f'{rate[fast_name] / rate["generic"]:.2f}x {card}', flush=True)
        for label, acc in accs.items():
            require(0.0 < acc < 1.0, f'{wf_type} {label}: acceptance {acc}')
        if same_move:
            require(abs(accs['generic'] - accs[fast_name]) < SAMPLER_ACC_TOL,
                    f'{wf_type}: acceptance of {fast_name} differs from the '
                    f'generic sampler\'s by more than {SAMPLER_ACC_TOL}')


def phase_families(repo: str, device, card: str) -> None:
    """19. One short SR run through `train` for each ansatz family."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.sampler import registry
    from cgs_vmc_tpu_torch.train import train
    n = FAMILY_BASE['num_sites']
    adjacency = os.path.join(repo, 'build', 'chip_smoke_adjacency.txt')
    os.makedirs(os.path.dirname(adjacency), exist_ok=True)
    np.savetxt(adjacency, [[s, (s - 1) % n, (s + 1) % n] for s in range(n)],
               fmt='%d')
    for label, overrides, sampler in FAMILIES:
        config = Config(**{**FAMILY_BASE, **overrides})
        if label == 'gnn':
            config = config.replace(adjacency_list_path=adjacency)
        resolved = registry.resolved_name(models.build_wavefunction(config),
                                          config)
        require(resolved == sampler,
                f'{label}: the registry resolved {resolved}, not {sampler}')
        timer = EpochTimer(f'phase 19 {label}', every=config.num_epochs)
        train(config, device, logger=timer)
        energies = [r['energy'] for r in timer.records]
        print(f'phase 19 {label} (N=16 chain, SR dense, {config.batch_size} '
              f'chains x {config.num_batches_per_epoch}, sampler {resolved}):'
              f' {len(energies)} epochs, E first {energies[0]:.6f}, mean of '
              f'last 3 {np.mean(energies[-3:]):.6f}, acceptance '
              f'{timer.records[-1]["acceptance_rate"]:.4f}; mean epoch '
              f'{timer.mean_epoch_ms():.2f} ms {card}', flush=True)
        require(len(energies) == config.num_epochs
                and all(np.isfinite(energies)),
                f'{label}: non-finite SR training energy')
        require(np.mean(energies[-3:]) < energies[0],
                f'{label}: SR training energy did not fall')


def phase_build(kernels) -> None:
    """2. nvcc builds the kernels; ptxas's registers and spills of the
    instances the bench and slice shapes run, at every width."""
    start = time.perf_counter()
    kernels.build()
    print(f'phase 2 build: kernels loaded in '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    mismatches = kernels.log1p_mismatches(torch.device('cuda'))
    print(f'phase 2 branch-free log1p vs log1pf over every float in [0, 1]: '
          f'{mismatches} differ', flush=True)
    require(mismatches == 0, 'the kernels\' log1p is not log1pf')
    resources = kernels.kernel_resources()
    for shape, (n_sites, hidden) in SHAPES.items():
        for g in kernels.LANES:
            if -(-hidden // g) > kernels.MAX_UNITS_PER_LANE:
                continue
            inst = kernels.instance(n_sites, hidden, g)
            for kernel in ('K1', 'K2'):
                rec = resources[(kernel, *inst)]
                print(f'phase 2 ptxas {kernel} {shape} (G, words, slots) '
                      f'{inst}: {rec.get("registers")} registers, spill '
                      f'stores/loads {rec.get("spill_stores")}/'
                      f'{rec.get("spill_loads")} B', flush=True)


def phase_compare(kernels, device) -> dict:
    """3.-4. Both kernels against their plain versions: the main shapes
    with the rule's width, the other width at 2 sweeps, the edge shapes;
    then K2's equilibrium acceptance against K1's.  Returns the largest
    |Δlogψ| of each kernel."""
    errs = {'rbm_sweeps': 0.0, 'rbm_sweeps_prng': 0.0}
    for i, (shape, sweeps) in enumerate(COMPARISONS):
        n_sites, hidden = SHAPES[shape]
        w, b, a, configs = rbm_inputs(n_sites, hidden, 10 + i, device)
        compare_both(f'{shape} N={n_sites} H={hidden}, {sweeps} sweeps, '
                     f'rule G={kernels.instance(n_sites, hidden)[0]}', w, b, a,
                     configs, sweeps * n_sites, 20 + i, 0, kernels, errs)
    for i, (shape, (n_sites, hidden)) in enumerate(SHAPES.items()):
        w, b, a, configs = rbm_inputs(n_sites, hidden, 30 + i, device)
        for g in kernels.LANES:
            if -(-hidden // g) > kernels.MAX_UNITS_PER_LANE:
                print(f'phase 3-4 {shape} G={g}: refused ({-(-hidden // g)}'
                      f' units a lane > {kernels.MAX_UNITS_PER_LANE})',
                      flush=True)
                continue
            compare_both(f'{shape} N={n_sites} H={hidden}, 2 sweeps, '
                         f'forced G={g}', w, b, a, configs, 2 * n_sites,
                         40 + i, g, kernels, errs)
    for j, (n_sites, hidden, chains) in enumerate(EDGE_SHAPES):
        rule = kernels.instance(n_sites, hidden)[0]
        w, b, a, configs = rbm_inputs(n_sites, hidden, 70 + j, device,
                                      chains)
        for n_steps in (0, rule + 1):
            compare_both(f'edge N={n_sites} H={hidden} {chains} chains, '
                         f'{n_steps} steps, rule G={rule}', w, b, a, configs,
                         n_steps, 100 + j, 0, kernels, errs)

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
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script runs on a '
              'GPU only', file=sys.stderr)
        return 1
    start_all = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from cgs_vmc_tpu_torch.config import Config
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
          f'{torch.__version__}, CUDA {torch.version.cuda}; TF32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, TF32 cuDNN '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)

    # 2. Build.
    phase_build(kernels)

    # 3./4. Kernels against their plain versions.
    errs = phase_compare(kernels, device)

    # 5. Slice: training, launch counters zeroed just before.
    config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
    config = config.parse(
        'wavefunction_optimizer_type=EnergyGradient,optimizer=adam,'
        f'learning_rates=[1e-2],learning_rate_stops=[],num_epochs={EPOCHS}')
    config = config.replace(
        checkpoint_dir=fresh_run_dir(repo, 'chip_smoke_run'))
    kernels.reset_launch_counts()
    timer = EpochTimer()
    state = train(config, 'cuda', logger=timer)
    energies = [r['energy'] for r in timer.records]
    acc = timer.records[-1]['acceptance_rate']
    print(f'phase 5 train: {len(energies)} epochs, E first '
          f'{energies[0]:.6f}, mean of last 5 {np.mean(energies[-5:]):.6f}, '
          f'acceptance {acc:.4f}, K2 launches '
          f'{kernels.rbm_sweeps_prng.launches} '
          f'({kernels.rbm_sweeps_prng.launches / EPOCHS:g} an epoch, G='
          f'{kernels.instance(config.num_sites, config.fc_layer_size)[0]})',
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
    print(f'phase 7 slice epoch (N=40, H=160, {config.batch_size} chains, '
          f'EnergyGradient): mean {timer.mean_epoch_ms():.2f} ms over '
          f'epochs 2-{EPOCHS} {card}', flush=True)
    phase_kernel_times(kernels, device, card)

    # 8.-9. Artifacts and their evaluation.
    phase_artifacts(repo, device)
    phase_eval(repo, device)

    # 10. SR training: the flagship, then chain40 on K2 (counts zeroed).
    flagship = phase_sr_train(repo, device, 'square66_conv_sr',
                              SR_EPOCHS['square66_conv_sr'])
    kernels.reset_launch_counts()
    chain = phase_sr_train(repo, device, 'chain40_sr',
                           SR_EPOCHS['chain40_sr'])
    sr_launches = kernels.rbm_sweeps_prng.launches
    print(f'phase 10 SR path launches: K2 {sr_launches} '
          f'({sr_launches / SR_EPOCHS["chain40_sr"]:g} an epoch), K1 '
          f'{kernels.rbm_sweeps.launches}', flush=True)
    require(sr_launches > 0, 'SR training did not launch the K2 kernel')

    # 11. Times.
    start = time.perf_counter()
    parts = phase_sr_times(flagship[0], flagship[1])
    print(f'phase 11 flagship SR epoch (conv_2d 5x32, C4v x spin flip, '
          f'{parts["samples"]} samples, {parts["params"]} params, dense '
          f'minSR): sr_epoch_wall_s {parts["sr_epoch_wall_s"]:.4f}; '
          f'sampling {parts["sampling_s"]:.4f} s, local energy '
          f'{parts["local_energy_s"]:.4f} s, Jacobian rows '
          f'{parts["jacobian_s"]:.4f} s, assembly + Cholesky solve '
          f'{parts["solve_s"]:.4f} s; TF32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, TF32 cuDNN '
          f'{torch.backends.cudnn.allow_tf32} {card}', flush=True)
    print(f'phase 11 chain40 SR epoch (RBM H=160, '
          f'{chain[0].batch_size * chain[0].num_batches_per_epoch} samples, '
          f'dense SR, K2 sampler): mean {chain[2].mean_epoch_ms():.2f} ms '
          f'over epochs 2-{SR_EPOCHS["chain40_sr"]} {card}; phase 11 wall '
          f'time {time.perf_counter() - start:.2f} s', flush=True)

    # 12.-15. Imaginary-time SWO, the RESULTS.md row-3 config, distillation.
    supervisor_dir = phase_itswo(repo, device, kernels, card)
    phase_square44(repo, device, kernels, card)
    phase_distill_exact(device, kernels, card)
    phase_distill_run(repo, device, kernels, supervisor_dir, card)

    # 16.-17. The complex-phase path: J1-J2 (Majumdar-Ghosh), the twisted
    # chain, the spin-stiffness pair.
    tail, _, _, _ = phase_complex_config(
        repo, device, 16, 'j1j2_chain8_complex_sr', card)
    require(tail < MG_BAR and abs(tail - MG_E0) / abs(MG_E0) < 0.05,
            f'j1j2_chain8_complex_sr: last-10 training mean {tail} misses '
            f'the bar {MG_BAR} / 5% of {MG_E0}')
    _, _, _, rel = phase_complex_config(
        repo, device, 17, 'twisted_chain16_sr', card)
    bar = JAX_COMPLEX_REL_ERR['twisted_chain16_sr'] + TWIST_MARGIN
    require(rel <= bar, f'twisted_chain16_sr: rel err {rel} above the JAX '
            f"package's plus the margin, {bar}")
    phase_stiffness(device, card)

    # 18.-19. The incremental samplers and the ansatz families.
    phase_sampler_cells(device, card)
    phase_families(repo, device, card)

    source = 'cgs_vmc_tpu_torch/csrc/rbm_sweep.cu'
    replaces = {'rbm_sweeps': 'cgs_vmc_tpu/sampler/kernels.py:77',
                'rbm_sweeps_prng': 'cgs_vmc_tpu/sampler/kernels.py:324'}
    # ms, plain_ms and bound_ms: one wrapper call of TIMING_SWEEPS sweeps
    # at the bench shape; no single PyTorch call computes a Metropolis
    # sweep, so library_ms is null.
    n_sites, hidden = SHAPES['bench']
    bounds = {label: sweep_bound(kernel, CHAINS, n_sites, hidden,
                                 TIMING_SWEEPS * n_sites)
              for label, kernel in (('rbm_sweeps', 'K1'),
                                    ('rbm_sweeps_prng', 'K2'))}
    report = {'kernels': [
        {'name': label, 'route': 'cuda', 'source': source,
         'replaces': replaces[label], 'launches': launches[label],
         'max_abs_err': errs[label], 'ms': times[label][0] * 1e3,
         'plain_ms': times[label][1] * 1e3,
         'bound_ms': bounds[label][0] * 1e3, 'bound_by': bounds[label][1],
         'library_ms': None,
         'lanes_per_chain': kernels.instance(n_sites, hidden)[0]}
        for label in ('rbm_sweeps', 'rbm_sweeps_prng')]}
    print(f'chip_smoke: every phase passed in '
          f'{time.perf_counter() - start_all:.1f} s, the build included',
          flush=True)
    print(smi)
    print(json.dumps(report))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
