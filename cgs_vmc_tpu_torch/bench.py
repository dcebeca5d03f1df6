"""Throughput bench of the port on one NVIDIA GPU (counterpart of the JAX
package's root ``bench.py``).

    python -m cgs_vmc_tpu_torch.bench

Prints ONE JSON line with the JAX bench's fields, from the same shapes and
by the same formulas:

  {"metric": "...", "value": N, "unit": "sweeps/s", "vs_baseline": N,
   "extra": {...}}

Primary metric: Metropolis exchange sweeps/s with 2048 chains on the 6×6
lattice (one sweep = 36 exchange moves a chain), an RBM with 64 hidden
units, sampled by K2 (``sampler/kernels.rbm_sweeps_prng``, draws made in
the kernel) at 800 sweeps a call; the acceptance rate is checked against a
band.  Secondary: the streamed-draw kernel K1, one call; one flagship SR
epoch (configs/square66_conv_sr.json's model: symmetrized conv_2d 5×32,
4096 samples, dense minSR) per call and in blocks of 5; MADE exact draws.

``vs_baseline`` and the ``sr_epoch_*a100_roofline*`` keys are the JAX
bench's ratios to a derived A100 basis (BASELINE.md "The A100-class
basis"), kept so the two lines read alike; they are not a measurement of
any card.  ``extra.device`` names the card that produced every number.

Every timed region ends in ``torch.cuda.synchronize()`` and a read of a
value on the host.  Sweep reps and epoch reps are taken in turns in one
pass; a pass whose spread (max − min over the median) exceeds
SPREAD_THRESHOLD is repeated, up to MAX_PASSES, and the pass with the
lowest spread is reported.  A failure propagates: the process exits
non-zero and prints no line.  Without CUDA it exits 1 and prints no line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import Callable, List, NamedTuple, Optional

import torch

from cgs_vmc_tpu_torch import basis, lattice, models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_tpu_torch.models.base import tree_leaves
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_tpu_torch.sampler import kernels
from cgs_vmc_tpu_torch.utils import profiling
from cgs_vmc_tpu_torch.utils.device import resolve_device

METRIC = 'metropolis_sweeps_per_sec_per_chip_6x6_rbm_2048chains'

# --- Shapes and the derived A100-class bases (BASELINE.md). --------------
N_SITES = 36
N_CHAINS = 2048
HIDDEN = 64
# Memory-bound incremental CUDA RBM kernel: 600 B/move over 2.0 TB/s.
A100_MOVES_PER_SEC = 2.0e12 / 600.0
A100_SWEEPS_PER_SEC = A100_MOVES_PER_SEC / (N_CHAINS * N_SITES)  # ~45.2k
# Reference architecture: one TF1 graph call per move at ~1 ms dispatch.
REFERENCE_SWEEPS_PER_SEC = 1000.0 / N_SITES
# A100 end-to-end epoch roofline: 50%-utilized TF32 tensor peak.
A100_EFFECTIVE_FLOPS = 0.5 * 156e12

SWEEPS_PER_CALL = 800
SWEEP_REPS = 5
EPOCH_REPS = 5
FUSED_REPS = 3
K_FUSED = 5
SPREAD_THRESHOLD = 0.10
MAX_PASSES = 3
MADE_BATCH = 2048
MADE_REPS = 3


def _synchronize(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _median(times):
    return sorted(times)[len(times) // 2]


def _dispatch_latency_ms(device: torch.device, reps: int = 9) -> float:
    """Median round trip of a trivial op on `device` read back on the host:
    the floor any per-call timing pays (JAX bench.py:74-85)."""
    x = torch.zeros((), device=device)
    (x + 1.0).item()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        (x + 1.0).item()
        times.append(time.perf_counter() - t0)
    return round(_median(times) * 1000, 4)


def _spread(times):
    return (max(times) - min(times)) / _median(times)


class SweepBench:
    """K2 at the bench shape (one warm-up call made at construction), reps
    of `sweeps_per_call` sweeps from the chains the previous rep left, a
    new seed each rep; `finalize` checks the acceptance band and times one
    K1 call (JAX bench.py:93-151, prepare_rbm_kernel).  The shape
    arguments are test seams: the bench itself uses the defaults."""

    def __init__(self, device, n_sites: int = N_SITES, hidden: int = HIDDEN,
                 n_chains: int = N_CHAINS,
                 sweeps_per_call: int = SWEEPS_PER_CALL):
        self.device = torch.device(device)
        self.sweeps_per_call = sweeps_per_call
        self.n_steps = sweeps_per_call * n_sites
        self.n_sites, self.n_chains = n_sites, n_chains
        gen = torch.Generator(device=self.device).manual_seed(0)
        self.w = 0.05 * torch.randn((n_sites, hidden), generator=gen,
                                    device=self.device)
        self.b = torch.zeros(hidden, device=self.device)
        self.a = torch.zeros(n_sites, device=self.device)
        self.configs = basis.random_configurations(
            torch.Generator(device=self.device).manual_seed(1), n_sites,
            n_chains)
        self.out = kernels.rbm_sweeps_prng(self.w, self.b, self.a,
                                           self.configs, self.n_steps, 7)
        _synchronize(self.device)
        self.accepted = 0.0
        self.proposals = 0
        self.seed = 100

    def rep(self) -> float:
        """Seconds of one K2 call, its accepted count read on the host."""
        t0 = time.perf_counter()
        out = kernels.rbm_sweeps_prng(self.w, self.b, self.a,
                                      self.out.configs, self.n_steps,
                                      self.seed)
        _synchronize(self.device)
        accepted = out.num_accepted.sum().item()
        elapsed = time.perf_counter() - t0
        self.out = out
        self.seed += 1
        self.accepted += accepted
        self.proposals += self.n_steps * self.n_chains
        return elapsed

    def finalize(self) -> dict:
        """Raises when the reps' acceptance is outside (0.05, 0.98); then
        one timed K1 call (picks drawn outside it, its log-uniforms and
        the kernel inside it, as the JAX kernel draws them itself), kept
        with its inputs as `streamed_call` = (configs, picks, log_u, out)
        for a comparison with the plain version."""
        acceptance = self.accepted / self.proposals
        if not 0.05 < acceptance < 0.98:
            raise RuntimeError(f'implausible acceptance {acceptance}')
        gen = torch.Generator(device=self.device)
        picks = kernels.sample_picks(gen.manual_seed(2), self.n_steps,
                                     self.n_sites, self.n_chains)
        shape = (self.n_steps, self.n_chains)
        log_u = torch.log(torch.rand(shape, generator=gen.manual_seed(3),
                                     device=self.device))
        s_out = kernels.rbm_sweeps(self.w, self.b, self.a, self.configs,
                                   picks, log_u)
        _synchronize(self.device)
        del log_u
        gen.manual_seed(4)
        configs = s_out.configs
        t0 = time.perf_counter()
        log_u = torch.log(torch.rand(shape, generator=gen,
                                     device=self.device))
        s_out = kernels.rbm_sweeps(self.w, self.b, self.a, configs, picks,
                                   log_u)
        _synchronize(self.device)
        s_out.num_accepted.sum().item()
        t_streamed = time.perf_counter() - t0
        self.streamed_call = (configs, picks, log_u, s_out)
        return {
            'kernel': 'in-kernel prng (rbm_sweeps_prng)',
            'acceptance': acceptance,
            'streamed_kernel_sweeps_per_sec': round(
                self.sweeps_per_call / t_streamed, 1),
        }


def _flagship_config() -> Config:
    """RESULTS.md row 4, the headline 6×6 run (JAX bench.py:153-175)."""
    return Config(num_sites=36, size_x=6, size_y=6,
                  wavefunction_type='conv_2d', num_conv_layers=5,
                  num_conv_filters=32, kernel_size=3,
                  wavefunction_optimizer_type='SR',
                  batch_size=1024, num_batches_per_epoch=4,
                  num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
                  learning_rates=[0.02], learning_rate_stops=[],
                  optimizer='gradient', heisenberg_jx=-1.0,
                  sr_diag_shift=1e-2, sr_solver='dense',
                  sr_delta_clip=1.0, symmetrize=True,
                  sr_matmul_precision='high',
                  energy_chunk_samples=128, sr_jacobian_chunk=512, seed=11)


def _flagship_epoch_flops(cfg: Config, n_params: int) -> int:
    """Analytic FLOP count of one SR epoch, for the A100 roofline only
    (JAX bench.py:177-194)."""
    spatial = cfg.size_x * cfg.size_y
    k2 = cfg.kernel_size ** 2
    f = cfg.num_conv_filters
    fwd = 2 * spatial * k2 * (1 * f + (cfg.num_conv_layers - 1) * f * f)
    orbit = 16 if cfg.symmetrize else 1          # C4v x spin flip
    fwd_orbit = fwd * orbit
    m = cfg.batch_size * cfg.num_batches_per_epoch
    sweeps = (cfg.num_equilibration_sweeps
              + cfg.num_batches_per_epoch * cfg.num_monte_carlo_sweeps)
    sampling = sweeps * cfg.num_sites * cfg.batch_size * fwd_orbit
    n_bonds = 2 * cfg.num_sites                  # periodic square lattice
    local_energy = m * (n_bonds + 1) * fwd_orbit
    jacobian = m * 3 * fwd_orbit                 # fwd + ~2x fwd backward
    minsr = 2 * m * m * n_params + 2 * m * n_params  # JJ^T + J^T y
    return sampling + local_energy + jacobian + minsr


def _flagship_summary(cfg: Config, n_params: int, percall_s: float,
                      fused_s: float, k_fused: int = K_FUSED) -> dict:
    """The JAX bench's epoch keys from the median per-call and fused epoch
    seconds (JAX bench.py:244-271)."""
    samples = cfg.batch_size * cfg.num_batches_per_epoch
    flops = _flagship_epoch_flops(cfg, n_params)
    a100_epoch_s = flops / A100_EFFECTIVE_FLOPS
    return {
        'sr_epoch_timing_basis': (
            f'fused: {k_fused} epochs a call as epochs_per_call runs them '
            f'(a loop of eager epochs, one synchronized read at the end), '
            f'median of {FUSED_REPS}; percall: one epoch and a synchronized '
            f'read, median of {EPOCH_REPS}; reps interleaved with the sweep '
            f'kernel'),
        'sr_epoch_wall_s_percall': round(percall_s, 4),
        'sr_epoch_wall_s': round(fused_s, 4),
        'sr_epoch_samples_per_sec': round(samples / fused_s, 1),
        'sr_epoch_samples_per_sec_percall': round(samples / percall_s, 1),
        'sr_epoch_flops_est': float(f'{flops:.3e}'),
        'sr_epoch_a100_roofline_s': round(a100_epoch_s, 4),
        'sr_epoch_vs_a100_roofline': round(a100_epoch_s / fused_s, 3),
        'sr_epoch_vs_a100_roofline_percall': round(
            a100_epoch_s / percall_s, 3),
    }


class FlagshipEpochBench:
    """The flagship SR epoch through the port's SR optimizer: one epoch a
    call (`percall_rep`) and `k_fused` epochs a call (`fused_rep`), each
    ending in a synchronized read of the energy (JAX bench.py:196-273,
    prepare_flagship_sr_epoch).  One epoch is run at construction as the
    warm-up: the JAX bench also warms a block, a program compiled apart,
    but here a block is the same eager epochs.  `config` and `k_fused` are
    test seams: the bench itself uses the defaults."""

    def __init__(self, device, config: Optional[Config] = None,
                 k_fused: int = K_FUSED):
        self.device = torch.device(device)
        self.cfg = config or _flagship_config()
        self.k_fused = k_fused
        wf = models.build_wavefunction(self.cfg)
        ham = HeisenbergHamiltonian(
            lattice.square_lattice_bonds(self.cfg.size_x, self.cfg.size_y),
            self.cfg.heisenberg_jx, 1.0,
            sample_chunk=self.cfg.energy_chunk_samples)
        self.opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, self.cfg)
        self.state = self.opt.init_state(self.cfg.seed, self.device)
        self.percall_rep()

    def _read_energy(self, metrics) -> None:
        _synchronize(self.device)
        energy = metrics['energy'].item()
        if not math.isfinite(energy):
            raise RuntimeError(f'non-finite SR energy {energy}')

    def percall_rep(self) -> float:
        t0 = time.perf_counter()
        self.state, metrics = self.opt.epoch(self.state)
        self._read_energy(metrics)
        return time.perf_counter() - t0

    def fused_rep(self) -> float:
        """Seconds an epoch of a block of k_fused epochs: the port's
        `epochs_per_call` is the same epochs in a loop (train.py), so
        this differs from `percall_rep` only by the reads it saves."""
        t0 = time.perf_counter()
        for _ in range(self.k_fused):
            self.state, metrics = self.opt.epoch(self.state)
        self._read_energy(metrics)
        return (time.perf_counter() - t0) / self.k_fused

    def finalize(self, percall_s: float, fused_s: float) -> dict:
        n_params = sum(p.numel() for p in tree_leaves(self.state.params))
        return _flagship_summary(self.cfg, n_params, percall_s, fused_s,
                                 self.k_fused)


def check_made_draws(draws: torch.Tensor, batch: int) -> None:
    """Raises unless `draws` is [batch, N_SITES] of ±1 in the Sz=0
    sector."""
    if tuple(draws.shape) != (batch, N_SITES):
        raise RuntimeError(f'MADE draws have shape {tuple(draws.shape)}, '
                           f'expected {(batch, N_SITES)}')
    if not bool(((draws.abs() == 1.0).all()
                 & (draws.sum(dim=1) == 0).all())):
        raise RuntimeError('a MADE draw is not a ±1 board with Sz = 0')


def bench_made_exact_sampling(device, batch: int = MADE_BATCH) -> dict:
    """i.i.d. ancestral draws/s from the 36-site MADE (H=64, one hidden
    layer: the incremental path), median of MADE_REPS synchronized calls
    (JAX bench.py:275-298).  Each draw is an independent sample, so this
    is not comparable to Metropolis sweeps.  `batch` is a test seam: the
    bench itself draws MADE_BATCH."""
    device = torch.device(device)
    wf = AutoregressiveSpinModel(N_SITES, hidden=64, num_hidden_layers=1)
    params = wf.init(torch.Generator(device=device).manual_seed(11))
    wf.sample(params, torch.Generator(device=device).manual_seed(0), batch)
    _synchronize(device)
    times = []
    for rep in range(MADE_REPS):
        gen = torch.Generator(device=device).manual_seed(rep + 1)
        t0 = time.perf_counter()
        out = wf.sample(params, gen, batch)
        _synchronize(device)
        out[0, 0].item()
        times.append(time.perf_counter() - t0)
        check_made_draws(out, batch)
    return {'made_exact_samples_per_sec': round(batch / _median(times), 1)}


class Timings(NamedTuple):
    sweep_t: List[float]
    percall_t: List[float]
    fused_t: List[float]
    passes: int
    dispatch_ms_before: float
    dispatch_ms_after: float


def _measure_interleaved(sweep_rep: Callable, percall_rep: Callable,
                         fused_rep: Callable):
    """One measurement pass: per-call epoch, sweep and fused-epoch reps in
    turns, so ambient load hits all three alike (JAX bench.py:301-316)."""
    sweep_t, percall_t, fused_t = [], [], []
    for i in range(max(SWEEP_REPS, EPOCH_REPS, FUSED_REPS)):
        if i < EPOCH_REPS:
            percall_t.append(percall_rep())
        if i < SWEEP_REPS:
            sweep_t.append(sweep_rep())
        if i < FUSED_REPS:
            fused_t.append(fused_rep())
    return sweep_t, percall_t, fused_t


def measure_passes(sweep_rep: Callable, percall_rep: Callable,
                   fused_rep: Callable):
    """(sweep_t, percall_t, fused_t, passes): passes are repeated while
    any rep spread exceeds SPREAD_THRESHOLD, up to MAX_PASSES, and the
    pass with the lowest largest spread wins (JAX bench.py:398-430)."""
    passes = []
    while len(passes) < MAX_PASSES:
        sweep_t, percall_t, fused_t = _measure_interleaved(
            sweep_rep, percall_rep, fused_rep)
        worst = max(_spread(sweep_t), _spread(percall_t), _spread(fused_t))
        passes.append((worst, sweep_t, percall_t, fused_t))
        if worst <= SPREAD_THRESHOLD:
            break
    _, sweep_t, percall_t, fused_t = min(passes, key=lambda p: p[0])
    return sweep_t, percall_t, fused_t, len(passes)


def report(timings: Timings, finalizers: List[dict]) -> dict:
    """The JSON line: the primary metric and the spreads from `timings`
    (JAX bench.py:432-505), then each finalizer's keys into extra."""
    sweeps_per_sec = SWEEPS_PER_CALL / _median(timings.sweep_t)
    extra = {
        'moves_per_sec': round(sweeps_per_sec * N_CHAINS * N_SITES),
        'vs_reference_architecture': round(
            sweeps_per_sec / REFERENCE_SWEEPS_PER_SEC, 1),
        'baseline_basis': ('A100 memory-bound incremental CUDA RBM '
                           'sampler, 600 B/move @ 2.0 TB/s '
                           '(BASELINE.md "The A100-class basis")'),
        'sweep_rep_spread': round(_spread(timings.sweep_t), 3),
        'sweep_rep_spread_sweeps_per_sec': round(
            SWEEPS_PER_CALL / min(timings.sweep_t)
            - SWEEPS_PER_CALL / max(timings.sweep_t), 1),
        'epoch_percall_spread': round(_spread(timings.percall_t), 3),
        'epoch_fused_spread': round(_spread(timings.fused_t), 3),
        'measurement_passes': timings.passes,
        'dispatch_latency_ms_before': timings.dispatch_ms_before,
        'dispatch_latency_ms_after': timings.dispatch_ms_after,
    }
    for part in finalizers:
        extra.update(part)
    return {
        'metric': METRIC,
        'value': round(sweeps_per_sec, 3),
        'unit': 'sweeps/s',
        'vs_baseline': round(sweeps_per_sec / A100_SWEEPS_PER_SEC, 4),
        'extra': extra,
    }


def device_info() -> dict:
    """The card's nvidia-smi name and power limit, and the versions."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {'nvidia_smi': smi, 'name': torch.cuda.get_device_name(0),
            'torch': torch.__version__, 'cuda': torch.version.cuda}


def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def main() -> int:
    if not torch.cuda.is_available():
        print('cgs_vmc_tpu_torch.bench: CUDA is not available; the bench '
              'runs on a GPU only', file=sys.stderr)
        return 1
    device = resolve_device('cuda')
    card = device_info()
    tf32 = _tf32_flags()
    profiling.reset_counters('k1.launches', 'k2.launches')
    dispatch_before = _dispatch_latency_ms(device)
    sweep = SweepBench(device)
    flagship = FlagshipEpochBench(device)
    sweep_t, percall_t, fused_t, passes = measure_passes(
        sweep.rep, flagship.percall_rep, flagship.fused_rep)
    dispatch_after = _dispatch_latency_ms(device)
    timings = Timings(sweep_t, percall_t, fused_t, passes, dispatch_before,
                      dispatch_after)
    finalizers = [sweep.finalize(),
                  flagship.finalize(_median(percall_t), _median(fused_t)),
                  bench_made_exact_sampling(device)]
    if _tf32_flags() != tf32:
        raise RuntimeError(f'the TF32 flags moved from {tf32} to '
                           f'{_tf32_flags()} during the bench')
    finalizers.append({
        'rbm_sweeps_prng_launches': profiling.counter('k2.launches'),
        'rbm_sweeps_launches': profiling.counter('k1.launches'),
        'device': card,
    })
    print(json.dumps(report(timings, finalizers)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
