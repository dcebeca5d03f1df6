"""Where an SWO epoch's time goes on the card: one profiled epoch of each of
chip_smoke.py's SWO cells, after two warm-up epochs.

    python examples/profile_swo_epochs.py

Cells: chain40 (configs/chain40_sr.json, RBM H=160, 2048 chains, K2) under
ITSWO and LogOverlapITSWO with adam 1e-3 (phase 12); configs/square44_itswo.json
unmodified (phase 13); the 4x4 distillation under SWO and DualSamplingSWO
(phase 14).  For each: the epoch's wall time unprofiled and profiled, the
device work it launched (kernels and copies) and their summed device time,
its share of the profiled wall, and the five kernels that take the most
device time.  Needs a CUDA card; prints the card's name and power limit.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import DISTILL  # noqa: E402
from cgs_vmc_tpu_torch import lattice, models  # noqa: E402
from cgs_vmc_tpu_torch.config import Config  # noqa: E402
from cgs_vmc_tpu_torch.models.full_vector import FullVector  # noqa: E402
from cgs_vmc_tpu_torch.optim import (  # noqa: E402
    GROUND_STATE_OPTIMIZERS, SUPERVISED_OPTIMIZERS)
from cgs_vmc_tpu_torch.train import build_hamiltonian  # noqa: E402
from cgs_vmc_tpu_torch.utils import ed  # noqa: E402
from cgs_vmc_tpu_torch.utils.device import resolve_device  # noqa: E402


def ground_state_cell(config_file, overrides, device):
    config = Config.load(os.path.join(REPO, 'configs', config_file))
    if overrides:
        config = config.parse(overrides)
    opt = GROUND_STATE_OPTIMIZERS[config.wavefunction_optimizer_type](
        models.build_wavefunction(config), build_hamiltonian(config), config)
    return opt, opt.init_state(config.seed, device, config.batch_size)


def distill_cell(name, device):
    _, v0 = ed.ground_state(16, lattice.square_lattice_bonds(4, 4),
                            j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    config = Config(**DISTILL, wavefunction_optimizer_type=name)
    opt = SUPERVISED_OPTIMIZERS[name](models.build_wavefunction(config),
                                      FullVector.for_sector(16, vector),
                                      config)
    return opt, opt.init_state(
        config.seed, device,
        {'ed_vector': torch.tensor(vector, device=device)},
        config.batch_size)


def profile_cell(label, opt, state):
    for _ in range(2):
        state, _ = opt.epoch(state)
    torch.cuda.synchronize()
    start = time.perf_counter()
    state, _ = opt.epoch(state)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - start
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, _ = opt.epoch(state)
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - start
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.time_range.elapsed_us() for e in device_events) * 1e-6
    by_kernel = {}
    for e in device_events:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
            e.time_range.elapsed_us() * 1e-6)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f'{label}: epoch {plain_s * 1e3:.2f} ms unprofiled, '
          f'{profiled_s * 1e3:.2f} ms profiled; {len(device_events)} device '
          f'launches, busy {busy_s * 1e3:.3f} ms ({busy_s / profiled_s:.1%} '
          f'of the profiled wall)', flush=True)
    for name, seconds in top:
        print(f'    {seconds * 1e3:8.3f} ms  {name[:100]}', flush=True)


def main():
    device = resolve_device('cuda')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    for name in ('ITSWO', 'LogOverlapITSWO'):
        profile_cell(f'chain40 {name}', *ground_state_cell(
            'chain40_sr.json',
            f'wavefunction_optimizer_type={name},optimizer=adam,'
            'learning_rates=[1e-3],learning_rate_stops=[]', device))
    profile_cell('square44_itswo', *ground_state_cell(
        'square44_itswo.json', '', device))
    for name in ('SWO', 'DualSamplingSWO'):
        profile_cell(f'4x4 distill {name}', *distill_cell(name, device))


if __name__ == '__main__':
    main()
