"""A multi-process dry run of the sharded training step (the port's
counterpart of ``__graft_entry__.dryrun_multichip``).

    python -c "from cgs_vmc_tpu_torch.parallel import dryrun; \\
        dryrun.dryrun_multichip(2)"

`dryrun_multichip(n)` spawns n CPU processes joined by gloo.  Each builds
the JAX dry run's problem (N=8 Heisenberg chain, RBM with 8 hidden units,
4·n chains in all), runs one EnergyGradient epoch and one SR epoch with the
sharded-Jacobian 'sample_cg' solver over the chains group, and checks that
the energies are finite and that the params are equal on every rank.
Rank 0 prints the JAX dry run's line.  `spawn_ranks` is the launcher: it
starts the ranks, waits for them with a time limit and kills them all if
one fails or the limit passes.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               args: tuple) -> None:
    from cgs_vmc_tpu_torch.parallel.mesh import initialize_distributed
    torch.set_num_threads(1)
    initialize_distributed('gloo', init_method, world_size, rank)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (),
                init_method: str = '', timeout_s: float = 120.0) -> None:
    """Runs ``fn(rank, world_size, *args)`` in `world_size` spawned CPU
    processes that have joined a gloo group (rendezvous through a file,
    `init_method` or a fresh temporary one).  `fn` must be importable by
    name.  Raises if a rank fails or the ranks outlast `timeout_s`."""
    with tempfile.TemporaryDirectory() as tmp:
        if not init_method:
            init_method = 'file://' + os.path.join(tmp, 'rendezvous')
        context = mp.start_processes(
            _rank_main, args=(fn, world_size, init_method, args),
            nprocs=world_size, join=False, start_method='spawn')
        deadline = time.monotonic() + timeout_s
        try:
            while not context.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f'{world_size} ranks ran past {timeout_s} s')
        finally:
            for process in context.processes:
                if process.is_alive():
                    process.kill()
                    process.join()


def _dryrun_rank(rank: int, world_size: int) -> None:
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models import build_wavefunction
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_tpu_torch.optim import (EnergyGradientOptimizer,
                                         StochasticReconfiguration)
    from cgs_vmc_tpu_torch.optim.sr import flatten_params
    from cgs_vmc_tpu_torch.parallel import mesh

    n_sites = 8
    config = Config(
        num_sites=n_sites, wavefunction_type='rbm', num_fc_layers=1,
        fc_layer_size=8, batch_size=4 * world_size,
        num_batches_per_epoch=2, num_equilibration_sweeps=1,
        num_monte_carlo_sweeps=1, heisenberg_jx=-1.0,
        num_devices=world_size)
    wf = build_wavefunction(config)
    hamiltonian = HeisenbergHamiltonian(
        lattice.chain_bonds(n_sites), config.heisenberg_jx, 1.0)
    group = mesh.make_mesh(world_size)

    def run(optimizer, seed):
        state = mesh.shard_train_state(
            optimizer.init_state(seed, 'cpu', config.batch_size), group)
        state, metrics = mesh.sharded_epoch_fn(optimizer.epoch, group)(state)
        flat = flatten_params(state.params)[0]
        every = [torch.empty_like(flat) for _ in range(world_size)]
        dist.all_gather(every, flat, group=group)
        if not all(torch.equal(every[0], p) for p in every):
            raise AssertionError('params differ between ranks')
        energy = float(metrics['energy'])
        if not torch.isfinite(torch.tensor(energy)):
            raise AssertionError(f'non-finite energy from dry run: {energy}')
        return energy, metrics

    energy, metrics = run(EnergyGradientOptimizer(wf, hamiltonian, config),
                          0)
    sr_config = config.replace(
        wavefunction_optimizer_type='SR', sr_solver='sample_cg',
        sr_diag_shift=1e-2, sr_cg_tol=1e-6, sr_cg_maxiter=50,
        sr_delta_clip=1.0, sr_jacobian_chunk=0, optimizer='gradient',
        learning_rates=[0.05], learning_rate_stops=[])
    sr_energy, _ = run(StochasticReconfiguration(wf, hamiltonian,
                                                 sr_config), 1)
    if rank == 0:
        print(f'dryrun_multichip({world_size}): energy={energy:.6f} '
              f'acc={float(metrics["acceptance_rate"]):.3f} '
              f'sr_energy={sr_energy:.6f} OK', flush=True)


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """One EnergyGradient and one sharded SR epoch on `n_devices` gloo
    CPU ranks; raises if a rank fails or the params disagree."""
    spawn_ranks(_dryrun_rank, n_devices, timeout_s=timeout_s)
