"""Ground-state training loop (port of cgs_vmc_tpu/train.py: the
Heisenberg branch of build_hamiltonian, and train).

Build ansatz + Hamiltonian + optimizer on an explicit device, then a thin
Python loop of epochs with rotating full-state checkpoints and a metrics
stream.  The JAX train.py's epochs_per_call (a TPU launch-latency fix), EMA
weights, multi-device sharding and distillation are not ported yet; asking
for them raises.  The optimizers are EnergyGradient and SR (optim/sr.py).
Precision on the card: ``resolve_device`` turns TF32 off process-wide for
cuBLAS and cuDNN (so the f32 convs are f32), and SR scopes its own
``sr_matmul_precision`` to the assembly GEMMs.
"""

from __future__ import annotations

import os
from typing import Optional

from cgs_vmc_tpu_torch import lattice, models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS, TrainState
from cgs_vmc_tpu_torch.sampler import registry
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils.device import resolve_device
from cgs_vmc_tpu_torch.utils.metrics import MetricsLogger

# (config field, its default) for features of the JAX train.py not ported
# yet.  The port always writes torch.save checkpoints, so only the default
# checkpoint_backend is accepted (it names no format the port writes).
_UNPORTED = (('epochs_per_call', 1), ('param_ema_decay', 0.0),
             ('num_devices', 1), ('profile_dir', ''),
             ('checkpoint_backend', 'msgpack'))


def build_hamiltonian(config: Config) -> HeisenbergHamiltonian:
    """Heisenberg Hamiltonian with the bonds the JAX package resolves: a
    J-file if present (config.j_file_path, else J.txt in the run
    directory), else the lattice implied by the config."""
    j_file = config.j_file_path
    if not j_file and config.checkpoint_dir:
        candidate = os.path.join(config.checkpoint_dir, 'J.txt')
        if os.path.exists(candidate):
            j_file = candidate
    if j_file:
        bonds, couplings = lattice.load_bonds_and_couplings(j_file)
    else:
        bonds, couplings = lattice.bonds_and_couplings_for_config(config)

    family = getattr(config, 'hamiltonian_type', 'heisenberg') or 'heisenberg'
    if family != 'heisenberg':
        raise NotImplementedError(
            f'hamiltonian_type={family!r} is not ported yet (ROADMAP.md)')
    move = getattr(config, 'mc_move_type', 'exchange') or 'exchange'
    if move != 'exchange':
        raise ValueError(
            "hamiltonian_type='heisenberg' requires mc_move_type='exchange':"
            ' single-spin flips leave the Sz sector the Heisenberg ground '
            f'state lives in (got {move!r})')
    if getattr(config, 'twist_phi', 0.0):
        raise NotImplementedError(
            'twist_phi makes local values complex and is not ported yet')
    offdiag = None
    if getattr(config, 'heisenberg_marshall_gauge', False):
        if j_file or not getattr(config, 'heisenberg_j2', 0.0):
            raise ValueError(
                'heisenberg_marshall_gauge applies to the built-in J1-J2 '
                'lattices (heisenberg_j2 != 0, no j_file_path); for pure '
                'nearest-neighbour bipartite lattices use heisenberg_jx=-1')
        bonds, couplings, offdiag = lattice.j1j2_marshall_gauged(config)
    return HeisenbergHamiltonian(
        bonds, config.heisenberg_jx, config.heisenberg_jz,
        sample_chunk=getattr(config, 'energy_chunk_samples', 0),
        couplings=couplings, offdiag_couplings=offdiag)


def _check_ported(config: Config) -> None:
    for field, off in _UNPORTED:
        value = getattr(config, field, off)
        if value != off:
            raise NotImplementedError(
                f'{field}={value!r} is not ported yet (ROADMAP.md)')


def _init_ground_state(config: Config, device):
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    opt_name = config.wavefunction_optimizer_type
    if opt_name not in GROUND_STATE_OPTIMIZERS:
        raise NotImplementedError(
            f'optimizer {opt_name!r} is not ported yet; the port has '
            f'{sorted(GROUND_STATE_OPTIMIZERS)} (ROADMAP.md)')
    optimizer = GROUND_STATE_OPTIMIZERS[opt_name](wf, hamiltonian, config)
    state = optimizer.init_state(config.seed, device, config.batch_size)
    return wf, optimizer, state


def train(config: Config, device, resume: bool = False,
          logger: Optional[MetricsLogger] = None) -> TrainState:
    """Ground-state optimization on `device`.

    Saves config.json and rotating full-state checkpoints (the state before
    epoch n as ckpt_epoch_n, and the final state), appends per-epoch
    metrics, and returns the final TrainState.  resume=True continues from
    the run directory's latest checkpoint.
    """
    device = resolve_device(device)
    _check_ported(config)
    wf, optimizer, state = _init_ground_state(config, device)
    out_dir = config.checkpoint_dir
    if out_dir:
        ckpt_lib.save_config(out_dir, config)

    start_epoch = 0
    if resume and out_dir:
        latest = ckpt_lib.latest_checkpoint(out_dir)
        if latest:
            state = ckpt_lib.restore_checkpoint(latest, device)
            start_epoch = ckpt_lib.checkpoint_epoch(latest)
            print(f'Resumed from {latest} (epoch {start_epoch})')
    registry.check_state(wf, config, state.sampler)
    logger = logger or MetricsLogger(out_dir)

    for epoch in range(start_epoch, config.num_epochs):
        if out_dir and epoch % config.checkpoint_frequency == 0:
            ckpt_lib.save_checkpoint(out_dir, state, epoch,
                                     config.max_checkpoints_to_keep)
        state, metrics = optimizer.epoch(state)
        logger.log(epoch + 1, metrics)

    if out_dir:
        ckpt_lib.save_checkpoint(out_dir, state, config.num_epochs,
                                 config.max_checkpoints_to_keep)
    return state
