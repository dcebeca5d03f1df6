"""Training loops (port of cgs_vmc_tpu/train.py: the Heisenberg branch of
build_hamiltonian, twisted boundaries included, train and distill).

Build ansatz + Hamiltonian (or frozen target) + optimizer on an explicit
device, then a thin Python loop of epochs with rotating full-state
checkpoints and a metrics stream.  The JAX train.py's epochs_per_call (a
TPU launch-latency fix), EMA weights and multi-device sharding are not
ported yet; asking for them raises.  The ground-state optimizers are
EnergyGradient, SR, ITSWO (the default) and LogOverlapITSWO; the
supervised ones SWO (the default), LogOverlapSWO, DualSamplingSWO and
BasisIterSWO.  Every one of them takes a complex-log ansatz
(``wavefunction_type='complex'``).
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
from cgs_vmc_tpu_torch.optim import (
    GROUND_STATE_OPTIMIZERS,
    SUPERVISED_OPTIMIZERS,
    TrainState,
)
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
    offdiag = None
    if getattr(config, 'heisenberg_marshall_gauge', False):
        if j_file or not getattr(config, 'heisenberg_j2', 0.0):
            raise ValueError(
                'heisenberg_marshall_gauge applies to the built-in J1-J2 '
                'lattices (heisenberg_j2 != 0, no j_file_path); for pure '
                'nearest-neighbour bipartite lattices use heisenberg_jx=-1')
        bonds, couplings, offdiag = lattice.j1j2_marshall_gauged(config)
    twist = None
    if getattr(config, 'twist_phi', 0.0):
        # twist_phases assigns each site the coordinate x = site // size_y
        # (or the site itself on a chain); that map holds only for the
        # built-in chain/square indexing.  The honeycomb/kagome/triangular
        # generators and J-files have their own site orderings, for which
        # it would give unphysical phases: refuse instead.
        lattice_type = getattr(config, 'lattice_type', '') or ''
        if lattice_type not in ('', 'auto', 'chain', 'square'):
            raise ValueError(
                'twist_phi is only supported on the built-in chain/square '
                'geometries (site index = x + size_x*y); got '
                f'lattice_type={lattice_type!r}.  Pass explicit '
                'twist_phases to HeisenbergHamiltonian for other '
                'geometries.')
        if j_file:
            raise ValueError(
                'twist_phi cannot be combined with j_file_path: the bond '
                'file carries no site-coordinate information, so per-bond '
                'twist phases cannot be derived.  Build the Hamiltonian '
                'directly with explicit twist_phases.')
        # As bonds_and_couplings_for_config resolves the geometry: square
        # iff size_x*size_y == num_sites with both > 1, else a chain
        # indexed site = x (size_y = 1).
        is_square = (config.size_x > 1 and config.size_y > 1 and
                     config.size_x * config.size_y == config.num_sites)
        size_x = config.size_x if is_square else config.num_sites
        size_y = config.size_y if is_square else 1
        twist = lattice.twist_phases(
            config.num_sites, bonds, config.twist_phi,
            size_x=size_x, size_y=size_y,
            direction=getattr(config, 'twist_direction', 'x'))
    return HeisenbergHamiltonian(
        bonds, config.heisenberg_jx, config.heisenberg_jz,
        sample_chunk=getattr(config, 'energy_chunk_samples', 0),
        couplings=couplings, offdiag_couplings=offdiag,
        twist_phases=twist)


def _check_ported(config: Config) -> None:
    for field, off in _UNPORTED:
        value = getattr(config, field, off)
        if value != off:
            raise NotImplementedError(
                f'{field}={value!r} is not ported yet (ROADMAP.md)')


def _optimizer_class(registry: dict, name: str, kind: str):
    if name not in registry:
        raise NotImplementedError(
            f'optimizer {name!r} is not ported yet as a {kind} optimizer; '
            f'the port has {sorted(registry)} (ROADMAP.md)')
    return registry[name]


def _init_ground_state(config: Config, device):
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    opt_name = config.wavefunction_optimizer_type or 'ITSWO'
    optimizer = _optimizer_class(GROUND_STATE_OPTIMIZERS, opt_name,
                                 'ground-state')(wf, hamiltonian, config)
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

    state, start_epoch = _maybe_resume(state, out_dir, resume, device)
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


def _maybe_resume(state: TrainState, out_dir: str, resume: bool, device):
    """(state, first epoch): the run directory's latest checkpoint when
    resuming from one, else the given state from epoch 0."""
    if resume and out_dir:
        latest = ckpt_lib.latest_checkpoint(out_dir)
        if latest:
            epoch = ckpt_lib.checkpoint_epoch(latest)
            print(f'Resumed from {latest} (epoch {epoch})')
            return ckpt_lib.restore_checkpoint(latest, device), epoch
    return state, 0


def load_supervisor(supervisor_dir: str, device):
    """(target wavefunction, its params on `device`) of a trained run
    directory: its config.json and the params of its latest checkpoint
    (the optimizer's state is never rebuilt, so any run directory of the
    port serves, ground-state or distilled)."""
    sup_config = Config.load(os.path.join(supervisor_dir, 'config.json'))
    target_wf = models.build_wavefunction(sup_config)
    latest = ckpt_lib.latest_checkpoint(supervisor_dir)
    if latest is None:
        raise FileNotFoundError(
            f'No checkpoint in supervisor_dir {supervisor_dir!r}')
    return target_wf, ckpt_lib.restore_params_from_checkpoint(latest, device)


def distill(config: Config, device, resume: bool = False,
            target_params=None, target_wf=None,
            logger: Optional[MetricsLogger] = None) -> TrainState:
    """Supervised distillation of a student toward a frozen target on
    `device`.

    The target is config.supervisor_dir's run (see load_supervisor) unless
    target_wf and target_params are given.  Saves config.json, a full-state
    checkpoint after every checkpoint_frequency-th epoch (ckpt_epoch_n holds
    the state after epoch n), appends per-epoch metrics (metrics.txt gets
    the loss), and returns the final TrainState.
    """
    device = resolve_device(device)
    _check_ported(config)
    if target_wf is None or target_params is None:
        target_wf, target_params = load_supervisor(config.supervisor_dir,
                                                   device)
    wf = models.build_wavefunction(config)
    opt_name = config.wavefunction_optimizer_type or 'SWO'
    optimizer = _optimizer_class(SUPERVISED_OPTIMIZERS, opt_name,
                                 'supervised')(wf, target_wf, config)
    state = optimizer.init_state(config.seed, device, target_params,
                                 config.batch_size)
    out_dir = config.checkpoint_dir
    if out_dir:
        ckpt_lib.save_config(out_dir, config)
    state, start_epoch = _maybe_resume(state, out_dir, resume, device)
    registry.check_state(wf, config, state.sampler)
    if 'target_sampler' in state.extra:
        registry.check_state(target_wf, config, state.extra['target_sampler'])
    logger = logger or MetricsLogger(out_dir, primary='loss')

    for epoch in range(start_epoch, config.num_epochs):
        state, metrics = optimizer.epoch(state)
        if out_dir and (epoch + 1) % config.checkpoint_frequency == 0:
            ckpt_lib.save_checkpoint(out_dir, state, epoch + 1,
                                     config.max_checkpoints_to_keep)
        logger.log(epoch + 1, metrics)
    return state
