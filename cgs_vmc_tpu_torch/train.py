"""Training loops (port of cgs_vmc_tpu/train.py: build_hamiltonian with
both families, Heisenberg (twisted boundaries included) and transverse-field
Ising, train and distill).

Build ansatz + Hamiltonian (or frozen target) + optimizer on an explicit
device, then a thin Python loop of epochs with rotating full-state
checkpoints and a metrics stream.  The ground-state optimizers are
EnergyGradient, SR, ITSWO (the default), LogOverlapITSWO and the
excited-state ExcitedPenalty and ExcitedSR (config.orthogonal_to); the
supervised ones SWO (the default), LogOverlapSWO, DualSamplingSWO and
BasisIterSWO.  Every one of them takes a complex-log ansatz
(``wavefunction_type='complex'``).

The run plumbing of the JAX train.py:
 * ``num_devices``: the chains shard over the ranks of a
   ``torch.distributed`` process group (parallel/mesh.py; launch with
   ``torchrun``), taken whenever a group is initialized, world size 1
   included; only rank 0 writes config.json, metrics and checkpoints;
 * ``param_ema_decay`` > 0: an exponential moving average of the params,
   ``extra['ema_params']``, updated in place after every epoch and
   checkpointed (``cli eval --ema`` evaluates it);
 * ``epochs_per_call`` = k: k epochs a loop iteration, with the JAX rules
   for checkpoints (the first block boundary at or after each
   checkpoint_frequency multiple) and a shorter remainder run epoch by
   epoch.  The JAX package compiles the k epochs into one program
   (``_scan_epochs``); on a card the port captures them as one CUDA graph
   and replays it, and the remainder replays a one-epoch graph
   (utils/cuda_graph.py).  The run's first block runs eagerly, as its
   warm-up; a run's numbers are those of the eager loop, which is what
   runs on the CPU, under a process group and for the configurations of
   ``cuda_graph.EAGER_PATHS``.  ``distill`` replays one graph an epoch;
 * ``profile_dir``: a torch.profiler trace of the second call, with the
   program's spans on for the run and ``spans.json`` (each epoch of that
   call: every span's device and host ms, and the counters) beside the
   trace (utils/profiling.py).
``checkpoint_backend='orbax'`` is refused: the port writes torch.save
files.  Precision on the card: ``resolve_device`` turns TF32 off
process-wide for cuBLAS and cuDNN (so the f32 convs are f32), and SR scopes
its own ``sr_matmul_precision`` to the assembly GEMMs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from cgs_vmc_tpu_torch import lattice, models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models.base import tree_map
from cgs_vmc_tpu_torch.ops.heisenberg import (
    HeisenbergHamiltonian, LocalOperator)
from cgs_vmc_tpu_torch.ops.ising import TransverseFieldIsingHamiltonian
from cgs_vmc_tpu_torch.optim import (
    GROUND_STATE_OPTIMIZERS,
    SUPERVISED_OPTIMIZERS,
    TrainState,
)
from cgs_vmc_tpu_torch.optim.common import group_rank
from cgs_vmc_tpu_torch.parallel import mesh as mesh_lib
from cgs_vmc_tpu_torch.sampler import registry
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils.device import resolve_device
from cgs_vmc_tpu_torch.utils.cuda_graph import EpochRunner, eager_reason
from cgs_vmc_tpu_torch.utils.metrics import MetricsLogger
from cgs_vmc_tpu_torch.utils import profiling
from cgs_vmc_tpu_torch.utils.profiling import maybe_trace, span, synchronize

# (config field, its default) for features of the JAX train.py the port
# refuses.  The port always writes torch.save checkpoints, so only the
# default checkpoint_backend is accepted (it names no format the port
# writes).
_UNPORTED = (('checkpoint_backend', 'msgpack'),)


def build_hamiltonian(config: Config) -> LocalOperator:
    """The Hamiltonian of config.hamiltonian_type ('heisenberg' | 'ising')
    on the bonds the JAX package resolves: a J-file if present
    (config.j_file_path, else J.txt in the run directory), else the lattice
    implied by the config.

    The move set must fit the family's state space: Heisenberg conserves Sz
    and needs the 'exchange' move, the TFIM does not and needs 'flip'.  A
    mismatched move samples the wrong space, so it is an error."""
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
    move = getattr(config, 'mc_move_type', 'exchange') or 'exchange'
    if family == 'ising':
        if move != 'flip':
            raise ValueError(
                "hamiltonian_type='ising' requires mc_move_type='flip': "
                'the TFIM does not conserve Sz, so the Sz-conserving '
                f'exchange move is non-ergodic for it (got {move!r})')
        return TransverseFieldIsingHamiltonian(
            bonds, h_x=config.ising_h, j_zz=config.ising_j,
            sample_chunk=getattr(config, 'energy_chunk_samples', 0),
            couplings=couplings)
    if family != 'heisenberg':
        raise ValueError(f'Unknown hamiltonian_type {family!r}; '
                         "known: ['heisenberg', 'ising']")
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
                f'{field}={value!r} is not ported (ROADMAP.md)')


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


def _ema_wrap(epoch_fn, decay: float):
    """epoch_fn followed by ema ← d·ema + (1 − d)·params on the slot
    ``extra['ema_params']``, updated in place (no host sync) and re-added
    after the inner epoch, because some optimizers rebuild ``extra``.
    Polyak averaging smooths the SR/SGD iterate noise out of the final
    weights; `cli eval --ema` evaluates them."""
    def fn(state, **kwargs):
        ema = state.extra['ema_params']
        new_state, metrics = epoch_fn(state, **kwargs)
        with torch.no_grad():
            tree_map(lambda e, p: e.lerp_(p, 1.0 - decay), ema,
                     new_state.params)
        return new_state._replace(
            extra={**new_state.extra, 'ema_params': ema}), metrics
    return fn


def _ema_slot(params):
    return tree_map(lambda x: x.detach().clone(), params)


def _maybe_add_ema_slot(state: TrainState, config: Config) -> TrainState:
    """The EMA slot, a copy of the params, when param_ema_decay > 0 and the
    state has none (a fresh run, or the resume of a run that trained
    without it: the average starts at the restored params)."""
    if not config.param_ema_decay or 'ema_params' in state.extra:
        return state
    return state._replace(extra={**state.extra,
                                 'ema_params': _ema_slot(state.params)})


def _make_epoch_fn(optimizer, config: Config, group):
    """state -> (state, metrics): the optimizer's epoch, bound to the
    chains group when there is one, with the EMA update when
    param_ema_decay > 0."""
    epoch = optimizer.epoch
    if group is not None:
        epoch = mesh_lib.sharded_epoch_fn(epoch, group)
    if config.param_ema_decay:
        epoch = _ema_wrap(epoch, config.param_ema_decay)
    return epoch


def _scan_epochs(epoch, k: int):
    """k epochs as ONE call, (state, [metrics of each epoch]): the body a
    CUDA graph captures (the JAX package's scanned program); epoch j takes
    inputs[j] when the optimizer draws host inputs."""
    def fn(state, inputs=()):
        records = []
        for j in range(k):
            with span('epoch', state.epoch.device, index=j):
                if inputs:
                    state, metrics = epoch(state, inputs=inputs[j])
                else:
                    state, metrics = epoch(state)
            records.append(metrics)
        return state, records
    return fn


def _runner(optimizer, config: Config, group, device,
            replay: Optional[str]) -> EpochRunner:
    """The loop's EpochRunner: by default CUDA graphs on a card (eager, and
    said so, under a group or for an EAGER_PATHS configuration) and eager
    epochs elsewhere."""
    epoch = _make_epoch_fn(optimizer, config, group)
    if replay is None:
        replay = 'eager'
        if device.type == 'cuda':
            reason = eager_reason(config, group)
            if reason is None:
                replay = 'graph'
            elif group_rank(group) == 0:
                print(f'Epochs run eagerly on {device}: {reason}')
    return EpochRunner(lambda k: _scan_epochs(epoch, k), device, replay,
                       getattr(optimizer, 'host_inputs', None))


class _Silent:
    """The metrics logger of ranks other than 0."""

    def log(self, epoch, metrics) -> None:
        del epoch, metrics


def _logger(logger, out_dir: str, group, primary: str = 'energy'):
    if logger is not None:
        return logger
    if group_rank(group):
        return _Silent()
    return MetricsLogger(out_dir, primary=primary)


def _start(state: TrainState, config: Config, out_dir: str, resume: bool,
           device, group):
    """(state, first epoch): the run directory's latest checkpoint (this
    rank's share) when resuming from one, else the fresh state sharded
    over the group; the EMA slot added either way."""
    if out_dir and group_rank(group) == 0:
        ckpt_lib.save_config(out_dir, config)
    latest = ckpt_lib.latest_checkpoint(out_dir) if (resume and
                                                     out_dir) else None
    if latest:
        epoch = ckpt_lib.checkpoint_epoch(latest)
        if group_rank(group) == 0:
            print(f'Resumed from {latest} (epoch {epoch})')
        state = ckpt_lib.restore_checkpoint(latest, device, group)
        return _maybe_add_ema_slot(state, config), epoch
    return mesh_lib.shard_train_state(_maybe_add_ema_slot(state, config),
                                      group), 0


def train(config: Config, device, resume: bool = False,
          logger: Optional[MetricsLogger] = None,
          replay: Optional[str] = None) -> TrainState:
    """Ground-state optimization on `device`.

    Saves config.json and rotating full-state checkpoints (the state before
    epoch n as ckpt_epoch_n, and the final state), appends per-epoch
    metrics, and returns the final TrainState (this rank's, under a
    process group).  resume=True continues from the run directory's latest
    checkpoint.  replay: how blocks of epochs run (None: CUDA graphs on a
    card, eager elsewhere; or 'eager', 'graph', 'plain', see
    utils/cuda_graph.EpochRunner).
    """
    device = resolve_device(device)
    _check_ported(config)
    group = mesh_lib.chains_group(config.num_devices)
    wf, optimizer, state = _init_ground_state(config, device)
    out_dir = config.checkpoint_dir
    state, start_epoch = _start(state, config, out_dir, resume, device,
                                group)
    registry.check_state(wf, config, state.sampler)
    for wf_k, lower in zip(getattr(optimizer, 'lower_wfs', ()),
                           state.extra.get('lower_samplers', ())):
        registry.check_state(wf_k, config, lower)
    logger = _logger(logger, out_dir, group)

    k = max(1, config.epochs_per_call)
    runner = _runner(optimizer, config, group, device, replay)
    epoch = start_epoch
    with profiling.loop(on=bool(config.profile_dir)):
        while epoch < config.num_epochs:
            # The remainder shorter than k runs epoch by epoch.
            step = k if epoch + k <= config.num_epochs else 1
            # Trace the second call (the first pays the one-time costs).
            trace_dir = (config.profile_dir
                         if config.profile_dir and epoch == start_epoch + k
                         else None)
            with maybe_trace(trace_dir), span('train.block'):
                # The first block boundary at or after each
                # checkpoint_frequency multiple (epoch % freq == 0 when
                # k == 1).
                if out_dir and epoch % config.checkpoint_frequency < step:
                    with span('train.checkpoint'):
                        ckpt_lib.save_checkpoint(
                            out_dir, state, epoch,
                            config.max_checkpoints_to_keep, group)
                state, records = runner.run(state, step)
                with span('train.wait'):
                    synchronize(records)
                with span('train.log'):
                    for j, metrics in enumerate(records):
                        logger.log(epoch + j + 1, metrics)
            profiling.collect(epoch, step)
            if trace_dir:
                profiling.write_spans(os.path.join(trace_dir, 'spans.json'),
                                      step)
            epoch += step

    if out_dir:
        ckpt_lib.save_checkpoint(out_dir, state, config.num_epochs,
                                 config.max_checkpoints_to_keep, group)
    return state


def load_supervisor(supervisor_dir: str, device):
    """(target wavefunction, its params on `device`) of a trained run
    directory: its config.json and the params of its latest checkpoint
    (the optimizer's state is never rebuilt, so any run directory serves,
    ground-state or distilled, of the port or of the JAX package)."""
    sup_config = Config.load(os.path.join(supervisor_dir, 'config.json'))
    target_wf = models.build_wavefunction(sup_config)
    latest = ckpt_lib.latest_checkpoint(supervisor_dir)
    if latest is None:
        raise FileNotFoundError(
            f'No checkpoint in supervisor_dir {supervisor_dir!r}')
    template = target_wf.init(torch.Generator().manual_seed(0))
    return target_wf, ckpt_lib.restore_params_from_checkpoint(
        latest, device, tree_map(lambda x: x.to(device),
                                             template))


def distill(config: Config, device, resume: bool = False,
            target_params=None, target_wf=None,
            logger: Optional[MetricsLogger] = None,
            replay: Optional[str] = None) -> TrainState:
    """Supervised distillation of a student toward a frozen target on
    `device`.

    The target is config.supervisor_dir's run (see load_supervisor) unless
    target_wf and target_params are given.  Saves config.json, a full-state
    checkpoint after every checkpoint_frequency-th epoch (ckpt_epoch_n holds
    the state after epoch n), appends per-epoch metrics (metrics.txt gets
    the loss), and returns the final TrainState.  Shards over a process
    group, keeps an EMA slot and takes `replay` as `train` does (one CUDA
    graph an epoch).
    """
    device = resolve_device(device)
    _check_ported(config)
    group = mesh_lib.chains_group(config.num_devices)
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
    state, start_epoch = _start(state, config, out_dir, resume, device,
                                group)
    registry.check_state(wf, config, state.sampler)
    if 'target_sampler' in state.extra:
        registry.check_state(target_wf, config, state.extra['target_sampler'])
    logger = _logger(logger, out_dir, group, primary='loss')

    runner = _runner(optimizer, config, group, device, replay)
    for epoch in range(start_epoch, config.num_epochs):
        state, (metrics,) = runner.run(state, 1)
        if out_dir and (epoch + 1) % config.checkpoint_frequency == 0:
            ckpt_lib.save_checkpoint(out_dir, state, epoch + 1,
                                     config.max_checkpoints_to_keep, group)
        logger.log(epoch + 1, metrics)
    return state
