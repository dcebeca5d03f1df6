"""The chains group and chain sharding (port of
cgs_vmc_tpu/parallel/mesh.py).

The JAX package runs one process over many chips and shards the Markov
chains over a 1-D mesh axis ``'chains'`` under ``shard_map``.  PyTorch's
idiom is one process a GPU, so here the mesh is a ``torch.distributed``
process group (the world group) whose ranks each hold a share of the
chains.  Parameters, optimizer state and the epoch are replicated; every
estimator moment is averaged over the group by the optimizers'
``common.pmean`` (NCCL on the card, gloo on the CPU), so every rank takes
the same update.  One code path serves one process (``group=None``) and
many.

Launch one process a GPU with ``torchrun``:

    torchrun --nproc_per_node=8 -m cgs_vmc_tpu_torch.cli train \\
        --config CONFIG --override num_devices=8 --checkpoint_dir RUN

The sharded path is taken whenever a process group is initialized and
``config.num_devices`` equals its size, world size 1 included (so one card
runs the NCCL path); without a group, ``num_devices`` must be 1.

Randomness.  The JAX sampler has a key a chain, so sharding only
partitions the same chains.  The port has one ``torch.Generator`` a
sampler, so a sampler is made for the global batch on every rank (every
rank draws the same initial chains), rank r keeps rows r·c .. (r+1)·c − 1
of it (c chains a rank), and the generator of rank r > 0 is reseeded with
a rank-dependent seed.  Rank 0 keeps the generator as it is, so world size
1 is bit for bit the unsharded run.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState
from cgs_vmc_tpu_torch.sampler.tempering import PTSamplerState
from cgs_vmc_tpu_torch.utils.tree import generators, leaves

PER_RANK = 'per_rank'
REPLICATED = 'replicated'
# Added (mod 2**64) to a sampler generator's seed once a rank: rank r > 0
# gets a stream no other rank, and no seed + k of the optimizers, can hit.
_RANK_SEED_STRIDE = 0x9E3779B97F4A7C15
_LAUNCH_HINT = ('; launch one process a device, e.g. torchrun '
                '--nproc_per_node={n} -m cgs_vmc_tpu_torch.cli train '
                '--override num_devices={n} ...')


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> int:
    """`torch.distributed.init_process_group` for the chains group.

    The backend defaults to 'nccl' when CUDA is available and 'gloo'
    otherwise (the card never falls back to gloo).  The arguments default
    to ``torchrun``'s environment (``env://``: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  Under NCCL the process's current CUDA device
    becomes ``cuda:LOCAL_RANK``.  Returns the rank."""
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    kwargs = {'backend': backend}
    if init_method is not None:
        kwargs['init_method'] = init_method
    if world_size is not None:
        kwargs['world_size'] = world_size
    if rank is not None:
        kwargs['rank'] = rank
    if backend == 'nccl':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', rank or 0)))
    dist.init_process_group(**kwargs)
    return dist.get_rank()


def make_mesh(num_devices: Optional[int] = None):
    """The chains group: the world group of the initialized process group,
    which must hold exactly `num_devices` ranks (default: all)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_devices is None:
        num_devices = world
    if num_devices != world:
        hint = _LAUNCH_HINT.format(n=num_devices) if num_devices > world \
            else (f'; pass --override num_devices={world} to use every '
                  'rank of the process group')
        raise ValueError(
            f'Requested {num_devices} devices, have {world}{hint}')
    if not dist.is_initialized():
        raise ValueError('make_mesh needs an initialized process group '
                         '(initialize_distributed)')
    return dist.group.WORLD


def chains_group(num_devices: int):
    """The group a run shards over: None (the plain path) when no process
    group is initialized and num_devices is 1, else `make_mesh`, which
    raises when the counts differ."""
    if not dist.is_initialized() and num_devices == 1:
        return None
    return make_mesh(num_devices)


def chains_per_device(batch_size: int, group) -> int:
    n = 1 if group is None else dist.get_world_size(group)
    if batch_size % n:
        raise ValueError(
            f'batch_size={batch_size} not divisible by mesh size {n}')
    return batch_size // n


def is_sampler(value) -> bool:
    return isinstance(value, (SamplerState, PTSamplerState))


def train_state_specs(state: TrainState) -> TrainState:
    """Which parts of a TrainState are PER_RANK and which REPLICATED.

    Per rank: the sampler, and every sampler state in ``extra``, directly
    (DualSamplingSWO's target chains) or in a list or tuple (the excited-
    state optimizers' frozen chains).  Replicated: params, optimizer
    state, epoch and the rest of ``extra``."""
    def extra_spec(value):
        if is_sampler(value):
            return PER_RANK
        if isinstance(value, (list, tuple)) and any(
                is_sampler(v) for v in value):
            return type(value)(extra_spec(v) for v in value)
        return REPLICATED

    return TrainState(
        params=REPLICATED, opt_state=REPLICATED, sampler=PER_RANK,
        epoch=REPLICATED,
        extra={name: extra_spec(value)
               for name, value in state.extra.items()})


def rank_seed(seed: int, rank: int) -> int:
    """The generator seed of `rank`'s share of a sampler seeded `seed`."""
    return (seed + rank * _RANK_SEED_STRIDE) % 2 ** 64


def shard_sampler(sampler, group):
    """This rank's share of a sampler made for the global batch: rows
    rank·c .. (rank+1)·c − 1 of every chain-leading tensor and, on rank
    r > 0, a generator reseeded with `rank_seed`.  The identity at world
    size 1 and without a group."""
    if group is None or dist.get_world_size(group) == 1:
        return sampler
    rank = dist.get_rank(group)
    c = chains_per_device(sampler.configs.shape[0], group)
    fields = {}
    for name, value in zip(sampler._fields, sampler):
        if isinstance(value, torch.Tensor):
            value = value[rank * c:(rank + 1) * c].clone()
        elif isinstance(value, torch.Generator) and rank:
            value = torch.Generator(device=value.device).manual_seed(
                rank_seed(value.initial_seed(), rank))
        fields[name] = value
    return type(sampler)(**fields)


def _comm_device(group) -> torch.device:
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _broadcast_tree(tree, group):
    """Rank 0's values of every tensor and generator of a tree
    (utils/tree.py), in place of this rank's (one buffer a dtype for the
    tensors)."""
    device = _comm_device(group)
    by_dtype = {}
    for t in leaves(tree):
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for (dtype, _), group_tensors in by_dtype.items():
        parts = [torch.view_as_real(t) if dtype.is_complex else t
                 for t in group_tensors]
        flat = torch.cat([p.detach().reshape(-1) for p in parts]).to(device)
        dist.broadcast(flat, src=0, group=group)
        for p, chunk in zip(parts, torch.split(
                flat, [p.numel() for p in parts])):
            with torch.no_grad():
                p.copy_(chunk.view(p.shape))
    for g in generators(tree):
        state = g.get_state().to(device)
        dist.broadcast(state, src=0, group=group)
        g.set_state(state.cpu())


def shard_train_state(state: TrainState, group) -> TrainState:
    """Places a TrainState made for the global batch on the group: the
    replicated parts are broadcast from rank 0 (so a seed mismatch cannot
    desynchronise the ranks), the per-rank samplers sharded by
    `shard_sampler`."""
    if group is None:
        return state
    specs = train_state_specs(state)
    if dist.get_world_size(group) > 1:
        replicated = [state.params, state.opt_state,
                      {k: v for k, v in state.extra.items()
                       if specs.extra[k] == REPLICATED}]
        _broadcast_tree(replicated, group)

    def shard_extra(value, spec):
        if spec == PER_RANK:
            return shard_sampler(value, group)
        if isinstance(spec, (list, tuple)):
            return type(value)(shard_extra(v, s) for v, s in zip(value, spec))
        return value

    return state._replace(
        sampler=shard_sampler(state.sampler, group),
        extra={k: shard_extra(v, specs.extra[k])
               for k, v in state.extra.items()})


def sharded_epoch_fn(epoch_fn: Callable, group) -> Callable:
    """`epoch_fn(state, group=...)` bound to the chains group: the
    optimizers pmean their moments over it."""
    def fn(state):
        return epoch_fn(state, group=group)
    return fn
