"""Checkpointing: full train-state serialization with rotation (port of
cgs_vmc_tpu/utils/checkpoint.py).

The whole TrainState round-trips — params, optimizer state, sampler configs
and statistics, the sampler's generator state, the epoch counter, and the
optimizer's extras, second samplers and generators included (the dual-
sampling target chains, the basis-iteration data generator) — so a resumed
run continues exactly, the excited-state optimizers' list of frozen-state
chains included.  A parallel-tempering ladder (PTSamplerState) is
saved with its tempered replicas, exponents and swap statistics.  One ``torch.save`` file per checkpoint,
``ckpt_epoch_{n}.pt``, read back with ``weights_only=True`` (plain dicts of
tensors and numbers, no pickled objects).

A chain-sharded run (parallel/mesh.py) writes one file from rank 0: every
rank's sampler gathered, the chains in rank order, with a list of the
ranks' generator states in place of one.  It resumes exactly under the
same number of ranks and refuses another; its params read at any.

The JAX package's formats: its params-only ``.msgpack`` artifacts load
with `restore_params_only` and `save_params_only` writes them (the flax
``to_bytes`` layout, by utils/msgpack_params.py, which the JAX package's
own ``restore_params_only`` reads); `restore_params_from_checkpoint` and
`restore_ema_from_checkpoint` read the params (or the EMA params) of
either a ``ckpt_epoch_{n}.pt`` or the JAX package's full-TrainState
``ckpt_epoch_{n}.msgpack``, so a JAX run directory can be evaluated,
dumped or used as a supervisor.  A full-state resume from a JAX
checkpoint is refused: its sampler carries JAX PRNG keys.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cgs_vmc_tpu_torch.models.base import Params, tree_map
from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState
from cgs_vmc_tpu_torch.sampler.tempering import PTSamplerState
from cgs_vmc_tpu_torch.utils import msgpack_params

_CKPT_RE = re.compile(r'ckpt_epoch_(\d+)\.pt$')
_JAX_CKPT_RE = re.compile(r'ckpt_epoch_(\d+)\.msgpack$')
_SAMPLER_TENSORS = ('configs', 'log_amp', 'sign', 'num_accepted',
                    'num_proposed')
# What a tempering ladder holds besides: its presence marks a PTSamplerState.
_PT_TENSORS = ('aux_configs', 'aux_log', 'aux_sign', 'betas',
               'swap_accepted', 'swap_proposed')


_SAMPLER = '__sampler__'
_GENERATOR = '__generator__'


def _encode_generator(generator: torch.Generator) -> Dict[str, Any]:
    return {'generator_state': generator.get_state(),
            'generator_device': str(generator.device)}


def _decode_generator(encoded: Dict[str, Any],
                      device: torch.device) -> torch.Generator:
    """A host generator comes back on the host; a card's generator on
    `device`, which must be a card of the same kind."""
    saved_on = torch.device(encoded['generator_device'])
    if saved_on.type != 'cpu':
        if saved_on.type != device.type:
            raise ValueError(
                f'checkpoint generator was on {saved_on}; an exact resume '
                f'must run on the same kind of device, not {device}')
        saved_on = device
    generator = torch.Generator(device=saved_on)
    generator.set_state(encoded['generator_state'])
    return generator


def _encode_sampler(sampler) -> Dict[str, Any]:
    names = _SAMPLER_TENSORS
    if isinstance(sampler, PTSamplerState):
        names = names + _PT_TENSORS
    encoded = {name: getattr(sampler, name).detach().cpu() for name in names}
    encoded.update(_encode_generator(sampler.generator))
    return encoded


def _decode_sampler(encoded: Dict[str, Any], device: torch.device):
    generator = _decode_generator(encoded, device)
    if generator.device.type != device.type:
        raise ValueError(
            f'checkpoint sampler generator was on {generator.device}; an '
            f'exact resume must run on the same kind of device, not {device}')
    cls, names = SamplerState, _SAMPLER_TENSORS
    if _PT_TENSORS[0] in encoded:
        cls, names = PTSamplerState, names + _PT_TENSORS
    return cls(generator=generator,
               **{name: encoded[name].to(device) for name in names})


def _encode_tree(tree):
    """Nested dicts and lists of tensors, numbers, SamplerStates and
    generators -> what torch.load(weights_only=True) reads back: tensors on
    the host, samplers and generators as tagged dicts of their tensors and
    state."""
    if isinstance(tree, (SamplerState, PTSamplerState)):
        return {_SAMPLER: _encode_sampler(tree)}
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: _encode_generator(tree)}
    if isinstance(tree, dict):
        return {k: _encode_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_encode_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _decode_tree(tree, device: torch.device):
    """Inverse of _encode_tree, tensors and samplers onto `device`."""
    if isinstance(tree, dict):
        if _SAMPLER in tree:
            return _decode_sampler(tree[_SAMPLER], device)
        if _GENERATOR in tree:
            return _decode_generator(tree[_GENERATOR], device)
        return {k: _decode_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode_tree(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _encode(state: TrainState) -> Dict[str, Any]:
    return {'params': _encode_tree(state.params),
            'opt_state': _encode_tree(state.opt_state),
            'sampler': _encode_sampler(state.sampler),
            'epoch': int(state.epoch),
            'extra': _encode_tree(state.extra)}


def _counter(value, device: torch.device) -> torch.Tensor:
    """An int32 scalar on `device`: the epoch, written as an int, and adam's
    step count, an int in the files of earlier versions."""
    return torch.tensor(int(value), dtype=torch.int32, device=device)


def _decode(raw: Dict[str, Any], device: torch.device) -> TrainState:
    opt_state = _decode_tree(raw['opt_state'], device)
    if isinstance(opt_state, dict) and 'count' in opt_state:
        opt_state['count'] = _counter(opt_state['count'], device)
    return TrainState(params=_decode_tree(raw['params'], device),
                      opt_state=opt_state,
                      sampler=_decode_sampler(raw['sampler'], device),
                      epoch=_counter(raw['epoch'], device),
                      extra=_decode_tree(raw['extra'], device))


def _all_checkpoints(directory: str, pattern: re.Pattern = _CKPT_RE):
    """Sorted (epoch, path) pairs of the checkpoints `pattern` names."""
    found = []
    for path in glob.glob(os.path.join(directory, 'ckpt_epoch_*')):
        match = pattern.search(path)
        if match:
            found.append((int(match.group(1)), path))
    return sorted(found)


def _merge_shards(raws):
    """One encoded TrainState from every rank's (rank order): each
    sampler's chain-leading tensors concatenated, its generator states a
    list."""
    def merge_sampler(encs):
        out = {k: (torch.cat([e[k] for e in encs])
                   if isinstance(v, torch.Tensor) else v)
               for k, v in encs[0].items()}
        out['generator_state'] = [e['generator_state'] for e in encs]
        return out

    def merge(nodes):
        first = nodes[0]
        if isinstance(first, dict):
            if _SAMPLER in first:
                return {_SAMPLER: merge_sampler([n[_SAMPLER]
                                                 for n in nodes])}
            return {k: merge([n[k] for n in nodes]) for k in first}
        if isinstance(first, list):
            return [merge(list(parts)) for parts in zip(*nodes)]
        return first

    merged = dict(raws[0])
    merged['sampler'] = merge_sampler([r['sampler'] for r in raws])
    merged['extra'] = merge([r['extra'] for r in raws])
    return merged


def _select_shard(raw: Dict[str, Any], rank: int, world: int, path: str):
    """`rank`'s share of every sampler of an encoded TrainState written by
    a run of `world` ranks (the inverse of `_merge_shards`)."""
    def select(enc):
        states = enc['generator_state']
        written = len(states) if isinstance(states, list) else 1
        if written != world:
            raise ValueError(
                f'{path!r} was written by a run of {written} rank(s); resume '
                f'it with num_devices={written}, not {world} (its params '
                'read at any count: eval, dump, distill)')
        if world == 1:
            return enc
        out = {}
        for k, v in enc.items():
            if isinstance(v, torch.Tensor):
                c = v.shape[0] // world
                v = v[rank * c:(rank + 1) * c]
            out[k] = v
        out['generator_state'] = states[rank]
        return out

    def walk(node):
        if isinstance(node, dict):
            if _SAMPLER in node:
                return {_SAMPLER: select(node[_SAMPLER])}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return dict(raw, sampler=select(raw['sampler']),
                extra=walk(raw['extra']))


def _rank_world(group):
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    max_to_keep: int = 5, group=None) -> str:
    """Writes ckpt_epoch_{epoch}.pt atomically and rotates old ones.

    Under a chains group every rank calls it: rank 0 gathers the ranks'
    samplers and writes the one file, and a barrier follows."""
    path = os.path.join(directory, f'ckpt_epoch_{epoch}.pt')
    raw = _encode(state)
    rank, world = _rank_world(group)
    if world > 1:
        gathered = [None] * world if rank == 0 else None
        dist.gather_object(raw, gathered, dst=0, group=group)
        raw = _merge_shards(gathered) if rank == 0 else None
    if rank == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = path + '.tmp'
        torch.save(raw, tmp)
        os.replace(tmp, path)
        for _, old in (_all_checkpoints(directory)[:-max_to_keep]
                       if max_to_keep else []):
            os.remove(old)
    if world > 1:
        dist.barrier(group=group)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The run directory's newest checkpoint, the port's
    ``ckpt_epoch_{n}.pt`` or the JAX package's ``ckpt_epoch_{n}.msgpack``:
    the higher epoch wins, and at the same epoch the ``.pt``."""
    candidates = [(epoch, 1, path)
                  for epoch, path in _all_checkpoints(directory)]
    candidates += [(epoch, 0, path) for epoch, path
                   in _all_checkpoints(directory, _JAX_CKPT_RE)]
    return max(candidates)[2] if candidates else None


def _is_jax_checkpoint(path: str) -> bool:
    return path.endswith('.msgpack')


def _load(path: str) -> Dict[str, Any]:
    if _is_jax_checkpoint(path):
        with open(path, 'rb') as f:
            raw = msgpack_params.loads(f.read())
        if not isinstance(raw, dict):
            raise ValueError(f'{path!r} holds no TrainState')
        return raw
    return torch.load(path, map_location='cpu', weights_only=True)


def restore_checkpoint(path: str, device, group=None) -> TrainState:
    """Restores a TrainState saved by save_checkpoint onto `device` (this
    rank's share of its samplers under `group`)."""
    if _is_jax_checkpoint(path):
        raise ValueError(
            f'{path!r} is a full-TrainState checkpoint of the JAX package: '
            'its sampler state is JAX PRNG keys, so the port cannot resume '
            'it; its params serve eval, dump and distill --supervisor_dir')
    raw = _select_shard(_load(path), *_rank_world(group), path)
    return _decode(raw, torch.device(device))


def _params_tree(tree, device, template: Optional[Params], path: str):
    """A params subtree read from either checkpoint kind, on `device`:
    onto `template`'s structure when one is given (as
    `restore_params_only` checks it), else as stored."""
    if template is not None:
        return _onto_template(tree, template, path)
    return tree_map(lambda x: torch.as_tensor(np.array(x)).to(device)
                    if isinstance(x, np.ndarray) else x.to(device), tree)


def restore_params_from_checkpoint(path: str, device,
                                   template: Optional[Params] = None
                                   ) -> Params:
    """Only the wavefunction parameters of a checkpoint, on `device`: what
    evaluation needs, from any device the run trained on and from either
    a ``.pt`` of the port or a ``.msgpack`` TrainState of the JAX package.
    `template` (e.g. ``wf.init(generator)``, on `device`) fixes the key
    order and checks every leaf's shape and dtype."""
    raw = _load(path)
    if 'params' not in raw:
        raise ValueError(
            f'{path!r} does not contain a top-level params subtree '
            f'(keys: {sorted(raw)})')
    return _params_tree(raw['params'], torch.device(device), template, path)


def restore_ema_from_checkpoint(path: str, device,
                                template: Optional[Params] = None
                                ) -> Params:
    """The Polyak/EMA-averaged parameters (TrainState.extra['ema_params'],
    written when the run trained with config.param_ema_decay > 0) of
    either checkpoint kind, as `restore_params_from_checkpoint`."""
    raw = _load(path)
    ema = (raw.get('extra') or {}).get('ema_params')
    if ema is None:
        raise ValueError(
            f'{path!r} carries no EMA parameters — the run was trained '
            f'with param_ema_decay=0')
    return _params_tree(ema, torch.device(device), template, path)


def save_params_only(directory: str, params: Params, name: str) -> str:
    """Writes ``{directory}/{name}.msgpack``: the params alone, in the
    bytes flax's ``to_bytes`` gives for the same tree (keys sorted at
    every level, as jax.tree orders a dict), so the JAX package's
    ``restore_params_only`` reads it bit for bit."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(tree[k]) for k in sorted(tree)}
        return tree.detach().cpu().numpy()

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f'{name}.msgpack')
    data = msgpack_params.dumps(host(params))
    with open(path + '.tmp', 'wb') as f:
        f.write(data)
    os.replace(path + '.tmp', path)
    return path


def restore_params_only(path: str, template: Params) -> Params:
    """Reads a params-only ``.msgpack`` artifact written by the JAX
    package (``save_params_only`` / flax ``to_bytes``) or by
    `save_params_only` onto the structure, device and dtypes of
    `template` (e.g. ``wf.init(generator)``).

    Every leaf's key path, shape and dtype must match the template's:
    loading never reshapes, casts or drops a leaf silently.
    """
    with open(path, 'rb') as f:
        raw = msgpack_params.loads(f.read())
    if not isinstance(raw, dict):
        raise ValueError(f'{path!r} holds no params tree')
    return _onto_template(raw, template, path)


def _onto_template(raw, template: Params, path: str) -> Params:
    """A nested dict of arrays or tensors as `template`'s tree: the same
    key paths, shapes and dtypes, or a ValueError naming the leaf."""
    def as_array(x):
        return x.numpy() if isinstance(x, torch.Tensor) else x

    found = {k: as_array(v) for k, v in msgpack_params.flat_leaves(raw)}
    expected = dict(msgpack_params.flat_leaves(template))
    if set(found) != set(expected):
        missing = sorted('/'.join(k) for k in set(expected) - set(found))
        extra = sorted('/'.join(k) for k in set(found) - set(expected))
        raise ValueError(f'{path!r} does not match the template: missing '
                         f'{missing}, unexpected {extra}')
    for key, leaf in expected.items():
        value = found[key]
        want = str(leaf.dtype).removeprefix('torch.')
        if (not isinstance(value, np.ndarray)
                or tuple(value.shape) != tuple(leaf.shape)
                or value.dtype.name != want):
            got = (f'{value.dtype.name}{list(value.shape)}'
                   if isinstance(value, np.ndarray) else type(value).__name__)
            raise ValueError(
                f'{path!r}: leaf {"/".join(key)} is {got}, the template '
                f'wants {want}{list(leaf.shape)}')
    leaves = iter(found[key] for key in expected)
    return tree_map(lambda t: torch.as_tensor(next(leaves)).to(t.device),
                    template)


def save_config(directory: str, config) -> None:
    os.makedirs(directory, exist_ok=True)
    config.save(os.path.join(directory, 'config.json'))


def checkpoint_epoch(path: str) -> int:
    match = _CKPT_RE.search(path) or _JAX_CKPT_RE.search(path)
    if not match:
        raise ValueError(f'Not a checkpoint path: {path}')
    return int(match.group(1))
