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
tensors and numbers, no pickled objects).  The JAX package's params-only
``.msgpack`` artifacts load with `restore_params_only` (decoded by
utils/msgpack_params.py); its full-TrainState ``ckpt_epoch_*.msgpack``
files are not read.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, tree_map
from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState
from cgs_vmc_tpu_torch.sampler.tempering import PTSamplerState
from cgs_vmc_tpu_torch.utils import msgpack_params

_CKPT_RE = re.compile(r'ckpt_epoch_(\d+)\.pt$')
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


def _decode(raw: Dict[str, Any], device: torch.device) -> TrainState:
    return TrainState(params=_decode_tree(raw['params'], device),
                      opt_state=_decode_tree(raw['opt_state'], device),
                      sampler=_decode_sampler(raw['sampler'], device),
                      epoch=int(raw['epoch']),
                      extra=_decode_tree(raw['extra'], device))


def _all_checkpoints(directory: str):
    """Sorted (epoch, path) pairs."""
    found = []
    for path in glob.glob(os.path.join(directory, 'ckpt_epoch_*.pt')):
        match = _CKPT_RE.search(path)
        if match:
            found.append((int(match.group(1)), path))
    return sorted(found)


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    max_to_keep: int = 5) -> str:
    """Writes ckpt_epoch_{epoch}.pt atomically and rotates old ones."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f'ckpt_epoch_{epoch}.pt')
    tmp = path + '.tmp'
    torch.save(_encode(state), tmp)
    os.replace(tmp, path)
    for _, old in (_all_checkpoints(directory)[:-max_to_keep]
                   if max_to_keep else []):
        os.remove(old)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    checkpoints = _all_checkpoints(directory)
    return checkpoints[-1][1] if checkpoints else None


def _load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location='cpu', weights_only=True)


def restore_checkpoint(path: str, device) -> TrainState:
    """Restores a TrainState saved by save_checkpoint onto `device`."""
    return _decode(_load(path), torch.device(device))


def restore_params_from_checkpoint(path: str, device) -> Params:
    """Only the wavefunction parameters of a checkpoint, on `device`: what
    evaluation needs, from any device the run trained on."""
    return _decode_tree(_load(path)['params'], torch.device(device))


def restore_params_only(path: str, template: Params) -> Params:
    """Reads a params-only ``.msgpack`` artifact written by the JAX
    package (``save_params_only`` / flax ``to_bytes``) onto the structure,
    device and dtypes of `template` (e.g. ``wf.init(generator)``).

    Every leaf's key path, shape and dtype must match the template's:
    loading never reshapes, casts or drops a leaf silently.
    """
    with open(path, 'rb') as f:
        raw = msgpack_params.loads(f.read())
    if not isinstance(raw, dict):
        raise ValueError(f'{path!r} holds no params tree')
    found = dict(msgpack_params.flat_leaves(raw))
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
    match = _CKPT_RE.search(path)
    if not match:
        raise ValueError(f'Not a checkpoint path: {path}')
    return int(match.group(1))
