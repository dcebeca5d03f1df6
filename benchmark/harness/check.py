"""The numbers that decide `correct`, each held to its limit.

The check ties the timed path to a plain reference in two links.  The
first check epoch is one more replay of the training loop's own captured
CUDA graph (the timed path itself), and beside it its eager twin: the
program's epoch called directly from a copy of the state the replay
started from, with every generator set back to where it stood.  The eager
twin runs under a recorder around the program's sweeps function, which
keeps, for every block of sweeps, the params it sampled with, the boards
it reached and the log ψ it cached: the draws of K2's in-kernel Philox
cannot be made again by a plain reference, so the reference then
recomputes from those boards what the program computed from them, and
follows the program from its own state, epoch by epoch.  Later check
epochs are eager epochs of the program from the replay's state.

Numbers (each a worst case over the run's check):
  sector_violations  boards off the Sz = 0 sector or not ±1 (exact: 0)
  frozen_blocks      blocks of sweeps after which no chain moved (0)
  epochs_missed      |the state's epoch counter - the epochs logged| (0)
  twin_mismatch      tensors of the replay's state other than the params
                     (the boards, cached amplitudes, epoch counter,
                     optimizer extras), and generator states, that differ
                     bit for bit from its eager twin's (0)
  twin_gap           the replay's change of the params against its eager
                     twin's, worst leaf
  cache_gap          |cached log|ψ| - the reference's|, largest; for a
                     complex log ψ the larger of that and the largest
                     |phase difference| wrapped to (−π, π]
  energy_gap         |E_program - E_reference| / |E_reference|, largest
                     (the replay's energy in the first check epoch)
  loss_gap           the same for ITSWO's loss
  step_gap           the replay's change of the params against the
                     reference's epoch from the same params and boards,
                     worst leaf (or median leaf: LEAF_RULES)
  change_gap         the change over all the checked epochs, the same
A leaf's gap is |‖Δ_program‖ - ‖Δ_reference‖| over the larger of
‖Δ_reference‖ and the median leaf's; leaves the reference moves by less
than a thousandth of the median leaf's (a bias under a sum, moved by
round-off alone) are left out.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import sys
from typing import Any, Dict, Iterable, Iterator, List, Tuple

import torch

from benchmark.reference import precision

Flat = Dict[str, torch.Tensor]

LEAF_FLOOR = 1e-3


def flat_params(tree, prefix: str = '') -> Flat:
    """A nested dict of tensors as {'a.b': detached copy}."""
    out: Flat = {}
    for key, value in tree.items():
        name = f'{prefix}{key}'
        if isinstance(value, dict):
            out.update(flat_params(value, name + '.'))
        else:
            out[name] = value.detach().clone()
    return out


def state_leaves(tree, prefix: str = '') -> Iterator[Tuple[str, Any]]:
    """(path, tensor or generator) of every leaf of a nested train state
    (dicts in sorted-key order, NamedTuples, lists and tuples)."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        yield prefix, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from state_leaves(tree[key], f'{prefix}.{key}')
    elif isinstance(tree, tuple) and hasattr(tree, '_fields'):
        for key, value in zip(tree._fields, tree):
            yield from state_leaves(value, f'{prefix}.{key}')
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from state_leaves(value, f'{prefix}.{i}')


def freeze(state) -> Dict[str, torch.Tensor]:
    """A copy of every tensor of `state`, and the state of each of its
    generators, by path."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in state_leaves(state):
        out[path] = (leaf.get_state() if isinstance(leaf, torch.Generator)
                     else leaf.detach().clone())
    return out


def thaw(state, frozen: Dict[str, torch.Tensor]):
    """`state` rebuilt from `frozen`'s copies of its tensors, its
    generators (the same objects) set back to their frozen states."""
    def walk(node, prefix):
        if isinstance(node, torch.Generator):
            node.set_state(frozen[prefix])
            return node
        if isinstance(node, torch.Tensor):
            return frozen[prefix].clone()
        if isinstance(node, dict):
            return {k: walk(v, f'{prefix}.{k}') for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, '_fields'):
            return type(node)(*(walk(v, f'{prefix}.{k}')
                                for k, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f'{prefix}.{i}')
                              for i, v in enumerate(node))
        return node
    return walk(state, '')


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, so that equal means equal bit for bit (NaN and
    -0.0 included)."""
    return t.reshape(-1).view(torch.uint8)


def mismatch(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
             skip: str = '.params') -> int:
    """Leaves of two frozen states, outside `skip`, that are not equal bit
    for bit (a leaf that one side lacks counts)."""
    def same(k):
        return (k in a and k in b and a[k].dtype == b[k].dtype
                and a[k].shape == b[k].shape
                and torch.equal(_bits(a[k]), _bits(b[k])))
    return sum(not same(k) for k in set(a) | set(b)
               if not k.startswith(skip))


@dataclasses.dataclass
class Block:
    """One call of the sweeps function: its params and what it reached."""
    params: Flat
    configs: torch.Tensor
    log_amp: torch.Tensor
    moved: int                 # chains whose board changed


class SweepsRecorder:
    """Wraps a sweeps function (params, state, n) -> state; records every
    call and changes nothing."""

    def __init__(self, sweeps):
        self.sweeps = sweeps
        self.blocks: List[Block] = []

    def __call__(self, params, state, num_sweeps):
        out = self.sweeps(params, state, num_sweeps)
        moved = int((out.configs != state.configs).any(dim=1).sum())
        self.blocks.append(Block(flat_params(params),
                                 out.configs.detach().clone(),
                                 out.log_amp.detach().clone(), moved))
        return out


def sector_violations(boards: Iterable[torch.Tensor]) -> int:
    bad = 0
    for s in boards:
        bad += int(((s.abs() != 1).any(dim=1) | (s.sum(dim=1) != 0)).sum())
    return bad


def frozen_blocks(blocks: List[Block]) -> int:
    return sum(b.moved == 0 for b in blocks)


def _log_gap(cached: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest gap of two log ψ: |Δ log|ψ||, and for a complex reference
    also |Δ phase| wrapped to (−π, π]."""
    gap = float((cached.real - ref.real).abs().max())
    if ref.is_complex():
        turn = cached.imag - ref.imag
        wrapped = math.pi - torch.remainder(math.pi - turn, 2.0 * math.pi)
        gap = max(gap, float(wrapped.abs().max()))
    return gap


def cache_gap(log_fn, blocks: List[Block]) -> float:
    """Largest gap (`_log_gap`) of cached log ψ to log_fn(params, boards)
    over the blocks."""
    gap = 0.0
    with torch.no_grad():
        for b in blocks:
            gap = max(gap, _log_gap(b.log_amp, log_fn(b.params, b.configs)))
    return gap


def control_cache_gap(log_fn, blocks: List[Block]) -> float:
    """The control's `cache_gap`: log_fn at TF32 against log_fn at
    float32 on the blocks' params and boards."""
    gap = 0.0
    with torch.no_grad():
        for b in blocks:
            with precision(True):
                low = log_fn(b.params, b.configs)
            with precision(False):
                ref = log_fn(b.params, b.configs)
            gap = max(gap, _log_gap(low, ref))
    return gap


def rel_gap(value: float, ref: float) -> float:
    if not (math.isfinite(value) and math.isfinite(ref)):
        return math.inf
    return abs(value - ref) / max(abs(ref), 1e-30)


# How a cell's step_gap and change_gap take their leaves (the mix's
# ``leaf_gap``): the worst leaf, or the median leaf where a look showed the
# worst to be one leaf's rounding (PERF.md, section 2).
LEAF_RULES = {'worst': max, 'median': statistics.median}


def leaf_gap(program: Flat, reference: Flat, base: Flat,
             rule: str = 'worst') -> float:
    """The worst (or median) leaf of the change from `base` (see the
    module doc)."""
    ref = {k: float(torch.linalg.vector_norm(reference[k] - base[k]))
           for k in base}
    prog = {k: float(torch.linalg.vector_norm(program[k] - base[k]))
            for k in base}
    if not all(math.isfinite(v) for v in prog.values()):
        return math.inf
    median = statistics.median(ref.values())
    if median == 0.0:
        return 0.0 if max(prog.values()) == 0.0 else math.inf
    return LEAF_RULES[rule]([abs(prog[k] - ref[k]) / max(ref[k], median)
                             for k in base if ref[k] >= LEAF_FLOOR * median])


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {'value', 'limit'}} for every limited number, and whether
    each holds; a number the run did not produce fails."""
    out = {}
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        out[name] = {'value': value, 'limit': limit,
                     'ok': math.isfinite(value) and value <= limit}
    return out


def report(checks: dict) -> None:
    """The numbers beside their limits, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
