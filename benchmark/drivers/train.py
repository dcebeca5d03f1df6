"""Training cells: whole epochs of ``cgs_vmc_tpu_torch.train.train``, the
function ``cgs train`` calls, with replay at its default (on the card the
epochs after the first two are replays of a captured CUDA graph), no
checkpoint directory and the harness's logger (harness/window.py).

The check then follows the program from the state ``train()`` returned
(harness/check.py).  Its first epoch is one more replay of the loop's own
graph, held bit for bit (the params to a tolerance where the program's
own sums are not repeatable) against its eager twin from the same state
and generators; the twin's recorded boards let the reference redo that
epoch, against which the replay's params and energy are judged.  The
`check_epochs` - 1 epochs after it are the program's eager epochs from
the replay's state, each followed by the reference's on the same boards.

Traffic keys: ``override`` (config fields the mix sets), ``warm_epochs``,
``trace_seconds``, ``check_epochs``, ``reference_rows`` (boards a block in
the reference), ``flops`` (the optimizer's file under flops/), and
optionally ``leaf_gap`` ('worst', the default, or 'median';
harness/check.py).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from benchmark.harness import check, program, spec
from benchmark.harness.window import EpochClock, Run
from benchmark.reference import lattice, precision, steps

_ITSWO_EXTRA = ('ite_normalization', 'ema_norm', 'ema_energy', 'ema_count')
FAR = 10 ** 9     # num_epochs until the window closes


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        started: float, device: str = 'cuda', control: bool = False,
        overrides: Optional[dict] = None, replay: Optional[str] = None):
    """(Run, the numbers compared, the control's numbers or None).

    replay: the loop's replay mode, None for the program's default (the
    CPU tests take 'plain': the body a graph captures, called directly)."""
    values = program.run_values(cell, seed, {'checkpoint_dir': '',
                                             'num_epochs': FAR,
                                             **(overrides or {})})
    config = program.config_from(values)
    traffic = cell.traffic
    result = Run('train', cell, config.batch_size
                 * config.num_batches_per_epoch)
    clock = EpochClock(config, result, started, seconds,
                       traffic['warm_epochs'],
                       traffic['trace_seconds'] if trace else 0.0)
    result.setup_parts['to_train'] = time.perf_counter() - started
    with program.runners() as made:
        state = program.train(config, device, logger=clock, replay=replay)
    runner = made[-1]
    block = runner.blocks.get(1)
    if block is not None and block.graph is not None:
        result.setup_parts['capture'] = block.capture_s
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
        result.memory_peak_bytes = torch.cuda.max_memory_allocated()
    checking = time.perf_counter()
    numbers, ctl, boards = follow(cell, values, config, state, runner,
                                  clock.epochs, device, control)
    result.check_s = time.perf_counter() - checking
    result.count_operations(cell, values, boards)
    return result, numbers, ctl


def follow(cell: spec.Cell, values: dict, config, state, runner,
           epochs: int, device: str, control: bool):
    """The program's next epochs from `state` (the first a replay of
    `runner`'s graph, beside its eager twin) and the reference's; returns
    (numbers, the control's numbers or None, the boards seen)."""
    opt = program.optimizer(config)
    recorder = check.SweepsRecorder(opt.sweeps)
    opt.sweeps = recorder
    name = config.wavefunction_optimizer_type or 'ITSWO'
    side = steps.Sides(values, lattice.bonds(values).to(device),
                       cell.traffic['reference_rows'],
                       lattice.couplings(values))
    ref_epoch = steps.EPOCHS[name]
    rule = cell.traffic.get('leaf_gap', 'worst')
    base = check.flat_params(state.params)
    extra = ({k: float(state.extra[k]) for k in _ITSWO_EXTRA}
             if name == 'ITSWO' else {})
    sides = {'reference': [base, extra]}
    if control:
        sides['control'] = [base, dict(extra)]
    numbers: Dict[str, float] = {
        'epochs_missed': abs(int(state.epoch) - epochs),
        'sector_violations': check.sector_violations([state.sampler.configs]),
        'frozen_blocks': 0, 'cache_gap': 0.0, 'energy_gap': 0.0}
    ctl = {'cache_gap': 0.0, 'energy_gap': 0.0} if control else None
    if name == 'ITSWO':
        numbers['loss_gap'] = 0.0
        if control:
            ctl['loss_gap'] = 0.0
    boards = []
    for e in range(cell.traffic['check_epochs']):
        recorder.blocks.clear()
        index = int(state.epoch)
        if e == 0:
            state, metrics = _replay_and_twin(numbers, runner, opt,
                                              state, base)
        else:
            state, metrics = opt.epoch(state)
        positions = [b.configs for b in recorder.blocks]
        boards += positions
        numbers['frozen_blocks'] += check.frozen_blocks(recorder.blocks)
        out = {}
        for way, (p, ex) in sides.items():
            with precision(way == 'control'):
                out[way] = ref_epoch(side, p, index, positions, ex)
            sides[way] = [out[way][0], out[way][2]]
        with precision(False):
            numbers['cache_gap'] = max(numbers['cache_gap'], check.cache_gap(
                side.log, recorder.blocks))
        _gaps(numbers, {k: float(v) for k, v in metrics.items()},
              out['reference'][1])
        if e == 0:
            numbers['step_gap'] = check.leaf_gap(
                check.flat_params(state.params), out['reference'][0], base,
                rule)
        if control:
            _control(ctl, side, recorder.blocks, out, base, e == 0, rule)
    numbers['change_gap'] = check.leaf_gap(
        check.flat_params(state.params), sides['reference'][0], base, rule)
    numbers['sector_violations'] += check.sector_violations(
        boards + [state.sampler.configs])
    if control:
        ctl['change_gap'] = check.leaf_gap(sides['control'][0],
                                           sides['reference'][0], base, rule)
    return numbers, ctl, torch.cat(boards)


def _replay_and_twin(numbers: dict, runner, opt, state, base):
    """One replay of the loop's graph from `state`, whose params are `base`
    (its outputs are what the check judges), and the program's eager epoch
    from a copy of the same state and generators, under the recorder; the
    replay's state and metrics."""
    before = check.freeze(state)
    replayed, records = runner.run(state, 1)
    after = check.freeze(replayed)
    twin, _ = opt.epoch(check.thaw(replayed, before))
    numbers['twin_mismatch'] = check.mismatch(after, check.freeze(twin))
    numbers['twin_gap'] = check.leaf_gap(check.flat_params(replayed.params),
                                         check.flat_params(twin.params), base)
    return replayed, records[0]


def _gaps(numbers: dict, judged: dict, ref: dict) -> None:
    for key in ('energy', 'loss'):
        if key in ref:
            numbers[f'{key}_gap'] = max(numbers[f'{key}_gap'],
                                        check.rel_gap(judged[key], ref[key]))


def _control(ctl: dict, side, blocks, out: dict, base, first: bool,
             rule: str) -> None:
    """The control's numbers: the reference at TF32 judged against the
    reference at float32, on the same params and boards."""
    ctl['cache_gap'] = max(ctl['cache_gap'],
                           check.control_cache_gap(side.log, blocks))
    _gaps(ctl, out['control'][1], out['reference'][1])
    if first:
        ctl['step_gap'] = check.leaf_gap(out['control'][0],
                                         out['reference'][0], base, rule)
