"""The Vision Transformer's executed f32 operations in the traced
training epochs as a share of the card's f32 rate over the device's busy
time, in %: the boards through the network an epoch (the program's
counter ``vit.boards`` over the loop, models/vit.py, over the loop's
epochs: the set-up epochs, the window's and the traced ones) × one
board's operations at the configuration's widths (flops/vit.py) × the
traced epochs, over 67 TFLOP/s × the traced busy seconds.  None where the
program has no such counter."""

import importlib

from benchmark.harness import peaks, spec


def read(run):
    if run.kind != 'train' or run.trace is None or not run.trace.busy_s:
        return None
    try:
        profiling = importlib.import_module(
            'cgs_vmc_tpu_torch.utils.profiling')
    except ImportError:
        return None
    report = getattr(profiling, 'span_report', None)
    if report is None:
        return None
    boards = report().get('loop_counters', {}).get('vit.boards')
    if not boards:
        return None
    epochs = (sum(k.startswith('epoch') for k in run.setup_parts)
              + run.units + run.trace.units)
    per_board = spec.flops(run.cell, 'vit').image(run.cell.config)
    return (100.0 * boards / epochs * per_board * run.trace.units
            / (peaks.F32_FLOPS * run.trace.busy_s))
