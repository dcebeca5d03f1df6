"""The transformer encoder's executed f32 operations in the traced
training epochs as a share of the card's f32 rate over the device's busy
time, in %: the images through the encoder an epoch (the program's
counter ``encoder.images`` over the loop, models/attention.py, over the
loop's epochs: the set-up epochs, the window's and the traced ones) ×
one image's operations at the configuration's widths
(flops/transformer.py) × the traced epochs, over 67 TFLOP/s × the traced
busy seconds.  None where the program has no such counter."""

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
    images = report().get('loop_counters', {}).get('encoder.images')
    if not images:
        return None
    epochs = (sum(k.startswith('epoch') for k in run.setup_parts)
              + run.units + run.trace.units)
    per_image = spec.flops(run.cell, 'transformer').image(run.cell.config)
    return (100.0 * images / epochs * per_image * run.trace.units
            / (peaks.F32_FLOPS * run.trace.busy_s))
