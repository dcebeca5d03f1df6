"""Kernel events on the card over the traced epochs, per epoch (copies
and sets left out)."""


def read(run):
    if run.kind != 'train' or run.trace is None or not run.trace.kernels:
        return None
    return run.trace.kernels / run.trace.units
