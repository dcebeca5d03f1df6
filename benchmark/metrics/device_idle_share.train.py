"""100 - the union of the card's kernel, copy and set intervals over the
host-clock length of the traced whole epochs, in %."""


def read(run):
    if run.kind != 'train' or run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
