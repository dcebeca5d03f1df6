"""Monte Carlo samples of every epoch completed in the window over the
window's seconds (batch_size × num_batches_per_epoch an epoch)."""


def read(run):
    if run.kind != 'train' or not run.units:
        return None
    return run.samples_per_unit * run.units / run.window_s
