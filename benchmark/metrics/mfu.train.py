"""The whole epoch's model operations (flops/) over the untraced window's
seconds, as a share of the card's f32 rate."""

from benchmark.harness import peaks


def read(run):
    if run.kind != 'train' or not run.units or run.flops_per_unit is None:
        return None
    return (100.0 * run.flops_per_unit * run.units
            / (run.window_s * peaks.F32_FLOPS))
