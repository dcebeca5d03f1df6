"""95th percentile of the window's epoch times, each the time between two
epoch ends of the normal training loop (linear interpolation between
order statistics)."""

import numpy as np


def read(run):
    if run.kind != 'train' or not run.units:
        return None
    return float(np.percentile(np.asarray(run.unit_s) * 1e3, 95))
