"""The fused RBM sweep kernel with in-kernel draws (K2) against its
roofline: 11 f32 operations a hidden unit a proposal (flops/rbm.py), at
the card's f32 rate outside the tensor cores, over K2's device time in
the trace (the events of rbm_sweep_kernel instantiated with
PhiloxDraws)."""

from benchmark.harness import peaks


def share(run, kind):
    if (run.kind != kind or run.trace is None
            or run.k2_ops_per_unit is None):
        return None
    seconds = sum(s for name, s in run.trace.by_name.items()
                  if 'rbm_sweep_kernel' in name and 'PhiloxDraws' in name)
    if seconds <= 0:
        return None
    ops = run.k2_ops_per_unit * run.trace.units
    return 100.0 * ops / peaks.F32_FLOPS / seconds
