"""Set-up: from the process's start to the start of the window (imports,
the kernels' build or cache load, the weights, the warm-up, the graph
capture)."""


def read(run):
    return run.setup_s
