"""Model operations of one SR epoch with the dense minSR solve: M boards
(batch_size × num_batches_per_epoch), P parameters.

  proposals     (equilibration + batches × sweeps a sample) sweeps of N
                proposals on every chain
  local energy  one forward a board, and one a connected board: the
                antiparallel bonds of the boards the run returned
  rows          the backward pass of the Jacobian rows, 2 forwards a board
  assembly      2·M²·P;  Cholesky M³/3;  the two triangular solves 2·M²
"""


def sweeps(cfg: dict) -> int:
    return (cfg['num_equilibration_sweeps']
            + cfg['num_batches_per_epoch'] * cfg['num_monte_carlo_sweeps'])


def unit(cfg: dict, model, antiparallel: float) -> float:
    m = cfg['batch_size'] * cfg['num_batches_per_epoch']
    p = model.params(cfg)
    proposals = (sweeps(cfg) * cfg['num_sites'] * cfg['batch_size']
                 * model.proposal(cfg))
    energies = m * (1.0 + antiparallel) * model.forward(cfg)
    rows = m * 2.0 * model.forward(cfg)
    solve = 2.0 * m * m * p + m ** 3 / 3.0 + 2.0 * m * m
    return proposals + energies + rows + solve
