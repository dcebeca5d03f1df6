"""Model operations of one SR epoch with the dense minSR solve: M boards
(batch_size × num_batches_per_epoch), P parameters, R = M rows of the
Jacobian, or R = 2M for a complex log ψ (the model's flops module says
``COMPLEX_LOG = True``: the rows of log|ψ| and of the phase, stacked).

  proposals     (equilibration + batches × sweeps a sample) sweeps of N
                proposals on every chain
  local energy  one forward a board, and one a connected board: the
                antiparallel bonds of the boards the run returned
  rows          the backward pass of the Jacobian rows, 2 forwards a row
  assembly      2·R²·P;  Cholesky R³/3;  the two triangular solves 2·R²
"""


def sweeps(cfg: dict) -> int:
    return (cfg['num_equilibration_sweeps']
            + cfg['num_batches_per_epoch'] * cfg['num_monte_carlo_sweeps'])


def unit(cfg: dict, model, antiparallel: float) -> float:
    m = cfg['batch_size'] * cfg['num_batches_per_epoch']
    r = m * (2 if getattr(model, 'COMPLEX_LOG', False) else 1)
    p = model.params(cfg)
    proposals = (sweeps(cfg) * cfg['num_sites'] * cfg['batch_size']
                 * model.proposal(cfg))
    energies = m * (1.0 + antiparallel) * model.forward(cfg)
    rows = r * 2.0 * model.forward(cfg)
    solve = 2.0 * r * r * p + r ** 3 / 3.0 + 2.0 * r * r
    return proposals + energies + rows + solve
