"""Model operations of one ITSWO epoch, B batches of `batch_size` boards:

  proposals     (equilibration + B × sweeps a sample) sweeps of N
                proposals on every chain
  local energy  of ψ_ω: one forward a board and one a connected board
                (the antiparallel bonds of the boards the run returned)
  fit           ψ_θ on every board (a forward) and its backward
                (2 forwards)
"""


def sweeps(cfg: dict) -> int:
    return (cfg['num_equilibration_sweeps']
            + cfg['num_batches_per_epoch'] * cfg['num_monte_carlo_sweeps'])


def unit(cfg: dict, model, antiparallel: float) -> float:
    m = cfg['batch_size'] * cfg['num_batches_per_epoch']
    proposals = (sweeps(cfg) * cfg['num_sites'] * cfg['batch_size']
                 * model.proposal(cfg))
    energies = m * (1.0 + antiparallel) * model.forward(cfg)
    fit = m * 3.0 * model.forward(cfg)
    return proposals + energies + fit
