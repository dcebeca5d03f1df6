"""Optimizers of the port (cgs_vmc_tpu/optim/__init__.py's registry, with
the ones ported so far)."""

from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.optim.energy_gradient import EnergyGradientOptimizer
from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration

GROUND_STATE_OPTIMIZERS = {
    'EnergyGradient': EnergyGradientOptimizer,
    'SR': StochasticReconfiguration,
}

__all__ = ['TrainState', 'EnergyGradientOptimizer',
           'StochasticReconfiguration', 'GROUND_STATE_OPTIMIZERS']
