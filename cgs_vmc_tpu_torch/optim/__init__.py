"""Optimizers of the port (cgs_vmc_tpu/optim/__init__.py's registry, with
the ones ported so far)."""

from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.optim.energy_gradient import EnergyGradientOptimizer

GROUND_STATE_OPTIMIZERS = {
    'EnergyGradient': EnergyGradientOptimizer,
}

__all__ = ['TrainState', 'EnergyGradientOptimizer',
           'GROUND_STATE_OPTIMIZERS']
