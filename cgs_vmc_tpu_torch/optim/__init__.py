"""Optimizers of the port (cgs_vmc_tpu/optim/__init__.py's registries)."""

from cgs_vmc_tpu_torch.optim.common import TrainState
from cgs_vmc_tpu_torch.optim.energy_gradient import EnergyGradientOptimizer
from cgs_vmc_tpu_torch.optim.excited import (
    PenaltyExcitedOptimizer,
    SRPenaltyExcitedOptimizer,
)
from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
from cgs_vmc_tpu_torch.optim.swo import (
    BasisIterationSWO,
    DualSamplingSWO,
    ImaginaryTimeSWO,
    LogOverlapImaginaryTimeSWO,
    LogOverlapSWO,
    SupervisedWavefunctionOptimizer,
)

GROUND_STATE_OPTIMIZERS = {
    'EnergyGradient': EnergyGradientOptimizer,
    'LogOverlapITSWO': LogOverlapImaginaryTimeSWO,
    'ITSWO': ImaginaryTimeSWO,
    'SR': StochasticReconfiguration,
    'ExcitedPenalty': PenaltyExcitedOptimizer,
    'ExcitedSR': SRPenaltyExcitedOptimizer,
}

SUPERVISED_OPTIMIZERS = {
    'SWO': SupervisedWavefunctionOptimizer,
    'LogOverlapSWO': LogOverlapSWO,
    'DualSamplingSWO': DualSamplingSWO,
    'BasisIterSWO': BasisIterationSWO,
}

__all__ = ['TrainState', 'EnergyGradientOptimizer',
           'StochasticReconfiguration', 'ImaginaryTimeSWO',
           'LogOverlapImaginaryTimeSWO', 'SupervisedWavefunctionOptimizer',
           'LogOverlapSWO', 'DualSamplingSWO', 'BasisIterationSWO',
           'PenaltyExcitedOptimizer', 'SRPenaltyExcitedOptimizer',
           'GROUND_STATE_OPTIMIZERS', 'SUPERVISED_OPTIMIZERS']
