"""What the benchmark takes from the program under test,
``cgs_vmc_tpu_torch``: its configuration type, its entry ``train``, the
epoch runner that entry builds (whose captured graph the check replays),
the parts of an epoch the check follows, and nothing else.  Imported
only once the card has been found."""

from __future__ import annotations

import contextlib
import importlib
from typing import Any, Dict, Iterator, List

from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils.cuda_graph import EpochRunner

__all__ = ['Config', 'train', 'config_from', 'wavefunction', 'hamiltonian',
           'optimizer', 'run_values', 'runners']


def config_from(values: Dict[str, Any]) -> Config:
    """A Config of `values` (lists become tuples where the field is one)."""
    defaults = Config()
    values = {k: tuple(v) if isinstance(getattr(defaults, k, None), tuple)
              and isinstance(v, list) else v for k, v in values.items()}
    return defaults.override_from_dict(values)


def wavefunction(config: Config):
    return models.build_wavefunction(config)


def hamiltonian(config: Config):
    return build_hamiltonian(config)


def optimizer(config: Config):
    """The ground-state optimizer ``train`` builds for `config`."""
    name = config.wavefunction_optimizer_type or 'ITSWO'
    return GROUND_STATE_OPTIMIZERS[name](
        wavefunction(config), hamiltonian(config), config)


def run_values(cell, seed: int, extra: Dict[str, Any]) -> Dict[str, Any]:
    """The configuration's fields as run: the file's, the mix's overrides,
    then `extra`."""
    values = dict(cell.config)
    values.update(cell.traffic.get('override', {}))
    values.update(extra)
    values['seed'] = seed
    return values


@contextlib.contextmanager
def runners() -> Iterator[List[EpochRunner]]:
    """Inside the block, every EpochRunner that ``train`` builds is also
    kept in the list yielded: the loop's own runner, whose captured CUDA
    graph the check replays once the window has closed.  The runner runs
    as it would; only a reference to it is kept."""
    module = importlib.import_module('cgs_vmc_tpu_torch.train')
    made: List[EpochRunner] = []

    class Kept(EpochRunner):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    module.EpochRunner = Kept
    try:
        yield made
    finally:
        module.EpochRunner = EpochRunner
