"""Exact-vector ansatz, a trainable dense state vector in a fixed Sz sector
(port of cgs_vmc_tpu/models/full_vector.py).

A configuration maps to its dense sector index through the Lin tables
(basis.make_lin_tables) and the amplitude is a gather from the vector.
Used as the exact target of supervised distillation and as a
zero-variance oracle (seeded with the ED ground state its local energy is
E0 on every configuration).  The tables are copied to a device once, the
first time a forward runs there, so a forward on the card copies nothing
and never waits for the host.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from cgs_vmc_tpu_torch import basis as basis_lib
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


@register('ed_vector')
class FullVector(Wavefunction):

    def __init__(self, num_sites: int, top_lin_table: np.ndarray,
                 bot_lin_table: np.ndarray, initial_vector: np.ndarray,
                 name: str = 'full_vector'):
        self.name = name
        self.num_sites = num_sites
        self.top_lin_table = np.asarray(top_lin_table, np.int64)
        self.bot_lin_table = np.asarray(bot_lin_table, np.int64)
        self.initial_vector = np.asarray(initial_vector, np.float32)
        self._tables: Dict[torch.device, tuple] = {}

    @classmethod
    def for_sector(cls, num_sites: int, initial_vector: np.ndarray,
                   n_up: int | None = None, name: str = 'full_vector'
                   ) -> 'FullVector':
        """Builds the Lin tables in-process.  `initial_vector` is given in
        `basis.enumerate_sz_basis` order (the order of the ED oracle and the
        evaluators) and is permuted into the tables' dense-index order."""
        top, bot = basis_lib.make_lin_tables(num_sites, n_up)
        n_down = None if n_up is None else num_sites - n_up
        states = basis_lib.enumerate_sz_basis(num_sites, n_down)
        lin_idx = basis_lib.lin_index(torch.from_numpy(states), top,
                                      bot).numpy()
        vector = np.asarray(initial_vector, np.float32)
        if vector.shape[0] != states.shape[0]:
            raise ValueError(
                f'vector length {vector.shape[0]} != sector dimension '
                f'{states.shape[0]}')
        permuted = np.empty_like(vector)
        permuted[lin_idx] = vector
        return cls(num_sites, top, bot, permuted, name=name)

    def init(self, generator: torch.Generator) -> Params:
        return {'ed_vector': torch.tensor(self.initial_vector,
                                          device=generator.device)}

    def _device_tables(self, device: torch.device) -> tuple:
        if device not in self._tables:
            self._tables[device] = (
                torch.as_tensor(self.top_lin_table, device=device),
                torch.as_tensor(self.bot_lin_table, device=device))
        return self._tables[device]

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        idx = basis_lib.lin_index(configs,
                                  *self._device_tables(configs.device))
        value = params['ed_vector'][idx]
        return LogAmp(torch.sign(value), torch.log(torch.abs(value)))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'FullVector':
        """Loads the initial vector (and the Lin tables, when both table
        files are set) from the reference's np.genfromtxt text files in
        the checkpoint directory; otherwise builds the tables in-process."""
        dir_path = config.checkpoint_dir
        initial_vector = np.genfromtxt(
            os.path.join(dir_path, config.ed_vector_file), dtype=np.float32)
        kwargs = {'name': name} if name else {}
        if config.top_lin_table_file and config.bot_lin_table_file:
            top = np.genfromtxt(
                os.path.join(dir_path, config.top_lin_table_file),
                dtype=np.int64)
            bot = np.genfromtxt(
                os.path.join(dir_path, config.bot_lin_table_file),
                dtype=np.int64)
            return cls(config.num_sites, top, bot, initial_vector, **kwargs)
        return cls.for_sector(config.num_sites, initial_vector, **kwargs)
