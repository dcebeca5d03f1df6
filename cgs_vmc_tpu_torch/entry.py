"""The port's counterparts of the JAX package's entry points in
``__graft_entry__.py``: `entry`, the single-device forward step on the
flagship lattice, and `dryrun_multichip`, the multi-process dry run of the
sharded training step (parallel/dryrun.py, re-exported here).

    python -c "from cgs_vmc_tpu_torch import entry; \\
        fn, args = entry.entry(); print(fn(*args)[0].shape)"

The port runs eagerly, so `entry` returns a plain function where the JAX
one returns a function to jit.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from cgs_vmc_tpu_torch import basis, lattice, models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models.base import Params, tree_map
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.parallel.dryrun import dryrun_multichip
from cgs_vmc_tpu_torch.utils.device import resolve_device

__all__ = ['entry', 'dryrun_multichip']

N_BOARDS = 64


def entry(device='cuda') -> Tuple[Callable, Tuple[Params, torch.Tensor]]:
    """(forward_step, (params, configs)): the 2-D conv ansatz (5 layers of
    16 filters, 3×3 kernels, unsymmetrized) on the 6×6 Heisenberg lattice
    with the Marshall sign rotated in (j_x = −1), and 64 Sz=0 boards.

    ``forward_step(params, configs)`` returns ``(logψ, E_loc)``, each
    [boards].  Params come from a CPU generator seeded 0 and the boards
    from one seeded 1, then move to `device`, so every device gets the same
    inputs (JAX __graft_entry__.py:25-51)."""
    device = resolve_device(device)
    config = Config(
        num_sites=36, size_x=6, size_y=6,
        wavefunction_type='conv_2d',
        num_conv_layers=5, num_conv_filters=16, kernel_size=3,
        heisenberg_jx=-1.0,
    )
    wf = models.build_wavefunction(config)
    params = tree_map(lambda x: x.to(device),
                      wf.init(torch.Generator().manual_seed(0)))
    hamiltonian = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6),
                                        config.heisenberg_jx, 1.0)
    configs = basis.random_configurations(
        torch.Generator().manual_seed(1), config.num_sites,
        N_BOARDS).to(device)

    def forward_step(params: Params, configs: torch.Tensor):
        amp = wf.apply(params, configs)
        e_loc = hamiltonian.local_value(wf, params, configs, amp)
        return amp.log, e_loc

    return forward_step, (params, configs)
