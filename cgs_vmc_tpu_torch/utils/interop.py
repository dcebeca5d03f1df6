"""Weights and states carried across from the JAX package.

The JAX package's params are nested dicts of arrays with the same key names
and layouts as the port's (Dense kernels ``[in, out]``), so carrying them
over is a leafwise copy.  `jax.device_get(params)` gives the numpy tree
these functions take.
"""

from __future__ import annotations

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, tree_map
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState


def params_from_numpy(tree, device) -> Params:
    """Nested dict of numpy arrays -> the port's params on `device`."""
    return tree_map(lambda x: torch.as_tensor(np.array(x)).to(device), tree)


def params_to_numpy(params: Params):
    """The port's params -> nested dict of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)


def sampler_state_from_numpy(configs, log_amp, sign, device,
                             seed: int = 0) -> SamplerState:
    """A SamplerState holding the given chains (zeroed statistics, a fresh
    generator on `device` seeded with `seed`)."""
    def put(x):
        return torch.as_tensor(np.array(x, dtype=np.float32)).to(device)
    configs = put(configs)
    zeros = torch.zeros(configs.shape[0], dtype=torch.float32, device=device)
    return SamplerState(
        configs=configs, log_amp=put(log_amp), sign=put(sign),
        generator=torch.Generator(device=device).manual_seed(seed),
        num_accepted=zeros, num_proposed=zeros.clone())
