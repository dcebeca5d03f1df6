"""Weights and states carried across from the JAX package.

The JAX package's params are nested dicts of arrays with the same key names
and layouts as the port's (Dense kernels ``[in, out]``), so carrying them
over is a leafwise copy.  `jax.device_get(params)` gives the numpy tree
these functions take; the nested trees of the composites
(``{'a': ..., 'b': ...}``, ``{'modulus': ..., 'phase': ...}``) carry over
as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, tree_map
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState
from cgs_vmc_tpu_torch.sampler.tempering import PTSamplerState


def params_from_numpy(tree, device) -> Params:
    """Nested dict of numpy arrays -> the port's params on `device`."""
    return tree_map(lambda x: torch.as_tensor(np.array(x)).to(device), tree)


def params_to_numpy(params: Params):
    """The port's params -> nested dict of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)


def _put(x, device) -> torch.Tensor:
    """Real values become float32; complex ones complex64."""
    x = np.asarray(x)
    dtype = np.complex64 if np.iscomplexobj(x) else np.float32
    return torch.as_tensor(np.array(x, dtype=dtype)).to(device)


def sampler_state_from_numpy(configs, log_amp, sign, device,
                             seed: int = 0) -> SamplerState:
    """A SamplerState holding the given chains (zeroed statistics, a fresh
    generator on `device` seeded with `seed`).  Real values become
    float32; a complex log_amp or sign becomes complex64."""
    configs = _put(configs, device)
    zeros = torch.zeros(configs.shape[0], dtype=torch.float32, device=device)
    return SamplerState(
        configs=configs, log_amp=_put(log_amp, device),
        sign=_put(sign, device),
        generator=torch.Generator(device=device).manual_seed(seed),
        num_accepted=zeros, num_proposed=zeros.clone())


def pt_sampler_state_from_numpy(configs, log_amp, sign, aux_configs, aux_log,
                                aux_sign, betas, device,
                                seed: int = 0) -> PTSamplerState:
    """A PTSamplerState holding the given ladders — the fields of the JAX
    package's PTSamplerState of the same names — with zeroed statistics
    and a fresh generator on `device` seeded with `seed`."""
    physical = sampler_state_from_numpy(configs, log_amp, sign, device, seed)
    aux_log = _put(aux_log, device)
    return PTSamplerState(
        *physical, aux_configs=_put(aux_configs, device), aux_log=aux_log,
        aux_sign=_put(aux_sign, device), betas=_put(betas, device),
        swap_accepted=torch.zeros(aux_log.shape, device=device),
        swap_proposed=torch.zeros(aux_log.shape, device=device))
