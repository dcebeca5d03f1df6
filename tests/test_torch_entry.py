"""The port's `entry()` (cgs_vmc_tpu_torch/entry.py) against the JAX
package's `__graft_entry__.entry()`: the same forward step on the same
params and boards, carried across from JAX with `interop`.

Tolerance: logψ and E_loc at rtol 1e-5 / atol 1e-5 in float32 (logψ sums
~10^3 conv terms of O(0.1); E_loc adds 72 bond ratios of O(1)).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from cgs_vmc_tpu_torch import entry
from cgs_vmc_tpu_torch.utils import interop


@pytest.fixture(scope='module')
def jax_step():
    fn, (params, configs) = jax_entry.entry()
    log_psi, e_loc = jax.jit(fn)(params, configs)
    return (jax.device_get(params), np.asarray(configs), np.asarray(log_psi),
            np.asarray(e_loc))


def test_forward_step_matches_jax(jax_step):
    params, configs, log_psi, e_loc = jax_step
    fn, _ = entry.entry(device='cpu')
    out_log, out_e = fn(interop.params_from_numpy(params, 'cpu'),
                        torch.as_tensor(np.array(configs)))
    np.testing.assert_allclose(out_log.numpy(), log_psi, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out_e.numpy(), e_loc, rtol=1e-5, atol=1e-5)


def test_own_draw_is_64_finite_sz0_boards():
    fn, (params, configs) = entry.entry(device='cpu')
    assert tuple(configs.shape) == (64, 36)
    assert configs.dtype == torch.float32
    assert bool((configs.abs() == 1).all())
    assert bool((configs.sum(dim=1) == 0).all())
    log_psi, e_loc = fn(params, configs)
    assert tuple(log_psi.shape) == (64,) and tuple(e_loc.shape) == (64,)
    assert bool(torch.isfinite(log_psi).all())
    assert bool(torch.isfinite(e_loc).all())
    # The same inputs on every call: CPU generators seeded 0 and 1.
    _, (params2, configs2) = entry.entry(device='cpu')
    assert torch.equal(configs, configs2)
    assert all(torch.equal(params[k][n], params2[k][n])
               for k in params for n in params[k])


def test_dryrun_multichip_is_reexported():
    from cgs_vmc_tpu_torch.parallel import dryrun
    assert entry.dryrun_multichip is dryrun.dryrun_multichip
