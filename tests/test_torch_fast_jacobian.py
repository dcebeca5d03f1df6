"""The port's fast Jacobian rows (cgs_vmc_tpu_torch/optim/fast_jacobian.py)
against the port's vmap(grad) rows and the JAX package's fast rows on the
same params and configs, and one SR epoch with sr_fast_jacobian on and off.

Tolerances are the JAX package's (tests/test_fast_jacobian.py): atol
3e-5·max|rows|, rtol 2e-4; for the ResNets' relu/selu kinks, all but a
0.5% share of the entries within that bound and a global L2 difference
under 2e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu.config import Config as JaxConfig
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.optim import fast_jacobian as jax_fast
from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.optim import fast_jacobian
from cgs_vmc_tpu_torch.optim.sr import (StochasticReconfiguration,
                                        flatten_params, jacobian_rows)
from cgs_vmc_tpu_torch.train import build_hamiltonian
from cgs_vmc_tpu_torch.utils import interop

SQUARE = dict(num_sites=16, size_x=4, size_y=4)
CASES = {
    'conv_2d_sym': (dict(SQUARE, wavefunction_type='conv_2d',
                         num_conv_layers=2, num_conv_filters=4,
                         kernel_size=3, symmetrize=True), 0.0),
    'conv_1d_even_kernel': (dict(num_sites=12, wavefunction_type='conv_1d',
                                 num_conv_layers=2, num_conv_filters=5,
                                 kernel_size=4), 0.0),
    'resnet_1d': (dict(num_sites=12, wavefunction_type='res_net_1d',
                       num_resnet_blocks=2, num_conv_filters=6,
                       kernel_size=3), 0.005),
    'resnet_1d_bottleneck': (dict(num_sites=12,
                                  wavefunction_type='res_net_1d',
                                  num_resnet_blocks=2, num_conv_filters=6,
                                  kernel_size=3, resnet_bottleneck=True),
                             0.005),
    'resnet_2d_sym': (dict(SQUARE, wavefunction_type='res_net_2d',
                           num_resnet_blocks=2, num_conv_filters=6,
                           kernel_size=3, symmetrize=True), 0.005),
    'pixelcnn': (dict(SQUARE, wavefunction_type='pixelcnn',
                      num_conv_layers=2, num_conv_filters=6,
                      kernel_size=3), 0.0),
}


def _configs(n_sites: int, batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    template = np.repeat([1.0, -1.0], n_sites // 2)
    return np.stack([rng.permutation(template) for _ in range(batch)]
                    ).astype(np.float32)


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaf_paths(value, prefix + (key,))
    else:
        yield prefix, tree


def _in_port_order(jax_rows: np.ndarray, params) -> np.ndarray:
    """JAX rows (ravel_pytree order: dict keys sorted at every level) with
    their columns put in the port's flatten_params order."""
    leaves = list(_leaf_paths(params))
    offsets, at = {}, 0
    for path, leaf in sorted(leaves, key=lambda x: x[0]):
        offsets[path] = at
        at += leaf.numel()
    columns = np.concatenate([offsets[path] + np.arange(leaf.numel())
                              for path, leaf in leaves])
    return jax_rows[:, columns]


def _vmap_rows(wf, params, configs, chunk):
    flat, unflatten = flatten_params(params)

    def single_log(p_flat, config):
        return wf.apply(unflatten(p_flat), config[None, :]).log[0]

    return jacobian_rows(single_log, flat, configs, chunk).numpy()


def _assert_rows_close(got, want, kink_frac):
    """The JAX test's rule (tests/test_fast_jacobian.py:40-59)."""
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-12
    if kink_frac:
        tol = 3e-5 * scale + 2e-4 * np.abs(want)
        frac = float((np.abs(got - want) > tol).mean())
        assert frac <= kink_frac, f'violating fraction {frac}'
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-3, f'global L2 rel diff {rel}'
    else:
        np.testing.assert_allclose(got, want, atol=3e-5 * scale, rtol=2e-4)


def _rows_three_ways(fields, batch=12, chunk=0, seed=0):
    """(port fast rows, port vmap rows, JAX fast rows in port order)."""
    jax_wf = jax_build(JaxConfig(**fields))
    params = jax.device_get(jax_wf.init(jax.random.key(seed)))
    configs = _configs(fields['num_sites'], batch, seed + 1)
    jax_rows = np.asarray(jax.jit(jax_fast.rows_fn_for(jax_wf),
                                  static_argnums=2)(
        params, jnp.asarray(configs), chunk))
    wf = models.build_wavefunction(Config(**fields))
    tparams = interop.params_from_numpy(params, 'cpu')
    tconfigs = torch.as_tensor(configs)
    fast = fast_jacobian.rows_fn_for(wf)
    assert fast is not None
    got = fast(tparams, tconfigs, chunk)
    assert got.dtype == torch.float32
    return (got.numpy(), _vmap_rows(wf, tparams, tconfigs, chunk),
            _in_port_order(jax_rows, tparams))


@pytest.mark.parametrize('case', sorted(CASES))
def test_fast_rows_match_vmap_and_jax(case):
    fields, kink_frac = CASES[case]
    got, vmap_rows, jax_rows = _rows_three_ways(fields)
    _assert_rows_close(got, vmap_rows, kink_frac)
    _assert_rows_close(got, jax_rows, kink_frac)


def test_chunk_padding():
    """batch 10 at chunk 4: 3 chunks, the last padded by 2 rows that are
    dropped; equal to the unchunked rows."""
    fields = CASES['conv_2d_sym'][0]
    got, vmap_rows, jax_rows = _rows_three_ways(fields, batch=10, chunk=4)
    assert got.shape[0] == 10
    _assert_rows_close(got, vmap_rows, 0.0)
    _assert_rows_close(got, jax_rows, 0.0)
    unchunked, _, _ = _rows_three_ways(fields, batch=10)
    np.testing.assert_allclose(got, unchunked, rtol=1e-5, atol=1e-7)


def test_unsupported_ansatzes_have_no_fast_rows():
    rbm = models.build_wavefunction(Config(num_sites=8,
                                           wavefunction_type='rbm'))
    assert fast_jacobian.rows_fn_for(rbm) is None
    strided = models.build_wavefunction(Config(
        **SQUARE, wavefunction_type='res_net_2d', num_resnet_blocks=1,
        num_conv_filters=4, kernel_size=3, conv_strides=2))
    assert fast_jacobian.rows_fn_for(strided) is None


@pytest.mark.parametrize('solver', ['dense', 'sample_cg'])
def test_sr_epoch_with_fast_rows_equals_vmap_rows(solver):
    """One SR epoch with sr_fast_jacobian on and off from the same state:
    the same samples, params and energy at rtol 1e-4; the fast rows are
    the ones the optimizer took."""
    base = dict(SQUARE, wavefunction_type='conv_2d', num_conv_layers=2,
                num_conv_filters=4, kernel_size=3, symmetrize=True,
                wavefunction_optimizer_type='SR', batch_size=16,
                num_batches_per_epoch=2, num_equilibration_sweeps=2,
                num_monte_carlo_sweeps=1, optimizer='gradient',
                learning_rates=[0.02], learning_rate_stops=[],
                heisenberg_jx=-1.0, sr_solver=solver, sr_cg_tol=1e-9,
                sr_cg_maxiter=200, sr_diag_shift=1e-2, sr_delta_clip=1.0,
                seed=3)
    outs = []
    for fast in (True, False):
        config = Config(sr_fast_jacobian=fast, **base)
        opt = StochasticReconfiguration(models.build_wavefunction(config),
                                        build_hamiltonian(config), config)
        assert (opt.fast_rows is not None) == fast
        calls = []
        if fast:
            rows = opt.fast_rows
            opt.fast_rows = lambda *args: calls.append(1) or rows(*args)
        state, metrics = opt.epoch(opt.init_state(config.seed, 'cpu'))
        assert len(calls) == fast
        outs.append((flatten_params(state.params)[0].numpy(),
                     float(metrics['energy']), state.sampler.configs))
    assert torch.equal(outs[0][2], outs[1][2])
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(outs[0][1], outs[1][1], rtol=1e-4)
