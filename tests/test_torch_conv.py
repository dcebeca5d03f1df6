"""Slice 2 models against the JAX package: periodic convolutions, the four
conv ansatzes, the symmetry projection, the params-artifact reader, and
the flagship (deep48) on its committed samples.

Inputs are made with numpy from a seed and carried over with `interop`.
Tolerances: rtol 1e-5 in float32 (atol 1e-5 where logψ crosses zero: the
sums hold ~10^3 terms of O(0.1)); bfloat16 logψ within 4e-3·(1 + |logψ|),
one bf16 ulp (2^-8) of the O(1) site sums.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from cgs_vmc_tpu import basis, lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.evaluate import evaluate_operator as jax_evaluate
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.models import nn as jax_nn
from cgs_vmc_tpu.models import symmetry as jax_symmetry
from cgs_vmc_tpu.ops.heisenberg import HeisenbergHamiltonian as JaxHeisenberg
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu_torch import models
from cgs_vmc_tpu_torch.evaluate import evaluate_operator
from cgs_vmc_tpu_torch.models import nn, symmetry
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils import interop, msgpack_params

REPO = os.path.join(os.path.dirname(__file__), '..')
ARTIFACTS = os.path.join(REPO, 'artifacts')
SAMPLES = os.path.join(REPO, 'tests', 'data',
                       'flagship_6x6_deep48_samples.npy')
LOGPSI = os.path.join(REPO, 'tests', 'data', 'flagship_6x6_deep48_logpsi.npy')


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _perturbed_params(jax_wf, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))


def _sz0_configs(n_sites, n, seed):
    rng = np.random.default_rng(seed)
    template = np.repeat([1.0, -1.0], n_sites // 2).astype(np.float32)
    return np.stack([rng.permutation(template) for _ in range(n)])


@pytest.mark.parametrize('kernel', [1, 2, 3, 4])
@pytest.mark.parametrize('stride', [1, 2])
def test_periodic_conv_matches_jax(kernel, stride):
    """1-D and 2-D wrap-padded convs, on a 5×4 (size_x != size_y) grid."""
    rng = np.random.default_rng(10 * kernel + stride)
    x2 = rng.standard_normal((3, 5, 4, 2)).astype(np.float32)     # NHWC
    p2 = {'w': rng.standard_normal((kernel, kernel, 2, 3)),
          'b': rng.standard_normal(3)}
    p2 = {k: v.astype(np.float32) for k, v in p2.items()}
    ref = np.asarray(jax_nn.conv2d_periodic_apply(p2, jnp.asarray(x2),
                                                  stride))
    out = nn.conv2d_periodic_apply(interop.params_from_numpy(p2, 'cpu'),
                                   _t(x2).permute(0, 3, 1, 2), stride)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)

    x1 = rng.standard_normal((3, 7, 2)).astype(np.float32)        # NWC
    p1 = {'w': rng.standard_normal((kernel, 2, 3)).astype(np.float32),
          'b': rng.standard_normal(3).astype(np.float32)}
    ref = np.asarray(jax_nn.conv1d_periodic_apply(p1, jnp.asarray(x1),
                                                  stride))
    out = nn.conv1d_periodic_apply(interop.params_from_numpy(p1, 'cpu'),
                                   _t(x1).permute(0, 2, 1), stride)
    np.testing.assert_allclose(out.permute(0, 2, 1).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


_ANSATZES = {
    'conv_1d': dict(num_sites=12, wavefunction_type='conv_1d',
                    num_conv_layers=3, num_conv_filters=4, kernel_size=3),
    'conv_2d_3x4': dict(num_sites=12, size_x=3, size_y=4,
                        wavefunction_type='conv_2d', num_conv_layers=3,
                        num_conv_filters=4, kernel_size=2),
    'conv_2d_4x4': dict(num_sites=16, size_x=4, size_y=4,
                        wavefunction_type='conv_2d', num_conv_layers=2,
                        num_conv_filters=4, kernel_size=3),
    'res_net_1d': dict(num_sites=12, wavefunction_type='res_net_1d',
                       num_resnet_blocks=2, num_conv_filters=4,
                       kernel_size=3),
    'res_net_1d_bottleneck_stride2': dict(
        num_sites=12, wavefunction_type='res_net_1d', num_resnet_blocks=2,
        num_conv_filters=4, kernel_size=4, resnet_bottleneck=True,
        conv_strides=2),
    'res_net_2d_3x4': dict(num_sites=12, size_x=3, size_y=4,
                           wavefunction_type='res_net_2d',
                           num_resnet_blocks=2, num_conv_filters=4,
                           kernel_size=3),
    'res_net_2d_bottleneck_4x4': dict(
        num_sites=16, size_x=4, size_y=4, wavefunction_type='res_net_2d',
        num_resnet_blocks=2, num_conv_filters=4, kernel_size=3,
        resnet_bottleneck=True),
    'res_net_2d_stride2_4x4': dict(
        num_sites=16, size_x=4, size_y=4, wavefunction_type='res_net_2d',
        num_resnet_blocks=2, num_conv_filters=4, kernel_size=3,
        conv_strides=2),
}


def _compare_logpsi(config, seed, rtol, atol):
    jax_wf = jax_build(config)
    params = _perturbed_params(jax_wf, seed)
    configs = _sz0_configs(config.num_sites, 16, seed)
    ref = jax_wf.apply(params, configs)
    out = models.build_wavefunction(config).apply(
        interop.params_from_numpy(params, 'cpu'), _t(configs))
    np.testing.assert_allclose(out.log.numpy(), np.asarray(ref.log),
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(out.sign.numpy(), np.asarray(ref.sign))


@pytest.mark.parametrize('name', sorted(_ANSATZES))
def test_ansatz_logpsi_matches_jax(name):
    _compare_logpsi(Config(**_ANSATZES[name]), seed=3, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', ['conv_1d', 'conv_2d_3x4'])
def test_bfloat16_logpsi_matches_jax(name):
    """bf16 convs with f32 accumulation and an f32 site sum; the two
    backends round the per-layer outputs independently.  The bf16 result
    must also differ from the f32 one (the cast really happens)."""
    config = Config(compute_dtype='bfloat16', **_ANSATZES[name])
    jax_wf = jax_build(config)
    params = _perturbed_params(jax_wf, 4)
    configs = _sz0_configs(config.num_sites, 16, 4)
    ref = np.asarray(jax_wf.apply(params, configs).log)
    tparams = interop.params_from_numpy(params, 'cpu')
    out = models.build_wavefunction(config).apply(tparams, _t(configs)).log
    assert out.dtype == torch.float32
    assert np.all(np.abs(out.numpy() - ref) <= 4e-3 * (1 + np.abs(ref)))
    f32 = models.build_wavefunction(config.replace(
        compute_dtype='float32')).apply(tparams, _t(configs)).log
    assert not torch.equal(out, f32)


@pytest.mark.parametrize('size', [(4, 4), (3, 5), (6, 6), (1, 4)])
def test_square_point_group_equals_jax(size):
    np.testing.assert_array_equal(symmetry.square_point_group(*size),
                                  jax_symmetry.square_point_group(*size))


@pytest.mark.parametrize('spin_flip', [True, False])
@pytest.mark.parametrize('name', ['conv_2d_4x4', 'conv_2d_3x4',
                                  'res_net_2d_3x4'])
def test_symmetrized_logpsi_matches_jax(name, spin_flip):
    config = Config(symmetrize=True, symmetrize_spin_flip=spin_flip,
                    **_ANSATZES[name])
    wf = models.build_wavefunction(config)
    assert isinstance(wf, symmetry.SymmetrizedWavefunction)
    assert wf.n_ops == (16 if config.size_x == config.size_y else 8) // (
        1 if spin_flip else 2)
    _compare_logpsi(config, seed=5, rtol=1e-5, atol=1e-5)


def test_evaluate_from_given_chains_matches_jax():
    """evaluate_operator on chains started from given configurations,
    through the generic sampler (a symmetrized conv has no fast path),
    with zero sweeps: both packages average the same local energies."""
    config = Config(symmetrize=True, batch_size=12,
                    num_evaluation_samples=2, num_equilibration_sweeps=0,
                    num_monte_carlo_sweeps=0, heisenberg_jx=-1.0,
                    **_ANSATZES['conv_2d_4x4'])
    jax_wf = jax_build(config)
    params = _perturbed_params(jax_wf, 6)
    configs = _sz0_configs(16, 12, 6)
    bonds = lattice.square_lattice_bonds(4, 4)
    zeros = jnp.zeros(12, jnp.float32)
    ref = jax_evaluate(jax_wf, params, JaxHeisenberg(bonds, -1.0, 1.0),
                       config, state=JaxSamplerState(
                           jnp.asarray(configs), zeros, zeros + 1,
                           jax.random.split(jax.random.key(0), 12), zeros,
                           zeros))
    result = evaluate_operator(
        models.build_wavefunction(config),
        interop.params_from_numpy(params, 'cpu'),
        HeisenbergHamiltonian(bonds, -1.0, 1.0), config, 'cpu',
        state=interop.sampler_state_from_numpy(configs, np.zeros(12),
                                               np.ones(12), 'cpu'))
    np.testing.assert_allclose(result.mean, ref.mean, rtol=1e-5)
    np.testing.assert_allclose(result.values, ref.values, rtol=1e-5)


def test_symmetrize_needs_a_2d_lattice():
    with pytest.raises(ValueError, match='2-D'):
        models.build_wavefunction(Config(symmetrize=True,
                                         **_ANSATZES['conv_1d']))


_FLAGSHIP_ARTIFACTS = {
    'heisenberg_6x6_deep48': (7, 48),
    'heisenberg_6x6_symconv_v2': (5, 32),
    'heisenberg_6x6_symconv48_v2': (5, 48),
}


def _conv_config(layers, filters, side=6):
    return Config(num_sites=side * side, size_x=side, size_y=side,
                  wavefunction_type='conv_2d', num_conv_layers=layers,
                  num_conv_filters=filters, kernel_size=3, symmetrize=True,
                  heisenberg_jx=-1.0)


@pytest.mark.parametrize('name', sorted(_FLAGSHIP_ARTIFACTS))
def test_msgpack_reader_equals_flax(name):
    """The hand-written decoder gives flax's tree, leaf for leaf and bit
    for bit; restore_params_only lays it onto the port's template."""
    path = os.path.join(ARTIFACTS, f'{name}.msgpack')
    with open(path, 'rb') as f:
        data = f.read()
    ref = dict(msgpack_params.flat_leaves(serialization.msgpack_restore(data)))
    got = dict(msgpack_params.flat_leaves(msgpack_params.loads(data)))
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape
        assert got[key].tobytes() == value.tobytes(), key

    wf = models.build_wavefunction(_conv_config(*_FLAGSHIP_ARTIFACTS[name]))
    params = ckpt_lib.restore_params_only(
        path, wf.init(torch.Generator().manual_seed(0)))
    for key, leaf in msgpack_params.flat_leaves(params):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), ref[key])


def test_msgpack_reader_rejects_mismatches():
    path = os.path.join(ARTIFACTS, 'heisenberg_6x6_symconv_v2.msgpack')
    wrong_width = models.build_wavefunction(_conv_config(5, 48))
    with pytest.raises(ValueError,
                       match=r'conv_0/w is float32\[3, 3, 1, 32\]'):
        ckpt_lib.restore_params_only(
            path, wrong_width.init(torch.Generator().manual_seed(0)))
    wrong_depth = models.build_wavefunction(_conv_config(7, 32))
    with pytest.raises(ValueError, match='missing'):
        ckpt_lib.restore_params_only(
            path, wrong_depth.init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match='trailing'):
        msgpack_params.loads(b'\xc0\xc0')
    with pytest.raises(ValueError, match='truncated'):
        msgpack_params.loads(b'\x92\x01')


def test_msgpack_scalars_and_containers():
    """Every type head the decoder handles, against hand-packed bytes."""
    cases = {
        b'\x7f': 127, b'\xe0': -32, b'\xcc\xff': 255, b'\xcd\x01\x00': 256,
        b'\xce\x00\x01\x00\x00': 65536, b'\xd0\x80': -128,
        b'\xd1\xff\x00': -256, b'\xd2\xff\xff\xff\xff': -1,
        b'\xd3' + (2 ** 40).to_bytes(8, 'big'): 2 ** 40,
        b'\xcf' + (2 ** 63).to_bytes(8, 'big'): 2 ** 63,
        b'\xca\x3f\xc0\x00\x00': 1.5,
        b'\xcb\x3f\xf8\x00\x00\x00\x00\x00\x00': 1.5,
        b'\xc0': None, b'\xc2': False, b'\xc3': True,
        b'\xa3abc': 'abc', b'\xd9\x02hi': 'hi', b'\xc4\x02\x01\x02': b'\x01\x02',
        b'\x92\x01\xa1x': [1, 'x'], b'\xdc\x00\x01\x05': [5],
        b'\x81\xa1k\x90': {'k': []},
    }
    for data, value in cases.items():
        assert msgpack_params.loads(data) == value, data
    with pytest.raises(ValueError, match='extension'):
        msgpack_params.loads(b'\xd4\x05\x00')


def _fingerprint_table():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(REPO, 'chip_smoke.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_fingerprint_configs_are_the_jax_draw():
    """chip_smoke.py carries the fingerprints' configurations; they must
    be exactly tests/test_artifacts.py's basis.random_configurations(
    jax.random.key(1234), n_sites, n_configs) for every case."""
    smoke = _fingerprint_table()
    counts = {36: 12, 100: 8, 144: 6}      # test_artifacts.py CASES
    for _, _, _, side, _, _ in smoke.FINGERPRINTS:
        n_sites = side * side
        ref = np.asarray(basis.random_configurations(
            jax.random.key(1234), n_sites, counts[n_sites]))
        np.testing.assert_array_equal(smoke.fingerprint_configs(n_sites), ref)


def test_flagship_deep48_matches_committed_and_jax():
    """deep48 logψ over the 512 committed samples: within 1e-3 of the
    committed values (the pin's drift band) and of the JAX forward at
    rtol 1e-5 (atol 1e-5: a few logψ are near 0); local energies of 8
    samples against JAX's local_value at rtol 1e-5."""
    config = _conv_config(7, 48)
    path = os.path.join(ARTIFACTS, 'heisenberg_6x6_deep48.msgpack')
    wf = models.build_wavefunction(config)
    params = ckpt_lib.restore_params_only(
        path, wf.init(torch.Generator().manual_seed(0)))
    jax_wf = jax_build(config)
    with open(path, 'rb') as f:
        jax_params = serialization.from_bytes(
            jax_wf.init(jax.random.key(0)), f.read())

    samples = np.load(SAMPLES).astype(np.float32)
    with torch.no_grad():
        log_new = wf.apply(params, _t(samples)).log.numpy()
    assert np.max(np.abs(log_new - np.load(LOGPSI))) < 1e-3
    ref = np.asarray(jax.jit(lambda p, c: jax_wf.apply(p, c).log)(
        jax_params, samples))
    np.testing.assert_allclose(log_new, ref, rtol=1e-5, atol=1e-5)

    bonds = lattice.square_lattice_bonds(6, 6)
    few = samples[:8]
    with torch.no_grad():
        e_loc = HeisenbergHamiltonian(bonds, -1.0, 1.0).local_value(
            wf, params, _t(few)).numpy()
    e_ref = np.asarray(JaxHeisenberg(bonds, -1.0, 1.0).local_value(
        jax_wf, jax_params, jnp.asarray(few)))
    np.testing.assert_allclose(e_loc, e_ref, rtol=1e-5)
