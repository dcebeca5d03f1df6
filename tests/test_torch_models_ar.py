"""The transformer and the two autoregressive ansatzes of the PyTorch port
against the JAX package, on the CPU.

Inputs are made with numpy from a seed (JAX-initialized params perturbed
with numpy noise, random Sz=0 configurations) and carried over with
`interop`.  Tolerances: logψ rtol/atol 1e-5; normalization over the
enumerated Sz=0 sector 1e-5; draws from injected uniforms equal the JAX
package's exactly; one SR epoch of the transformer rtol 1e-4 / atol 1e-6.
The two committed artifacts are read by the port's own msgpack reader and
held to the JAX package on 64 configurations at their full width.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from cgs_vmc_tpu import lattice
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops.heisenberg import HeisenbergHamiltonian as JaxHeisenberg
from cgs_vmc_tpu.optim.common import TrainState as JaxTrainState
from cgs_vmc_tpu.optim.sr import StochasticReconfiguration as JaxSR
from cgs_vmc_tpu.sampler.metropolis import SamplerState as JaxSamplerState
from cgs_vmc_tpu_torch import basis, cli, models
from cgs_vmc_tpu_torch.models.attention import SpinTransformer
from cgs_vmc_tpu_torch.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_tpu_torch.models.pixelcnn import MaskedConv2DAutoregressive
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS, TrainState
from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
from cgs_vmc_tpu_torch.sampler import registry
from cgs_vmc_tpu_torch.train import build_hamiltonian
from cgs_vmc_tpu_torch.utils import checkpoint, interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, 'artifacts')
N = 12
_MODELS = {
    'transformer': dict(num_sites=N, wavefunction_type='transformer',
                        num_attention_layers=2, attention_dim=16,
                        num_attention_heads=4),
    'made': dict(num_sites=N, wavefunction_type='made', num_fc_layers=1,
                 fc_layer_size=24),
    'made_deep': dict(num_sites=N, wavefunction_type='made', num_fc_layers=2,
                      fc_layer_size=24, nonlinearity='tanh'),
    'pixelcnn': dict(num_sites=N, size_x=4, size_y=3,
                     wavefunction_type='pixelcnn', num_conv_layers=3,
                     num_conv_filters=8, kernel_size=3),
}
_AUTOREGRESSIVE = ('made', 'made_deep', 'pixelcnn')
_CLASSES = {'transformer': SpinTransformer, 'made': AutoregressiveSpinModel,
            'made_deep': AutoregressiveSpinModel,
            'pixelcnn': MaskedConv2DAutoregressive}
# The committed artifacts: (file, config of the run that wrote it).
_ARTIFACTS = {
    'transformer': ('heisenberg_6x6_transformer', dict(
        num_sites=36, size_x=6, size_y=6, wavefunction_type='transformer',
        num_attention_layers=4, attention_dim=64, num_attention_heads=8,
        symmetrize=True)),
    'made': ('heisenberg_6x6_made', dict(
        num_sites=36, size_x=6, size_y=6, wavefunction_type='made',
        num_fc_layers=1, fc_layer_size=256)),
}


def _sz0_configs(rng, n_sites, batch):
    template = np.repeat([1.0, -1.0], n_sites // 2)
    return np.stack([rng.permutation(template) for _ in range(batch)]
                    ).astype(np.float32)


def _pair(kind, seed=0, noise=0.1):
    """(JAX wf, its params as jnp, the port's wf, the same params)."""
    config = Config(**_MODELS[kind])
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    wf = models.build_wavefunction(config)
    return (jax_wf, jax.tree.map(jnp.asarray, params), wf,
            interop.params_from_numpy(params, 'cpu'))


@pytest.mark.parametrize('kind', sorted(_MODELS))
def test_log_psi_matches_jax(kind):
    jax_wf, jax_params, wf, params = _pair(kind, seed=1)
    assert type(wf) is _CLASSES[kind]
    configs = _sz0_configs(np.random.default_rng(2), N, 32)
    ref = jax_wf.apply(jax_params, jnp.asarray(configs))
    got = wf.apply(params, torch.as_tensor(configs))
    np.testing.assert_allclose(got.log.numpy(), np.asarray(ref.log),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.sign.numpy(), np.asarray(ref.sign))


@pytest.mark.parametrize('kind', sorted(_MODELS))
def test_init_has_the_jax_tree_and_scales(kind):
    """Key paths and shapes equal the JAX package's; the leaves' spread is
    the JAX init's within 25% (both are sampled)."""
    jax_wf, _, wf, _ = _pair(kind)
    ref = jax.device_get(jax_wf.init(jax.random.key(3)))
    ours = interop.params_to_numpy(wf.init(torch.Generator().manual_seed(3)))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    our_leaves = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in ref_leaves] == [p for p, _ in our_leaves]
    for (path, a), (_, b) in zip(ref_leaves, our_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.size >= 256 and a.std() > 0:
            assert abs(b.std() / a.std() - 1.0) < 0.25, path
        elif a.std() == 0:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('kind', sorted(_ARTIFACTS))
def test_artifact_log_psi_matches_jax(kind):
    """The committed 6×6 artifact at its full width, read by the port's
    msgpack reader and by flax, on 64 configurations: logψ at 1e-5."""
    name, fields = _ARTIFACTS[kind]
    config = Config(**fields)
    path = os.path.join(ARTIFACTS, f'{name}.msgpack')
    jax_wf = jax_build(config)
    with open(path, 'rb') as f:
        jax_params = serialization.from_bytes(
            jax_wf.init(jax.random.key(0)), f.read())
    wf = models.build_wavefunction(config)
    params = checkpoint.restore_params_only(
        path, wf.init(torch.Generator().manual_seed(0)))
    configs = _sz0_configs(np.random.default_rng(4), 36, 64)
    ref = np.asarray(jax_wf.apply(jax_params, jnp.asarray(configs)).log)
    with torch.no_grad():
        got = wf.apply(params, torch.as_tensor(configs)).log.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.ptp(ref) > 1.0      # a trained net, not a flat one


@pytest.mark.parametrize('kind', _AUTOREGRESSIVE)
def test_law_is_normalized_on_the_sector(kind):
    """Σ|ψ|² over the enumerated Sz=0 sector is 1, and a configuration
    outside the sector has amplitude 0."""
    _, _, wf, params = _pair(kind, seed=5, noise=0.5)
    states = torch.as_tensor(basis.enumerate_sz_basis(N))
    with torch.no_grad():
        total = torch.exp(2.0 * wf.apply(params, states).log.double()).sum()
        outside = wf.apply(params, torch.ones(1, N)).log
    assert abs(float(total) - 1.0) < 1e-5
    assert float(outside) == -np.inf


@pytest.mark.parametrize('kind', _AUTOREGRESSIVE)
def test_logits_are_causal(kind):
    """Logit i does not move when spins >= i change."""
    _, _, wf, params = _pair(kind, seed=6, noise=0.5)
    rng = np.random.default_rng(7)
    configs = torch.as_tensor(_sz0_configs(rng, N, 8))
    with torch.no_grad():
        base = wf._logits(params, configs)
        for i in range(N):
            changed = configs.clone()
            changed[:, i:] = torch.as_tensor(
                rng.choice([-1.0, 1.0], size=(8, N - i)).astype(np.float32))
            moved = wf._logits(params, changed)
            torch.testing.assert_close(moved[:, :i + 1], base[:, :i + 1],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize('kind', _AUTOREGRESSIVE)
def test_injected_uniforms_give_the_jax_draws(kind):
    """`sample_from_uniforms` fed the uniforms the JAX package draws
    (`jax.random.uniform` of each of `jax.random.split(key, n)`, a chain)
    returns the configurations of `AutoregressiveSpinModel.sample`."""
    jax_wf, jax_params, wf, params = _pair(kind, seed=8, noise=0.5)
    keys = jax.random.split(jax.random.key(9), 64)
    ref = np.asarray(jax_wf.sample(jax_params, keys))
    uniforms = np.stack([
        np.asarray(jax.vmap(jax.random.uniform)(jax.random.split(key, N)))
        for key in keys])
    got = wf.sample_from_uniforms(params, torch.as_tensor(uniforms))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert bool((got.sum(dim=1) == 0).all())


@pytest.mark.parametrize('kind', _AUTOREGRESSIVE)
def test_generic_and_incremental_paths_agree(kind):
    """The dispatch: only a plain one-hidden-layer MADE takes the
    incremental path, and there both paths give the same draws; `sample`
    draws its uniforms from the generator."""
    _, _, wf, params = _pair(kind, seed=10, noise=0.5)
    uniforms = torch.as_tensor(
        np.random.default_rng(11).random((128, N)).astype(np.float32))
    generic = wf._sample_generic(params, uniforms)
    torch.testing.assert_close(wf.sample_from_uniforms(params, uniforms),
                               generic, rtol=0, atol=0)
    if kind == 'made':
        torch.testing.assert_close(wf._sample_incremental(params, uniforms),
                                   generic, rtol=0, atol=0)
    called = []
    wf._sample_incremental = lambda p, u: called.append(1) or generic
    wf.sample_from_uniforms(params, uniforms)
    assert bool(called) == (kind == 'made')
    generator = torch.Generator().manual_seed(12)
    expected = torch.rand((16, N),
                          generator=torch.Generator().manual_seed(12))
    del wf._sample_incremental
    torch.testing.assert_close(
        wf.sample(params, generator, 16),
        wf.sample_from_uniforms(params, expected), rtol=0, atol=0)


@pytest.mark.parametrize('kind', ['made', 'pixelcnn'])
def test_draws_follow_the_born_law(kind):
    """20,000 exact draws on N=8 against |ψ|² over the 70-state sector:
    total variation below 0.03 (the sampling noise of 20,000 draws over 70
    states is ~0.02)."""
    fields = dict(_MODELS[kind], num_sites=8)
    if kind == 'pixelcnn':
        fields.update(size_x=4, size_y=2)
    config = Config(**fields)
    wf = models.build_wavefunction(config)
    params = wf.init(torch.Generator().manual_seed(13))
    states = basis.enumerate_sz_basis(8)
    with torch.no_grad():
        born = torch.exp(2.0 * wf.apply(params, torch.as_tensor(states)).log
                         ).double().numpy()
    draws = wf.sample(params, torch.Generator().manual_seed(14), 20000)
    codes = ((draws.numpy() > 0) @ (1 << np.arange(8))).astype(np.int64)
    state_codes = ((states > 0) @ (1 << np.arange(8))).astype(np.int64)
    counts = np.array([(codes == c).sum() for c in state_codes])
    assert counts.sum() == 20000
    tv = 0.5 * np.abs(counts / 20000 - born).sum()
    assert tv < 0.03, tv


def test_transformer_sr_epoch_matches_jax():
    """One whole SR epoch of the transformer (zero sweeps, so both packages
    see the same samples): the harness of tests/test_torch_sr.py."""
    config = Config(**_MODELS['transformer'], heisenberg_jx=-1.0,
                    wavefunction_optimizer_type='SR', sr_diag_shift=1e-2,
                    sr_solver='dense', sr_delta_clip=10.0,
                    optimizer='gradient', learning_rates=[0.05],
                    learning_rate_stops=[], batch_size=24,
                    num_batches_per_epoch=2, num_equilibration_sweeps=0,
                    num_monte_carlo_sweeps=0, use_fast_sampler=False)
    jax_wf, jax_params, wf, tparams = _pair('transformer', seed=15)
    configs = _sz0_configs(np.random.default_rng(16), N, 24)
    jax_opt = JaxSR(jax_wf, JaxHeisenberg(lattice.chain_bonds(N), -1.0, 1.0),
                    config)
    opt = StochasticReconfiguration(wf, build_hamiltonian(config), config)
    amp = jax_wf.apply(jax_params, configs)
    log_amp, sign = np.asarray(amp.log), np.asarray(amp.sign)
    zeros = jnp.zeros(24, jnp.float32)
    jax_state = JaxTrainState(
        jax_params, jax_opt.optax_opt.init(jax_params),
        JaxSamplerState(jnp.asarray(configs), jnp.asarray(log_amp),
                        jnp.asarray(sign),
                        jax.random.split(jax.random.key(0), 24), zeros,
                        zeros),
        jnp.zeros((), jnp.int32), {})
    jax_new, jax_metrics = jax.jit(jax_opt.epoch)(jax_state)
    state = TrainState(tparams, opt.sgd.init(tparams),
                       interop.sampler_state_from_numpy(configs, log_amp,
                                                        sign, 'cpu'), 0, {})
    new, metrics = opt.epoch(state)
    for name in ('energy', 'energy_variance', 'grad_norm'):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jax_metrics[name]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    jax.tree.map(lambda x, y: np.testing.assert_allclose(
        x, np.asarray(y), rtol=1e-4, atol=1e-6),
        interop.params_to_numpy(new.params), jax.device_get(jax_new.params))


@pytest.mark.parametrize('kind', ['made', 'pixelcnn'])
def test_energy_gradient_epoch_runs_on_exact_draws(kind):
    """An EnergyGradient epoch of an autoregressive ansatz through the
    registry's exact sampler: finite metrics, acceptance exactly 1, chains
    in the sector, and gradients free of NaN although blocked conditionals
    hold -inf."""
    fields = dict(_MODELS[kind], heisenberg_jx=-1.0,
                  wavefunction_optimizer_type='EnergyGradient',
                  batch_size=32, num_batches_per_epoch=2,
                  num_equilibration_sweeps=1, num_monte_carlo_sweeps=1)
    config = Config(**fields)
    wf = models.build_wavefunction(config)
    assert registry.resolved_name(wf, config) == 'exact_autoregressive'
    opt = GROUND_STATE_OPTIMIZERS['EnergyGradient'](
        wf, build_hamiltonian(config), config)
    state = opt.init_state(17, 'cpu', config.batch_size)
    new, metrics = opt.epoch(state)
    assert np.isfinite(float(metrics['energy']))
    assert float(metrics['acceptance_rate']) == 1.0
    assert bool((new.sampler.configs.sum(dim=1) == 0).all())
    for leaf in jax.tree.leaves(interop.params_to_numpy(new.params)):
        assert np.isfinite(leaf).all()


def test_build_wavefunction_errors():
    with pytest.raises(ValueError, match='not registered'):
        models.build_wavefunction(Config(num_sites=N,
                                         wavefunction_type='no_such'))
    with pytest.raises(ValueError, match='even'):
        models.build_wavefunction(Config(num_sites=7,
                                         wavefunction_type='made'))
    with pytest.raises(ValueError, match='2-D'):
        models.build_wavefunction(Config(num_sites=N,
                                         wavefunction_type='pixelcnn'))
    with pytest.raises(ValueError, match='odd kernel'):
        MaskedConv2DAutoregressive(4, 3, kernel_size=4)
    with pytest.raises(ValueError, match='divisible'):
        SpinTransformer(N, model_dim=30, num_heads=4)


@pytest.mark.parametrize('name,override', [
    ('square66_transformer_sr',
     'num_epochs=1,batch_size=8,num_batches_per_epoch=2,'
     'num_equilibration_sweeps=1,num_monte_carlo_sweeps=1'),
    ('chain20_fc_energy', 'num_epochs=2,batch_size=32'),
])
def test_cli_trains_the_committed_config(name, override, tmp_path):
    """`cli train --config configs/{name}.json --device cpu` at a cut
    depth: the architecture, optimizer and Hamiltonian are the file's."""
    assert cli.main(['train', '--config',
                     os.path.join(REPO, 'configs', f'{name}.json'),
                     '--device', 'cpu', '--checkpoint_dir', str(tmp_path),
                     '--override', override]) == 0
    with open(tmp_path / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert len(records) == int(override.split(',')[0].split('=')[1])
    assert all(np.isfinite(r['energy']) for r in records)
