"""The compiled epoch of the port on the CPU (utils/cuda_graph.py,
train.py's `_scan_epochs` / `_runner`): the device-side learning rate and
optimizer step against the JAX package's, the static-buffer runner
(``replay='plain'``: the body a CUDA graph captures, called directly in
place of a replay) against the eager loop, the flattened train state, and
the checkpoints' epoch.

Tolerances: (a) float32 rtol 1e-6 against the JAX package (the bias
correction's power is taken in float32 by both, in another order);
everything else bit for bit.  The card's graph replays are held to the
eager runs by tests/test_torch_gpu.py and chip_smoke.py phase 38.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_epoch_graph.py -q
"""

import glob
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cgs_vmc_tpu.config import Config as JaxConfig
from cgs_vmc_tpu.optim.common import make_optax_optimizer
from cgs_vmc_tpu.train import _init_ground_state as jax_init
from cgs_vmc_tpu.utils import checkpoint as jax_ckpt
from cgs_vmc_tpu_torch import lattice, models
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models.full_vector import FullVector
from cgs_vmc_tpu_torch.optim import (GROUND_STATE_OPTIMIZERS,
                                     SUPERVISED_OPTIMIZERS)
from cgs_vmc_tpu_torch.optim.common import SgdOptimizer
from cgs_vmc_tpu_torch.train import (
    _scan_epochs, build_hamiltonian, distill, train)
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils import cuda_graph, ed, tree

N = 8


def _values(**overrides):
    values = dict(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                  fc_layer_size=8, batch_size=32, num_batches_per_epoch=2,
                  num_equilibration_sweeps=2, heisenberg_jx=-1.0,
                  optimizer='adam', learning_rates=[1e-2, 5e-3],
                  learning_rate_stops=[4], num_epochs=7,
                  param_ema_decay=0.9, sr_diag_shift=1e-2,
                  checkpoint_frequency=1, max_checkpoints_to_keep=20,
                  seed=5)
    values.update(overrides)
    return values


def _config(**overrides):
    return Config(**_values(**overrides))


# ----------------------------------------------------------------------
# (a) The learning rate and the step on the device, against the JAX
# package's SgdOptimizer.
# ----------------------------------------------------------------------

@pytest.mark.parametrize('kind', SgdOptimizer.KINDS)
def test_device_schedule_and_step_match_jax(kind):
    """Eight epochs across two stops (2 and 5): the learning rate of a
    device int32 epoch and of an int one against JAX's, and the params
    after each step (adam's count a device tensor) to float32 rtol 1e-6."""
    rates, stops = [0.1, 0.05, 0.01], [2, 5]
    jax_opt = make_optax_optimizer(JaxConfig(
        optimizer=kind, learning_rates=rates, learning_rate_stops=stops,
        beta2=0.99))
    port_opt = SgdOptimizer(kind, rates, stops, beta2=0.99)
    rng = np.random.default_rng(0)
    p0 = {'w': rng.standard_normal((3, 4)).astype(np.float32),
          'b': rng.standard_normal(4).astype(np.float32)}
    jax_params = jax.tree.map(jnp.asarray, p0)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    jax_state, state = jax_opt.init(jax_params), port_opt.init(params)
    if kind == 'adam':
        assert state['count'].dtype == torch.int32
    epoch = torch.zeros((), dtype=torch.int32)
    for step in range(8):
        want = float(jax_opt.learning_rate(jnp.int32(step)))
        assert float(port_opt.learning_rate(epoch)) == want
        assert float(port_opt.learning_rate(step)) == want
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in p0.items()}
        jax_params, jax_state = jax_opt.update(
            jax.tree.map(jnp.asarray, grads), jax_state, jax_params,
            jnp.int32(step))
        params, state = port_opt.update(
            {k: torch.tensor(v) for k, v in grads.items()}, state, params,
            epoch)
        for k in p0:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jax_params[k]),
                                       rtol=1e-6, atol=1e-7)
        epoch = epoch + 1
    if kind == 'adam':
        assert int(state['count']) == 8


# ----------------------------------------------------------------------
# (b) The static-buffer runner against the eager loop, bit for bit.
# ----------------------------------------------------------------------

class _Records:
    def __init__(self):
        self.rows = []

    def log(self, epoch, metrics):
        self.rows.append((epoch, {k: float(v) for k, v in metrics.items()}))


def _assert_nested_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for key in a:
            _assert_nested_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_nested_equal(x, y)
    else:
        assert a == b


def _assert_same_states(a, b):
    skel_a, leaves_a = tree.flatten(a)
    skel_b, leaves_b = tree.flatten(b)
    assert len(leaves_a) == len(leaves_b)
    for x, y in zip(leaves_a, leaves_b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    gens_a, gens_b = (tree.generators(s) for s in (skel_a, skel_b))
    assert len(gens_a) == len(gens_b) >= 1
    for x, y in zip(gens_a, gens_b):
        assert torch.equal(x.get_state(), y.get_state())


def _checkpoints(run_dir):
    return {os.path.basename(p): torch.load(p, weights_only=True)
            for p in sorted(glob.glob(os.path.join(run_dir, '*.pt')))}


def _run(fn, config, replay, **kwargs):
    records = _Records()
    state = fn(config, 'cpu', replay=replay, logger=records, **kwargs)
    return state, records.rows


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('name', ['EnergyGradient', 'SR', 'ITSWO'])
def test_plain_replays_equal_the_eager_loop(tmp_path, name, k):
    """N=8 RBM, adam, EMA on, 7 epochs with an LR stop at 4 (inside a
    block): the runner's blocks (the first eager, then the static-buffer
    body) give the eager loop's states, metrics and checkpoints bit for
    bit; so does a run resumed from its epoch-3 checkpoint."""
    config = _config(wavefunction_optimizer_type=name, epochs_per_call=k)
    eager, eager_rows = _run(train, config.replace(
        checkpoint_dir=str(tmp_path / 'eager')), 'eager')
    plain, plain_rows = _run(train, config.replace(
        checkpoint_dir=str(tmp_path / 'plain')), 'plain')
    _assert_same_states(eager, plain)
    assert plain_rows == eager_rows and len(eager_rows) == 7
    _assert_nested_equal(_checkpoints(str(tmp_path / 'eager')),
                         _checkpoints(str(tmp_path / 'plain')))

    resumed_dir = str(tmp_path / 'resumed')
    train(config.replace(checkpoint_dir=resumed_dir, num_epochs=3), 'cpu',
          replay='plain')
    assert ckpt_lib.latest_checkpoint(resumed_dir).endswith(
        'ckpt_epoch_3.pt')
    resumed, resumed_rows = _run(
        train, config.replace(checkpoint_dir=resumed_dir), 'plain',
        resume=True)
    _assert_same_states(eager, resumed)
    assert resumed_rows == eager_rows[3:]


@pytest.mark.parametrize('name', ['SWO', 'BasisIterSWO'])
def test_plain_distill_equals_the_eager_loop(tmp_path, name):
    """`distill` of the N=8 ED state, one block an epoch: the plain replays
    (BasisIterSWO's permutations drawn on the host before each one) equal
    the eager loop, checkpoints and the resume from epoch 3 included."""
    _, v0 = ed.ground_state(N, lattice.chain_bonds(N), j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    target = dict(target_wf=FullVector.for_sector(N, vector),
                  target_params={'ed_vector': torch.tensor(vector)})
    config = _config(wavefunction_optimizer_type=name, num_epochs=5)
    eager, eager_rows = _run(distill, config.replace(
        checkpoint_dir=str(tmp_path / 'eager')), 'eager', **target)
    plain, plain_rows = _run(distill, config.replace(
        checkpoint_dir=str(tmp_path / 'plain')), 'plain', **target)
    _assert_same_states(eager, plain)
    assert plain_rows == eager_rows and len(eager_rows) == 5
    _assert_nested_equal(_checkpoints(str(tmp_path / 'eager')),
                         _checkpoints(str(tmp_path / 'plain')))
    resumed_dir = str(tmp_path / 'resumed')
    distill(config.replace(checkpoint_dir=resumed_dir, num_epochs=3), 'cpu',
            replay='plain', **target)
    resumed, resumed_rows = _run(
        distill, config.replace(checkpoint_dir=resumed_dir), 'plain',
        resume=True, **target)
    _assert_same_states(eager, resumed)
    assert resumed_rows == eager_rows[3:]


# ----------------------------------------------------------------------
# (c) The flattened train state.
# ----------------------------------------------------------------------

def _optimizer_and_state(name):
    config = _config(wavefunction_optimizer_type=name, num_epochs=1)
    wf = models.build_wavefunction(config)
    if name in GROUND_STATE_OPTIMIZERS:
        opt = GROUND_STATE_OPTIMIZERS[name](wf, build_hamiltonian(config),
                                            config)
        return opt, opt.init_state(0, 'cpu')
    _, v0 = ed.ground_state(N, lattice.chain_bonds(N), j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    opt = SUPERVISED_OPTIMIZERS[name](
        wf, FullVector.for_sector(N, vector), config)
    return opt, opt.init_state(0, 'cpu', {'ed_vector': torch.tensor(vector)})


def _non_tensors(skeleton):
    """The skeleton's values other than containers and tensor markers."""
    if isinstance(skeleton, dict):
        return [v for x in skeleton.values() for v in _non_tensors(x)]
    if isinstance(skeleton, (list, tuple)):
        return [v for x in skeleton for v in _non_tensors(x)]
    return [] if skeleton is tree._LEAF else [skeleton]


@pytest.mark.parametrize('name', [
    'EnergyGradient', 'SR', 'ITSWO', 'LogOverlapITSWO', 'SWO',
    'LogOverlapSWO', 'DualSamplingSWO', 'BasisIterSWO'])
def test_flattened_state_is_tensors_and_survives_an_epoch(name):
    """Every value of a train state but its generators is a tensor (the
    epoch and adam's count included), flatten / unflatten round-trip, and
    an epoch leaves the non-tensor skeleton as it was."""
    opt, state = _optimizer_and_state(name)
    skeleton, leaves = tree.flatten(state)
    assert state.epoch.dtype == torch.int32
    assert all(isinstance(v, torch.Generator) for v in _non_tensors(skeleton))
    assert tree.generators(skeleton)
    assert list(map(id, tree.leaves(state))) == list(map(id, leaves))
    assert list(map(id, tree.generators(state))) == list(
        map(id, tree.generators(skeleton)))
    _assert_same_states(tree.unflatten(skeleton, leaves), state)
    new, _ = opt.epoch(state)
    assert tree.same_skeleton(tree.flatten(new)[0], skeleton)
    assert int(new.epoch) == 1


class _Pair(NamedTuple):
    value: torch.Tensor
    generator: torch.Generator


def test_tree_order_ignores_key_insertion_and_rebuilds_named_tuples():
    """The one walker (utils/tree.py) orders tensors by sorted dict keys,
    so two ranks that built a dict in other orders flatten alike; unflatten
    keeps each dict's own key order and rebuilds NamedTuples; a generator
    met twice is listed once."""
    gen = torch.Generator().manual_seed(0)
    a, b, c = (torch.tensor([float(i)]) for i in range(3))
    first = {'w': a, 'b': [b, gen], 'opt': _Pair(c, gen)}
    second = dict(reversed(list(first.items())))
    skel_1, leaves_1 = tree.flatten(first)
    skel_2, leaves_2 = tree.flatten(second)
    assert [id(t) for t in leaves_1] == [id(t) for t in leaves_2]
    back = tree.unflatten(skel_2, [t + 1 for t in leaves_2])
    assert list(back) == list(second)
    assert isinstance(back['opt'], _Pair) and back['opt'].generator is gen
    for key in first:
        want = first[key][0] if key != 'w' else first[key]
        got = back[key][0] if key != 'w' else back[key]
        assert torch.equal(got, want + 1)
    assert tree.generators(second) == [gen]
    assert tree.same_skeleton(skel_1, skel_2)


def test_a_frozen_python_value_is_refused():
    """A non-tensor value an epoch changes (here a Python counter in
    `extra`) would be frozen by a graph: the static-buffer body refuses
    it, as does a state whose structure changed between blocks."""
    opt, state = _optimizer_and_state('EnergyGradient')
    state = state._replace(extra={'calls': 0})

    def epoch(s, **kwargs):
        new, metrics = opt.epoch(s, **kwargs)
        return new._replace(extra={'calls': s.extra['calls'] + 1}), metrics

    runner = cuda_graph.EpochRunner(lambda k: _scan_epochs(epoch, k),
                                    torch.device('cpu'), 'plain')
    state, _ = runner.run(state, 1)          # the eager warm-up block
    with pytest.raises(RuntimeError, match='non-tensor part'):
        runner.run(state, 1)

    runner = cuda_graph.EpochRunner(lambda k: _scan_epochs(opt.epoch, k),
                                    torch.device('cpu'), 'plain')
    _, state = _optimizer_and_state('EnergyGradient')
    state, _ = runner.run(state, 1)
    state, _ = runner.run(state, 1)
    with pytest.raises(RuntimeError, match='structure'):
        runner.run(state._replace(extra={'new': torch.zeros(())}), 1)


@pytest.mark.parametrize('fields,eager', [
    (dict(wavefunction_type='rbm', wavefunction_optimizer_type='SR'), False),
    (dict(wavefunction_type='conv_2d', symmetrize=True,
          wavefunction_optimizer_type='SR'), False),
    (dict(wavefunction_type='pbdg',
          wavefunction_optimizer_type='EnergyGradient'), False),
    (dict(wavefunction_type='pbdg', wavefunction_optimizer_type='SR'), True),
    (dict(wavefunction_type='fully_connected_nnb',
          wavefunction_optimizer_type='ExcitedSR'), True),
    (dict(wavefunction_type='prod', wavefunction_optimizer_type='SR',
          composite_wavefunction_types=['jastrow', 'pbdg']), True),
])
def test_eager_table(fields, eager):
    """Which runs stay eager on a card: the determinant ansatzes under
    SR's torch.func rows (EAGER_PATHS), bare or inside a composite, and any
    run under a process group; everything else replays graphs."""
    config = _config(**fields)
    assert (cuda_graph.eager_reason(config, None) is not None) == eager
    assert 'group' in cuda_graph.eager_reason(config, object())


# ----------------------------------------------------------------------
# (d) Checkpoints: the epoch stays an int on disk.
# ----------------------------------------------------------------------

def test_checkpoints_keep_their_format(tmp_path):
    """The port's .pt files store the epoch as an int and restore it as an
    int32 tensor; a file of an earlier version (adam's count an int) loads
    with a tensor count; a JAX ckpt_epoch_n.msgpack run directory still
    names its epoch as an int and gives its params."""
    config = _config(checkpoint_dir=str(tmp_path / 'run'), num_epochs=2)
    train(config, 'cpu')
    path = ckpt_lib.latest_checkpoint(str(tmp_path / 'run'))
    raw = torch.load(path, weights_only=True)
    assert raw['epoch'] == 2 and isinstance(raw['epoch'], int)
    state = ckpt_lib.restore_checkpoint(path, 'cpu')
    assert state.epoch.dtype == torch.int32 and int(state.epoch) == 2
    assert state.opt_state['count'].dtype == torch.int32

    raw['opt_state']['count'] = int(raw['opt_state']['count'])
    old = str(tmp_path / 'old' / 'ckpt_epoch_2.pt')
    os.makedirs(os.path.dirname(old))
    torch.save(raw, old)
    restored = ckpt_lib.restore_checkpoint(old, 'cpu')
    assert restored.opt_state['count'].dtype == torch.int32
    assert torch.equal(restored.opt_state['count'], state.opt_state['count'])

    jax_dir = str(tmp_path / 'jax')
    jax_config = JaxConfig(**{k: v for k, v in _values().items()
                              if k not in ('checkpoint_frequency',)})
    _, _, _, jax_state = jax_init(jax_config)
    jax_ckpt.save_checkpoint(jax_dir, jax_state, 3)
    latest = ckpt_lib.latest_checkpoint(jax_dir)
    assert latest.endswith('ckpt_epoch_3.msgpack')
    assert ckpt_lib.checkpoint_epoch(latest) == 3
    assert isinstance(ckpt_lib.checkpoint_epoch(latest), int)
    params = ckpt_lib.restore_params_from_checkpoint(latest, 'cpu')
    assert params['hidden']['w'].shape == (N, 8)
