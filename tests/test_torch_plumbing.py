"""The run plumbing of the port against the JAX package, on the CPU: EMA
weights (the JAX `_ema_wrap` recursion, resume, `eval --ema`), the
params-only `.msgpack` writer (read bit for bit by the JAX package; every
committed artifact re-encoded byte for byte), a JAX run directory
evaluated, dumped, distilled from and its EMA read by the port, the basis
file, `epochs_per_call` and `profile_dir`.

Tolerances: the EMA slot rtol 1e-6 (the port's in-place lerp against the
JAX package's d·e + (1 − d)·p, float32); everything else bit for bit.
"""

import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgs_vmc_tpu import basis as jax_basis
from cgs_vmc_tpu.config import Config as JaxConfig
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.optim.common import TrainState as JaxTrainState
from cgs_vmc_tpu.train import _ema_wrap as jax_ema_wrap
from cgs_vmc_tpu.train import train as jax_train
from cgs_vmc_tpu.utils import checkpoint as jax_ckpt
from cgs_vmc_tpu_torch import basis, cli, models
from cgs_vmc_tpu_torch import train as train_lib
from cgs_vmc_tpu_torch.config import Config
from cgs_vmc_tpu_torch.models.base import tree_leaves, tree_map
from cgs_vmc_tpu_torch.train import train
from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
from cgs_vmc_tpu_torch.utils import interop, msgpack_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(glob.glob(os.path.join(REPO, 'artifacts', '*.msgpack')))
N = 8


def _values(**overrides):
    values = dict(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                  fc_layer_size=8,
                  wavefunction_optimizer_type='EnergyGradient',
                  batch_size=32, num_batches_per_epoch=1,
                  num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
                  learning_rates=[0.05], learning_rate_stops=[],
                  optimizer='gradient', heisenberg_jx=-1.0,
                  use_fast_sampler=False, seed=3, num_evaluation_samples=4)
    values.update(overrides)
    return values


def _config(**overrides):
    return Config(**_values(**overrides))


def _flat(params):
    return np.concatenate([x.detach().cpu().numpy().ravel()
                           for x in tree_leaves(params)])


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            _assert_trees_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


# ----------------------------------------------------------------------
# EMA weights.
# ----------------------------------------------------------------------

def test_ema_slot_follows_the_jax_recursion(tmp_path):
    """The slot after 4 epochs against the JAX `_ema_wrap` recursion run
    over the port's own params of epochs 0..4 (its checkpoints)."""
    config = _config(num_epochs=4, checkpoint_frequency=1,
                     max_checkpoints_to_keep=10, param_ema_decay=0.9,
                     checkpoint_dir=str(tmp_path))
    state = train(config, 'cpu')
    sequence = [interop.params_to_numpy(ckpt_lib.restore_params_from_checkpoint(
        str(tmp_path / f'ckpt_epoch_{e}.pt'), 'cpu')) for e in range(5)]
    steps = iter(sequence[1:])

    def epoch(s, axis_name=None):
        return s._replace(params=next(steps)), {}

    jax_state = JaxTrainState(params=sequence[0], opt_state={}, sampler=None,
                              epoch=0, extra={'ema_params': sequence[0]})
    fn = jax_ema_wrap(epoch, 0.9)
    for _ in range(4):
        jax_state, _ = fn(jax_state)
    want = jax.device_get(jax_state.extra['ema_params'])
    got = interop.params_to_numpy(state.extra['ema_params'])
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=1e-6,
                                                         atol=1e-8),
                 got, want)
    # The slot is checkpointed, and `eval --ema`'s restore reads it back.
    ema = ckpt_lib.restore_ema_from_checkpoint(
        ckpt_lib.latest_checkpoint(str(tmp_path)), 'cpu')
    np.testing.assert_array_equal(_flat(ema),
                                  _flat(state.extra['ema_params']))
    assert not np.allclose(_flat(ema), _flat(state.params))


def test_ema_survives_resume_bit_for_bit(tmp_path):
    """tests/test_training.py:162: 4 epochs straight equal 2 + a resumed
    2, the slot included."""
    base = dict(checkpoint_frequency=2, param_ema_decay=0.8)
    straight = train(_config(num_epochs=4, checkpoint_dir=str(tmp_path / 'a'),
                             **base), 'cpu')
    train(_config(num_epochs=2, checkpoint_dir=str(tmp_path / 'b'), **base),
          'cpu')
    resumed = train(_config(num_epochs=4, checkpoint_dir=str(tmp_path / 'b'),
                            **base), 'cpu', resume=True)
    np.testing.assert_array_equal(_flat(resumed.params),
                                  _flat(straight.params))
    np.testing.assert_array_equal(_flat(resumed.extra['ema_params']),
                                  _flat(straight.extra['ema_params']))


def test_ema_enabled_on_the_resume_of_an_old_run(tmp_path):
    """tests/test_training.py:221: the old checkpoint has no slot; the
    average starts at the restored params."""
    run = str(tmp_path)
    train(_config(num_epochs=2, checkpoint_frequency=2, checkpoint_dir=run),
          'cpu')
    restored = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(run),
                                           'cpu')
    assert 'ema_params' not in restored.extra
    config = _config(num_epochs=3, checkpoint_frequency=2,
                     checkpoint_dir=run, param_ema_decay=0.8)
    state = train(config, 'cpu', resume=True)
    want = 0.8 * _flat(restored.params) + 0.2 * _flat(state.params)
    np.testing.assert_allclose(_flat(state.extra['ema_params']), want,
                               rtol=1e-6, atol=1e-8)


def _cli_eval(*args):
    return cli.main(['eval', '--device', 'cpu', *args])


def test_cli_eval_ema_and_its_errors(tmp_path, capsys):
    run = str(tmp_path / 'run')
    train(_config(num_epochs=2, checkpoint_dir=run, param_ema_decay=0.9),
          'cpu')
    assert _cli_eval('--checkpoint_dir', run, '--ema') == 0
    ema_out = capsys.readouterr().out
    assert _cli_eval('--checkpoint_dir', run) == 0
    raw_out = capsys.readouterr().out
    e_ema = float(ema_out.split('Energy: ')[1].split(' +/- ')[0])
    e_raw = float(raw_out.split('Energy: ')[1].split(' +/- ')[0])
    assert np.isfinite(e_ema) and e_ema != e_raw
    # --ema with --params: the JAX CLI's message and exit code.
    artifact = ckpt_lib.save_params_only(
        str(tmp_path), ckpt_lib.restore_params_from_checkpoint(
            ckpt_lib.latest_checkpoint(run), 'cpu'), 'p')
    assert _cli_eval('--checkpoint_dir', run, '--ema', '--params',
                     artifact) == 1
    assert ('--ema cannot be combined with --params'
            in capsys.readouterr().err)
    # A run trained without the slot.
    plain = str(tmp_path / 'plain')
    train(_config(num_epochs=1, checkpoint_dir=plain), 'cpu')
    with pytest.raises(ValueError, match='carries no EMA parameters'):
        _cli_eval('--checkpoint_dir', plain, '--ema')


# ----------------------------------------------------------------------
# The params-only .msgpack writer.
# ----------------------------------------------------------------------

_WRITER_MODELS = {
    'rbm': dict(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                fc_layer_size=8),
    'conv_flagship': dict(num_sites=16, size_x=4, size_y=4,
                          wavefunction_type='conv_2d', num_conv_layers=2,
                          num_conv_filters=4, kernel_size=3,
                          symmetrize=True),
    'complex': dict(num_sites=N, wavefunction_type='complex',
                    composite_wavefunction_types=('rbm', 'fully_connected'),
                    num_fc_layers=1, fc_layer_size=6),
}


@pytest.mark.parametrize('kind', sorted(_WRITER_MODELS))
def test_port_params_read_by_jax_bit_for_bit(tmp_path, kind):
    """save_params_only's file: the JAX package's restore_params_only
    reads the port's params bit for bit, and its bytes are those of the
    JAX package's own save_params_only of the same params."""
    values = _WRITER_MODELS[kind]
    wf = models.build_wavefunction(Config(**values))
    rng = np.random.default_rng(5)
    params = tree_map(
        lambda x: x + torch.as_tensor(
            rng.standard_normal(tuple(x.shape)).astype(np.float32)),
        wf.init(torch.Generator().manual_seed(1)))
    path = ckpt_lib.save_params_only(str(tmp_path), params, 'port')
    jax_wf = jax_build(JaxConfig(**values))
    restored = jax_ckpt.restore_params_only(
        path, jax_wf.init(jax.random.key(0)))
    _assert_trees_equal(jax.device_get(restored),
                        interop.params_to_numpy(params))
    jax_path = jax_ckpt.save_params_only(
        str(tmp_path), jax.tree.map(jnp.asarray,
                                    interop.params_to_numpy(params)), 'jax')
    with open(path, 'rb') as a, open(jax_path, 'rb') as b:
        assert a.read() == b.read()
    back = ckpt_lib.restore_params_only(path, wf.init(torch.Generator()))
    np.testing.assert_array_equal(_flat(back), _flat(params))


@pytest.mark.parametrize('path', ARTIFACTS,
                         ids=[os.path.basename(p) for p in ARTIFACTS])
def test_committed_artifact_reencodes_byte_for_byte(path):
    with open(path, 'rb') as f:
        data = f.read()
    assert msgpack_params.dumps(msgpack_params.loads(data)) == data


def test_msgpack_writer_refuses_what_it_cannot_write():
    with pytest.raises(TypeError, match='cannot write'):
        msgpack_params.dumps({'x': object()})
    with pytest.raises(ValueError, match='cannot write'):
        msgpack_params.dumps(np.array([object()]))


# ----------------------------------------------------------------------
# A JAX run directory in the port.
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """The JAX package's `train` for 2 epochs with param_ema_decay=0.9:
    a run directory of ckpt_epoch_*.msgpack files."""
    run = str(tmp_path_factory.mktemp('jax_run'))
    jax_train(JaxConfig(**_values(num_epochs=2, checkpoint_frequency=1,
                                  param_ema_decay=0.9, checkpoint_dir=run)))
    return run


def test_jax_run_directory_params_and_ema(jax_run):
    latest = ckpt_lib.latest_checkpoint(jax_run)
    assert latest.endswith('ckpt_epoch_2.msgpack')
    wf = models.build_wavefunction(_config())
    template = wf.init(torch.Generator())
    jax_template = jax_build(JaxConfig(**_values())).init(jax.random.key(0))
    for port_fn, jax_fn in (
            (ckpt_lib.restore_params_from_checkpoint,
             jax_ckpt.restore_params_from_checkpoint),
            (ckpt_lib.restore_ema_from_checkpoint,
             jax_ckpt.restore_ema_from_checkpoint)):
        got = port_fn(latest, 'cpu', template)
        _assert_trees_equal(interop.params_to_numpy(got),
                            jax.device_get(jax_fn(latest, jax_template)))
        # Without a template: the same leaves, as stored.
        _assert_trees_equal(interop.params_to_numpy(port_fn(latest, 'cpu')),
                            interop.params_to_numpy(got))
    with pytest.raises(ValueError, match='JAX PRNG keys'):
        ckpt_lib.restore_checkpoint(latest, 'cpu')


def test_cli_eval_dump_and_distill_from_a_jax_run(jax_run, tmp_path,
                                                  capsys):
    assert _cli_eval('--checkpoint_dir', jax_run) == 0
    out = capsys.readouterr().out
    assert np.isfinite(float(out.split('Energy: ')[1].split(' +/- ')[0]))
    assert _cli_eval('--checkpoint_dir', jax_run, '--ema') == 0
    assert 'Energy: ' in capsys.readouterr().out
    assert cli.main(['dump', '--device', 'cpu', '--checkpoint_dir',
                     jax_run]) == 0
    psi = np.loadtxt(os.path.join(jax_run, 'wavefunction_epoch_0.txt'),
                     dtype=str)
    assert len(psi) == 70
    student = str(tmp_path / 'student')
    assert cli.main(['distill', '--device', 'cpu', '--supervisor_dir',
                     jax_run, '--checkpoint_dir', student, '--override',
                     'num_sites=8,wavefunction_type=rbm,num_fc_layers=0,'
                     'fc_layer_size=8,batch_size=32,num_epochs=2,'
                     'heisenberg_jx=-1.0,checkpoint_frequency=1']) == 0
    with open(os.path.join(student, 'metrics.jsonl')) as f:
        losses = [json.loads(line)['loss'] for line in f]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    # train --resume on the JAX run directory is refused.
    with pytest.raises(ValueError, match='JAX PRNG keys'):
        cli.main(['train', '--device', 'cpu', '--checkpoint_dir', jax_run,
                  '--resume', '--num_epochs', '3'])


def test_latest_checkpoint_prefers_the_higher_epoch_then_pt(tmp_path):
    for name in ('ckpt_epoch_3.msgpack', 'ckpt_epoch_2.pt'):
        (tmp_path / name).write_bytes(b'')
    assert ckpt_lib.latest_checkpoint(str(tmp_path)).endswith(
        'ckpt_epoch_3.msgpack')
    (tmp_path / 'ckpt_epoch_3.pt').write_bytes(b'')
    assert ckpt_lib.latest_checkpoint(str(tmp_path)).endswith(
        'ckpt_epoch_3.pt')
    (tmp_path / 'ckpt_epoch_4.msgpack').write_bytes(b'')
    assert ckpt_lib.latest_checkpoint(str(tmp_path)).endswith(
        'ckpt_epoch_4.msgpack')
    assert ckpt_lib.checkpoint_epoch(str(tmp_path /
                                         'ckpt_epoch_4.msgpack')) == 4


# ----------------------------------------------------------------------
# Basis files, epochs_per_call, profile_dir.
# ----------------------------------------------------------------------

def test_basis_file_round_trips_with_the_jax_package(tmp_path):
    states = basis.enumerate_sz_basis(N)
    basis.save_basis_file(str(tmp_path / 'port.txt'), states)
    np.testing.assert_array_equal(
        jax_basis.load_basis_file(str(tmp_path / 'port.txt')), states)
    jax_basis.save_basis_file(str(tmp_path / 'jax.txt'), states)
    np.testing.assert_array_equal(
        basis.load_basis_file(str(tmp_path / 'jax.txt')), states)
    assert (tmp_path / 'port.txt').read_text() == \
        (tmp_path / 'jax.txt').read_text()


def _metric_rows(run):
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


def _ckpt_epochs(run):
    return sorted(ckpt_lib.checkpoint_epoch(p)
                  for p in glob.glob(os.path.join(run, 'ckpt_epoch_*.pt')))


@pytest.mark.parametrize('freq', [3, 2])
def test_epochs_per_call_equals_per_epoch(tmp_path, freq):
    """k = 3 over 7 epochs (3 + 3 + a remainder of 1): the same metrics,
    params and checkpointed states as k = 1; checkpoints at the first
    block boundary at or after each checkpoint_frequency multiple."""
    base = dict(num_epochs=7, checkpoint_frequency=freq,
                max_checkpoints_to_keep=20, num_batches_per_epoch=2)
    one = str(tmp_path / 'one')
    three = str(tmp_path / 'three')
    a = train(_config(checkpoint_dir=one, **base), 'cpu')
    b = train(_config(checkpoint_dir=three, epochs_per_call=3, **base),
              'cpu')
    np.testing.assert_array_equal(_flat(b.params), _flat(a.params))
    rows_a, rows_b = _metric_rows(one), _metric_rows(three)
    assert [r['epoch'] for r in rows_b] == list(range(1, 8))
    for ra, rb in zip(rows_a, rows_b):
        for key in ('energy', 'energy_variance', 'acceptance_rate',
                    'grad_norm'):
            assert ra[key] == rb[key]
    want = {3: [0, 3, 6, 7], 2: [0, 3, 6, 7]}[freq]
    assert _ckpt_epochs(three) == want
    assert _ckpt_epochs(one) == sorted(set(range(0, 7, freq)) | {7})
    for epoch in set(_ckpt_epochs(one)) & set(want):
        name = f'ckpt_epoch_{epoch}.pt'
        np.testing.assert_array_equal(
            _flat(ckpt_lib.restore_params_from_checkpoint(
                os.path.join(one, name), 'cpu')),
            _flat(ckpt_lib.restore_params_from_checkpoint(
                os.path.join(three, name), 'cpu')))


def test_profile_dir_traces_the_second_call_only(tmp_path, monkeypatch):
    calls = []
    real = train_lib.maybe_trace

    def spy(trace_dir):
        calls.append(trace_dir)
        return real(trace_dir)

    monkeypatch.setattr(train_lib, 'maybe_trace', spy)
    trace_dir = str(tmp_path / 'trace')
    train(_config(num_epochs=3, profile_dir=trace_dir), 'cpu')
    assert calls == [None, trace_dir, None]
    traces = glob.glob(os.path.join(trace_dir, '*.pt.trace.json'))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)['traceEvents']
    assert any('aten::' in str(e.get('name', '')) for e in events)
    # The program's spans are record_function ranges of the trace, and
    # spans.json beside it holds the traced call's epochs and counters.
    names = {e.get('name') for e in events if e.get('cat') ==
             'user_annotation'}
    assert {'train.block', 'train.wait', 'train.log', 'epoch', 'sampler',
            'local_energy'} <= names
    assert _spans_json(trace_dir, [2])
    calls.clear()
    train(_config(num_epochs=7, epochs_per_call=3,
                  profile_dir=str(tmp_path / 'k3')), 'cpu')
    assert calls == [None, str(tmp_path / 'k3'), None]
    assert _spans_json(str(tmp_path / 'k3'), [4, 5, 6])


def _spans_json(trace_dir, epochs):
    """spans.json of `trace_dir` holds `epochs`, each with its host ms by
    span, their span records, and the connected-board counters."""
    with open(os.path.join(trace_dir, 'spans.json')) as f:
        spans = json.load(f)
    assert [row['epoch'] for row in spans['epochs']] == epochs
    for row in spans['epochs']:
        assert {'train.block', 'epoch', 'sampler',
                'local_energy'} <= set(row['host_ms'])
    assert {s['epoch'] for s in spans['spans']} == set(epochs)
    counters = spans['counters']
    return 0 < counters['connected.needed'] < counters['connected.evaluated']


def test_only_orbax_is_refused():
    assert train_lib._UNPORTED == (('checkpoint_backend', 'msgpack'),)
    with pytest.raises(NotImplementedError, match='checkpoint_backend'):
        train(_config(num_epochs=1, checkpoint_backend='orbax'), 'cpu')

