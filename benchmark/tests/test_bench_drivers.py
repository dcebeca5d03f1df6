"""Each driver end to end at a tiny size on the CPU, through the port's
plain paths (the harness's look for a card skipped), and the faults the
check has to catch, each planted underneath a whole run.  The loop runs
its blocks as ``replay='plain'``: the static-buffer body that a CUDA graph
captures on the card, called directly, so that a fault of that body shows
here as it would in a replay."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run as run_py
from benchmark.harness import spec
from cgs_vmc_tpu_torch.ops.heisenberg import LocalOperator
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_tpu_torch.sampler import fast_rbm, metropolis
from cgs_vmc_tpu_torch.utils import cuda_graph

BENCH = spec.load_benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]
TINY = {
    'chain40_rbm': {'num_sites': 8, 'fc_layer_size': 16, 'batch_size': 32,
                    'num_equilibration_sweeps': 2},
    'square66_conv': {'num_sites': 16, 'size_x': 4, 'size_y': 4,
                      'num_conv_filters': 4, 'batch_size': 16,
                      'energy_chunk_samples': 8,
                      'num_equilibration_sweeps': 1,
                      'num_monte_carlo_sweeps': 1},
    'square66_transformer': {'num_sites': 16, 'size_x': 4, 'size_y': 4,
                             'attention_dim': 16, 'num_attention_heads': 2,
                             'num_attention_layers': 2, 'batch_size': 8,
                             'energy_chunk_samples': 8,
                             'num_equilibration_sweeps': 1,
                             'num_monte_carlo_sweeps': 1},
}
LINE_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def measure(name, trace=False, seed=2 ** 31 + 7, replay='plain'):
    cell = spec.cell(name, BENCH)
    return cell, run_py.measure(cell, seed, 0.2, trace, device='cpu',
                                started=time.perf_counter(),
                                overrides=TINY[cell.config_name],
                                replay=replay)


@pytest.mark.parametrize('trace,replay', [(False, 'plain'), (True, 'plain'),
                                          (False, None)])
@pytest.mark.parametrize('name', CELLS)
def test_driver_prints_a_line_of_the_contracts_shape(name, trace, replay):
    cell, line = measure(name, trace, replay=replay)
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == 'checks'
    assert line['correct'] is True, line['checks']
    assert line['attempted'] >= 1 and line['failed'] == 0
    assert set(line['checks']) == set(cell.limits)
    for check in line['checks'].values():
        assert set(check) == {'value', 'limit'}
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(line['metrics']) <= {m['name'] for m in wanted}
    if not trace:
        # The card's numbers (traces) are not read on the CPU; the host
        # clock's are.
        assert set(line['metrics']) == {m['name'] for m in wanted}
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'} and m['value'] > 0
    json.dumps(line, allow_nan=False)


def _unchanged_step(monkeypatch):
    """Every optimizer's epoch returns its params unchanged (the epoch
    counter still advances)."""
    for cls in set(GROUND_STATE_OPTIMIZERS.values()):
        def epoch(self, state, _orig=cls.epoch, **kwargs):
            new, metrics = _orig(self, state, **kwargs)
            return new._replace(params=state.params), metrics
        monkeypatch.setattr(cls, 'epoch', epoch)


def _half_batch(monkeypatch):
    """Local values of the first half of the boards only, repeated: every
    mean is taken over half the batch."""
    orig = LocalOperator.local_value

    def local_value(self, wf, params, configs, amp=None):
        half = configs.shape[0] // 2
        part = None if amp is None else type(amp)(amp.sign[:half],
                                                   amp.log[:half])
        v = orig(self, wf, params, configs[:half], part)
        return torch.cat([v, v])[:configs.shape[0]]
    monkeypatch.setattr(LocalOperator, 'local_value', local_value)


def _altered_answer(monkeypatch):
    """One local energy off by one where it is produced."""
    orig = LocalOperator.local_value

    def local_value(self, *args, **kwargs):
        v = orig(self, *args, **kwargs).clone()
        v[0] += 1.0
        return v
    monkeypatch.setattr(LocalOperator, 'local_value', local_value)


def _frozen_sampler(monkeypatch):
    """Every block of sweeps returns the chains where they were."""
    def frozen(wf, params, state, num_sweeps, *args, **kwargs):
        return state
    monkeypatch.setattr(fast_rbm, 'run_sweeps', frozen)
    monkeypatch.setattr(metropolis, 'run_sweeps', frozen)


def _replay_keeps_params(monkeypatch):
    """The replayed body copies every tensor of the new state back into
    its static buffers except the params: each replay leaves them as they
    were."""
    def body(self, _orig=cuda_graph._Block._body):
        params = [b.clone() for b in self.buffers[:_params_count(self)]]
        _orig(self)
        for buffer, was in zip(self.buffers, params):
            buffer.copy_(was)
    monkeypatch.setattr(cuda_graph._Block, '_body', body)


def _params_count(block) -> int:
    state = cuda_graph.unflatten(block.skeleton, block.buffers)
    return len(cuda_graph.flatten(state.params)[1])


def _replay_repeats_draws(monkeypatch):
    """Every replay puts the state's generators back where they stood
    before it: each replay makes the same draws."""
    def replay(self, state, inputs, _orig=cuda_graph._Block.replay):
        gens = cuda_graph.generators(self.skeleton)
        was = [g.get_state() for g in gens]
        out = _orig(self, state, inputs)
        for g, s in zip(gens, was):
            g.set_state(s)
        return out
    monkeypatch.setattr(cuda_graph._Block, 'replay', replay)


FAULTS = {'unchanged_step': _unchanged_step, 'half_batch': _half_batch,
          'altered_answer': _altered_answer,
          'frozen_sampler': _frozen_sampler,
          'replay_keeps_params': _replay_keeps_params,
          'replay_repeats_draws': _replay_repeats_draws}
CASES = [(name, fault) for name in CELLS for fault in FAULTS]


def _failed(line):
    return [k for k, c in line['checks'].items()
            if c['value'] is None or c['value'] > c['limit']]


@pytest.mark.parametrize('name,fault', CASES)
def test_a_planted_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    _, line = measure(name)
    assert line['correct'] is False
    assert _failed(line)


CARD_FAULTS = ('half_batch', 'altered_answer', 'replay_keeps_params',
               'replay_repeats_draws')
_ONE_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
import pytest
from benchmark import run as run_py
from benchmark.harness import spec
run_py._environment()
tests = spec.load_module(spec.HERE / 'tests' / 'test_bench_drivers.py')
tests.FAULTS[{fault!r}](pytest.MonkeyPatch())
cell = spec.cell({name!r}, tests.BENCH)
line = run_py.measure(cell, {seed}, 0.0, False, started=time.perf_counter())
print(json.dumps(line['checks']))
"""


@pytest.mark.gpu
@pytest.mark.parametrize('fault', CARD_FAULTS)
@pytest.mark.parametrize('name', CELLS)
def test_a_planted_fault_is_caught_on_the_card(name, fault):
    """The faults planted under whole runs of the cell at its own size on
    the card (a window of one epoch), three seeds, each run a process of
    its own as the benchmark's are; the readings are printed.  The two
    replay faults are ones that only a captured graph's replay carries."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    for seed in (2 ** 31 + 401, 2 ** 31 + 502, 2 ** 31 + 603):
        out = subprocess.run(
            [sys.executable, '-c', _ONE_RUN.format(
                root=str(spec.ROOT), fault=fault, name=name, seed=seed)],
            cwd=spec.ROOT, capture_output=True, text=True, check=True)
        checks = json.loads(out.stdout.splitlines()[-1])
        print(json.dumps({'workload': name, 'fault': fault, 'seed': seed,
                          'checks': checks}))
        assert [k for k, c in checks.items()
                if c['value'] is None or c['value'] > c['limit']], checks
