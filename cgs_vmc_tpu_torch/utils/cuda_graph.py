"""Blocks of training epochs replayed as captured CUDA graphs: the port's
counterpart of the JAX package's compiled epoch (cgs_vmc_tpu/train.py,
``jax.jit(single, donate_argnums=(0,))`` over one epoch or, with
``epochs_per_call`` = k, over ``_scan_epochs``'s k epochs).  Like
utils/device.py it has no JAX module of its own.

An epoch of the port reads nothing back to the host: metrics are device
scalars, the epoch counter, the learning rate and adam's count live on the
device (optim/common.py), and every draw goes through a CUDA
``torch.Generator``.  So k epochs can be captured once and replayed:

 * the TrainState is flattened (utils/tree.py) into a fixed list of
   tensors (params, optimizer state, every sampler tensor, ``extra``) and a
   skeleton that holds everything else (the structure, the generators, any
   Python value);
 * the captured body rebuilds the state from static buffers, runs k
   epochs, and copies the new state into the same buffers, so each replay
   carries the state to the next; the k epochs' metrics are stacked into
   static outputs, read (cloned) after each replay;
 * every CUDA generator of the state is registered with the graph
   (``CUDAGraph.register_generator_state``), so each replay draws new
   numbers and leaves the generator where the eager epochs would;
 * the counters of utils/profiling.py (the kernels' launches, the
   connected boards evaluated) grow once, at capture, by what the body
   counted; that is taken back, and added again at every replay; with
   spans on, the capture's timing events are graph nodes, and every
   replay reads them as that replay's phases;
 * a host-side input an epoch needs (BasisIterSWO's permutation of the
   basis, drawn from a CPU generator) is drawn before each replay by the
   optimizer's ``host_inputs`` and copied into a static buffer.

A skeleton that differs after the body, or a CPU generator that the body
advanced, is a value the graph would freeze: capture raises.  Nothing
catches a capture error and nothing falls back: a failure ends the run.

`EpochRunner` runs a loop's blocks.  On the CPU, and on a card under a
``torch.distributed`` group or for a configuration of `EAGER_PATHS`, it
runs them eagerly, epoch by epoch, as the port always did.  On a card it
runs the run's first block eagerly (that warm-up is part of the run: it
builds the kernels, makes the cuBLAS / cuSOLVER handles and workspaces and
copies the lazily made per-device tables, all on the stream the capture
uses), captures each block length at its first use after that, and
replays.  ``replay='plain'`` runs the same static-buffer body by a direct
call in place of a replay, on any device: the plain version of a replay,
which the CPU tests hold to the eager loop bit for bit.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from cgs_vmc_tpu_torch.utils import cuda_build, profiling
from cgs_vmc_tpu_torch.utils.profiling import span
from cgs_vmc_tpu_torch.utils.tree import (
    flatten, generators, same_skeleton, unflatten)

# Configurations that run eagerly on a card in this version: (ansatz
# types, optimizer types) -> why.  A run whose wavefunction_type, or a part
# of its composite, is one of the first and whose optimizer is one of the
# second stays eager and says so at the start (ROADMAP.md item 20 queues
# each entry).  Every other optimizer, sampler and ansatz of `train` and
# `distill` captures.
EAGER_PATHS: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]], str] = {
    (('pbdg', 'fully_connected_nnb'), ('SR', 'ExcitedSR')): (
        "SR's torch.func rows (vmap(grad), vjp) through "
        'torch.linalg.slogdet read back to the host in their backward, '
        'which a CUDA graph capture refuses (plain autograd, as every '
        'other optimizer takes, captures)'),
}


def eager_reason(config, group) -> Optional[str]:
    """Why a run on a card stays eager (None: it replays graphs)."""
    if group is not None:
        return ('a torch.distributed group: NCCL collectives are not '
                'captured in this version')
    types = {config.wavefunction_type,
             *(getattr(config, 'composite_wavefunction_types', ()) or ())}
    optimizer = config.wavefunction_optimizer_type or 'ITSWO'
    for (ansatzes, optimizers), why in EAGER_PATHS.items():
        if types & set(ansatzes) and optimizer in optimizers:
            return (f'{sorted(types & set(ansatzes))} under {optimizer}: '
                    f'{why}')
    return None


# scan(k) -> fn(state, inputs=()) -> (state, [metrics of each epoch]): k
# epochs as one call (train.py's _scan_epochs), epoch j taking inputs[j]
# when the optimizer has host inputs.
ScanFn = Callable[[int], Callable[..., Tuple[Any, List[Dict]]]]


class _Block:
    """k epochs over static buffers: the body that is captured and then
    replayed (``graph`` None: the body runs by a direct call each time)."""

    def __init__(self, scan: ScanFn, k: int, state,
                 inputs: List[torch.Tensor], device: torch.device):
        self.fn = scan(k)
        self.k = k
        self.skeleton, leaves = flatten(state)
        with torch.no_grad():
            self.buffers = [leaf.detach().clone() for leaf in leaves]
            self.inputs = [x.to(device, copy=True) for x in inputs]
        self.metrics: Dict[str, torch.Tensor] = {}
        self.graph = None
        self.nodes = 0
        self.capture_s = 0.0
        self.captured = profiling.Captured()

    def _body(self) -> None:
        state, records = self.fn(unflatten(self.skeleton, self.buffers),
                                 self.inputs)
        skeleton, leaves = flatten(state)
        if not same_skeleton(skeleton, self.skeleton):
            raise RuntimeError(
                'an epoch changed a non-tensor part of the train state, '
                'which a CUDA graph would freeze at its captured value:\n'
                f'before {self.skeleton}\nafter  {skeleton}')
        with torch.no_grad():
            for buffer, leaf in zip(self.buffers, leaves):
                buffer.copy_(leaf)
        self.metrics = {name: torch.stack([r[name] for r in records])
                        for name in records[0]}

    def capture(self, stream: torch.cuda.Stream, pool) -> None:
        """Captures the body on `stream` into a CUDA graph (runs no work)."""
        start = time.perf_counter()
        with span('graph.capture'):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            for generator in generators(self.skeleton):
                if generator.device.type == 'cuda':
                    graph.register_generator_state(generator)
            host = [(g, g.get_state()) for g in generators(self.skeleton)
                    if g.device.type == 'cpu']
            with profiling.capturing() as self.captured:
                with torch.cuda.graph(graph, pool=pool, stream=stream):
                    self._body()
            graph.instantiate()
        for generator, was in host:
            if not torch.equal(generator.get_state(), was):
                raise RuntimeError(
                    'the captured epoch drew from a CPU generator; a graph '
                    'would replay that draw forever (draw it in the '
                    "optimizer's host_inputs)")
        self.graph = graph
        self.nodes = cuda_build.graph_nodes(graph)
        self.capture_s = time.perf_counter() - start

    def replay(self, state, inputs: List[torch.Tensor]):
        """(state after the k epochs, their metrics): `state` copied into
        the buffers (unless it is them), then one replay."""
        with span('graph.replay'):
            skeleton, leaves = flatten(state)
            if not same_skeleton(skeleton, self.skeleton):
                raise RuntimeError('the train state changed its structure '
                                   'between two blocks')
            with torch.no_grad():
                for buffer, leaf in zip(self.buffers, leaves):
                    if leaf is not buffer:
                        buffer.copy_(leaf)
                for buffer, x in zip(self.inputs, inputs):
                    buffer.copy_(x)
            if self.graph is None:
                self._body()
            else:
                with span('graph.launch'):
                    self.graph.replay()
                profiling.add_counts(self.captured.counts)
                profiling.replayed(self.captured.spans)
            stacked = {name: value.clone()
                       for name, value in self.metrics.items()}
            return (unflatten(self.skeleton, self.buffers),
                    [{name: value[j] for name, value in stacked.items()}
                     for j in range(self.k)])


class EpochRunner:
    """Runs a training loop's blocks of epochs (see the module docstring).

    scan: train.py's ``_scan_epochs`` bound to the epoch function;
    host_inputs(state): the optimizer's host-drawn inputs of one epoch, or
    None.  replay: 'eager' (epoch by epoch), 'graph' (a card only) or
    'plain' (the static-buffer body by direct calls)."""

    def __init__(self, scan: ScanFn, device: torch.device,
                 replay: str = 'eager',
                 host_inputs: Optional[Callable] = None):
        if replay not in ('eager', 'graph', 'plain'):
            raise ValueError(f'unknown replay mode {replay!r}')
        if replay == 'graph' and device.type != 'cuda':
            raise ValueError(f'CUDA graphs need a card, not {device}')
        self.scan = scan
        self.device = device
        self.replay = replay
        self.host_inputs = host_inputs
        self.blocks: Dict[int, _Block] = {}
        self._warm = False
        self._stream = (torch.cuda.Stream(device) if replay == 'graph'
                        else None)

    def run(self, state, step: int):
        """(state after `step` epochs, their metrics, one dict an epoch)."""
        if self.replay == 'eager':
            return self.scan(step)(state)
        if not self._warm:
            # The warm-up block, eager, on the stream the captures use.
            self._warm = True
            if self._stream is None:
                return self.scan(step)(state)
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = self.scan(step)(state)
            current.wait_stream(self._stream)
            return out
        inputs = ([self.host_inputs(state) for _ in range(step)]
                  if self.host_inputs else [])
        block = self.blocks.get(step)
        if block is None:
            block = self.blocks[step] = _Block(self.scan, step, state,
                                               inputs, self.device)
            if self.replay == 'graph':
                pool = next((b.graph.pool() for b in self.blocks.values()
                             if b.graph is not None), None)
                block.capture(self._stream, pool)
        return block.replay(state, inputs)
