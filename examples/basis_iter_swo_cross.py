"""Which input makes BasisIterSWO collapse on some seeds: the initial
parameters or the order the basis is visited in?

    JAX_PLATFORMS=cpu python examples/basis_iter_swo_cross.py [--seed S ...]
    JAX_PLATFORMS=cpu python examples/basis_iter_swo_cross.py --jitter 8 --seed 13
    JAX_PLATFORMS=cpu python examples/basis_iter_swo_cross.py --track --seed 13

Runs chip_smoke.py's 4x4 distillation (DISTILL, DISTILL_EPOCHS) with
BasisIterSWO through the PyTorch port's epoch on the CPU, for each seed and
each of four pairings of the two inputs a seed decides:

  port/port  the port's initial params (torch CPU generator, seed) and the
             port's permutations (torch.randperm, seed + 2);
  jax/port   the JAX package's initial params (its `init_state` key split),
             carried over with utils/interop.py, and the port's permutations;
  port/jax   the port's initial params and the JAX package's permutation
             stream (its `data_key` chain, one `jax.random.permutation` an
             epoch);
  jax/jax    both from the JAX package: the port's epoch on the JAX run's
             inputs, which should land where the JAX package's own run does
             (examples/swo_distill_bars.py --seed ...).

The epoch is the port's in all four, so a column that collapses with one
package's input and not with the other's names the input at fault.  The last
line is a JSON object of the fidelities by pairing, one list entry a seed.

With --jitter K the JAX package's own optimizer runs K + 1 times a seed,
first on its own initial params and then with every initial weight
multiplied by 1 + 1e-6·N(0, 1) (a change of about one float32 rounding),
and the port's epoch runs on the very same params and permutations each
time: how far the fidelity of one seed moves under a perturbation no
larger than the rounding differences between two implementations of the
same epoch, in either implementation.

With --track the two packages' epochs run side by side from the JAX
package's inputs, and the relative distance between their parameters is
printed epoch by epoch: whether they start apart (a fault) or start equal
to rounding and drift apart exponentially (a chaotic fit).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import jax
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import DISTILL, DISTILL_EPOCHS  # noqa: E402
from cgs_vmc_tpu.config import Config as JaxConfig  # noqa: E402
from cgs_vmc_tpu.evaluate import (  # noqa: E402
    evaluate_vector as jax_evaluate_vector)
from cgs_vmc_tpu.models import FullVector as JaxFullVector  # noqa: E402
from cgs_vmc_tpu.models import build_wavefunction as jax_build  # noqa: E402
from cgs_vmc_tpu.optim import SUPERVISED_OPTIMIZERS  # noqa: E402
from cgs_vmc_tpu_torch import basis, lattice, models  # noqa: E402
from cgs_vmc_tpu_torch.config import Config  # noqa: E402
from cgs_vmc_tpu_torch.evaluate import (  # noqa: E402
    evaluate_vector, overlap_with_vector)
from cgs_vmc_tpu_torch.models.full_vector import FullVector  # noqa: E402
from cgs_vmc_tpu_torch.optim.swo import BasisIterationSWO  # noqa: E402
from cgs_vmc_tpu_torch.utils import ed, interop  # noqa: E402

PAIRINGS = ('port/port', 'jax/port', 'port/jax', 'jax/jax')


def jax_inputs(seed: int, config, dim: int):
    """(initial params as numpy, a function giving epoch e's index stream)
    as the JAX package's BasisIterationSWO.init_state / epoch derive them
    from the seed."""
    k1, _, data_key = jax.random.split(jax.random.key(seed), 3)
    jax_config = JaxConfig(**dict(DISTILL, seed=seed),
                           wavefunction_optimizer_type='BasisIterSWO')
    params = jax.device_get(jax_build(jax_config).init(k1))
    n_rows = config.num_batches_per_epoch * config.batch_size
    streams = []
    for _ in range(config.num_epochs):
        data_key, perm_key = jax.random.split(data_key)
        perm = np.asarray(jax.random.permutation(perm_key, dim))
        streams.append(torch.tensor(perm[np.arange(n_rows) % dim]))
    return params, streams


def fidelity(pairing: str, seed: int, vector, states,
             jax_params=None) -> float:
    """The port's BasisIterSWO run of `seed` with the inputs `pairing`
    names; `jax_params` replaces the JAX package's initial params."""
    init_from, perm_from = pairing.split('/')
    config = Config(**dict(DISTILL, seed=seed),
                    wavefunction_optimizer_type='BasisIterSWO',
                    num_epochs=DISTILL_EPOCHS)
    wf = models.build_wavefunction(config)
    opt = BasisIterationSWO(wf, FullVector.for_sector(16, vector), config,
                            basis_array=states)
    state = opt.init_state(seed, 'cpu', {'ed_vector': torch.tensor(vector)})
    own_params, jax_streams = jax_inputs(seed, config, len(states))
    if init_from == 'jax':
        params = interop.params_from_numpy(
            own_params if jax_params is None else jax_params, 'cpu')
        state = state._replace(params=params, opt_state=opt.sgd.init(params))
    if perm_from == 'jax':
        streams = iter(jax_streams)
        opt._epoch_indices = lambda generator: next(streams)
    for _ in range(config.num_epochs):
        state, _ = opt.epoch(state)
    psi = evaluate_vector(wf, state.params, config, basis_array=states)
    return overlap_with_vector(psi, vector)


def jittered_jax_fidelities(seed: int, repeats: int, vector, states):
    """[(JAX fidelity, port fidelity), ...]: the JAX package's own
    BasisIterSWO run of `seed`, then `repeats` more with its initial params
    perturbed by a relative 1e-6, each beside the port's epoch on the same
    params and permutations."""
    config, wf, opt, epoch, initial = _jax_run(seed, vector)
    rng = np.random.default_rng(seed)
    found = []
    for repeat in range(repeats + 1):
        state = initial
        if repeat:
            params = jax.tree.map(
                lambda x: x * (1.0 + 1e-6 * rng.standard_normal(x.shape)
                               ).astype(np.float32), state.params)
            state = state._replace(params=params,
                                   opt_state=opt.optax_opt.init(params))
        start = state.params
        for _ in range(DISTILL_EPOCHS):
            state, _ = epoch(state)
        psi = jax_evaluate_vector(wf, state.params, config,
                                  basis_array=states)
        found.append((overlap_with_vector(psi, vector),
                      fidelity('jax/jax', seed, vector, states,
                               jax_params=jax.device_get(start))))
        print(f'BasisIterSWO seed {seed} '
              f'{"jittered 1e-6" if repeat else "as it is"}: fidelity '
              f'JAX {found[-1][0]:.6f}, the port\'s epoch on the same '
              f'inputs {found[-1][1]:.6f}', flush=True)
    return found


def _jax_run(seed: int, vector):
    """(config, wf, optimizer, jitted epoch, initial state) of the JAX
    package's own BasisIterSWO run of `seed`."""
    config = JaxConfig(**dict(DISTILL, seed=seed),
                       wavefunction_optimizer_type='BasisIterSWO',
                       use_fast_sampler=False)
    target = JaxFullVector.for_sector(16, vector)
    wf = jax_build(config)
    opt = SUPERVISED_OPTIMIZERS['BasisIterSWO'](wf, target, config)
    state = opt.init_state(jax.random.key(seed),
                           target.init(jax.random.key(0)), config.batch_size)
    return config, wf, opt, jax.jit(opt.epoch), state


def track_divergence(seed: int, vector, states):
    """Prints, epoch by epoch, how far the port's parameters are from the
    JAX package's when both start from the JAX package's inputs."""
    _, _, _, jax_epoch, jax_state = _jax_run(seed, vector)
    config = Config(**dict(DISTILL, seed=seed),
                    wavefunction_optimizer_type='BasisIterSWO',
                    num_epochs=DISTILL_EPOCHS)
    opt = BasisIterationSWO(models.build_wavefunction(config),
                            FullVector.for_sector(16, vector), config,
                            basis_array=states)
    state = opt.init_state(seed, 'cpu', {'ed_vector': torch.tensor(vector)})
    jax_params, jax_streams = jax_inputs(seed, config, len(states))
    params = interop.params_from_numpy(jax_params, 'cpu')
    state = state._replace(params=params, opt_state=opt.sgd.init(params))
    streams = iter(jax_streams)
    opt._epoch_indices = lambda generator: next(streams)
    for epoch in range(1, DISTILL_EPOCHS + 1):
        jax_state, jax_metrics = jax_epoch(jax_state)
        state, metrics = opt.epoch(state)
        theirs = jax.tree.leaves(jax.device_get(jax_state.params))
        ours = jax.tree.leaves(interop.params_to_numpy(state.params))
        gap = np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(theirs, ours))
                      / sum((a ** 2).sum() for a in theirs))
        if epoch <= 5 or epoch % 5 == 0:
            print(f'BasisIterSWO seed {seed} epoch {epoch}: |port - JAX| / '
                  f'|JAX| over the params {gap:.3e}; loss JAX '
                  f'{float(jax_metrics["loss"]):.6f}, port '
                  f'{float(metrics["loss"]):.6f}', flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--seed', type=int, nargs='+',
                        default=list(range(1, 16)))
    parser.add_argument('--jitter', type=int, default=0)
    parser.add_argument('--track', action='store_true')
    args = parser.parse_args()
    _, v0 = ed.ground_state(16, lattice.square_lattice_bonds(4, 4), j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    states = basis.enumerate_sz_basis(16)
    if args.track:
        for seed in args.seed:
            track_divergence(seed, vector, states)
        return
    if args.jitter:
        print(json.dumps({'seeds': args.seed, 'jax_jittered': [
            jittered_jax_fidelities(seed, args.jitter, vector, states)
            for seed in args.seed]}))
        return
    results = {pairing: [] for pairing in PAIRINGS}
    for seed in args.seed:
        for pairing in PAIRINGS:
            start = time.perf_counter()
            results[pairing].append(fidelity(pairing, seed, vector, states))
            print(f'BasisIterSWO seed {seed} init/permutations {pairing}: '
                  f'fidelity {results[pairing][-1]:.6f} after '
                  f'{DISTILL_EPOCHS} epochs '
                  f'({time.perf_counter() - start:.1f} s on the CPU)',
                  flush=True)
    print(json.dumps({'seeds': args.seed, **results}))


if __name__ == '__main__':
    main()
