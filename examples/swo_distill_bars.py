"""The JAX package's fidelity bars for chip_smoke.py phase 14, on the CPU.

    JAX_PLATFORMS=cpu python examples/swo_distill_bars.py [--port] [--seed S ...]

Distills the 4x4 Heisenberg ground state (ED, |V0| of the Marshall-gauged
model, 12,870 states) into an RBM with each of the four supervised
optimizers, with chip_smoke.DISTILL's config, DISTILL_EPOCHS epochs and
seed, and prints each fidelity |<psi|V0>|.  The JAX package runs its generic
sampler (use_fast_sampler=False), which samples the same distribution as
the RBM kernels; chip_smoke.JAX_FIDELITY holds what this prints.  With
--port the same runs go through the PyTorch port's `distill` on the CPU
(the RBM kernels' plain versions), as a rehearsal of phase 14.  --seed
runs the config with each seed given in place of its own, to see how far
the fidelity moves with the seed; the last line is a JSON object of the
fidelities by optimizer, one list entry a seed.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import DISTILL, DISTILL_EPOCHS  # noqa: E402


def jax_fidelity(name, seed, vector, states):
    import jax
    from cgs_vmc_tpu.config import Config
    from cgs_vmc_tpu.evaluate import evaluate_vector, overlap_with_vector
    from cgs_vmc_tpu.models import FullVector, build_wavefunction
    from cgs_vmc_tpu.optim import SUPERVISED_OPTIMIZERS
    config = Config(**dict(DISTILL, seed=seed),
                    wavefunction_optimizer_type=name, use_fast_sampler=False)
    target = FullVector.for_sector(16, vector)
    wf = build_wavefunction(config)
    opt = SUPERVISED_OPTIMIZERS[name](wf, target, config)
    state = opt.init_state(jax.random.key(config.seed),
                           target.init(jax.random.key(0)), config.batch_size)
    epoch = jax.jit(opt.epoch)
    for _ in range(DISTILL_EPOCHS):
        state, _ = epoch(state)
    psi = evaluate_vector(wf, state.params, config, basis_array=states)
    return overlap_with_vector(psi, vector)


def port_fidelity(name, seed, vector, states):
    import torch
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import (evaluate_vector,
                                            overlap_with_vector)
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.train import distill

    class Quiet:
        def log(self, epoch, metrics):
            pass

    config = Config(**dict(DISTILL, seed=seed),
                    wavefunction_optimizer_type=name,
                    num_epochs=DISTILL_EPOCHS)
    state = distill(config, 'cpu',
                    target_params={'ed_vector': torch.tensor(vector)},
                    target_wf=FullVector.for_sector(16, vector),
                    logger=Quiet())
    psi = evaluate_vector(models.build_wavefunction(config), state.params,
                          config, basis_array=states)
    return overlap_with_vector(psi, vector)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--port', action='store_true')
    parser.add_argument('--seed', type=int, nargs='+',
                        default=[DISTILL['seed']])
    args = parser.parse_args()
    port = args.port
    if port:
        from cgs_vmc_tpu_torch import basis, lattice
        from cgs_vmc_tpu_torch.utils import ed
    else:
        from cgs_vmc_tpu import basis, lattice
        from cgs_vmc_tpu.utils import ed
    _, v0 = ed.ground_state(16, lattice.square_lattice_bonds(4, 4),
                            j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    states = basis.enumerate_sz_basis(16)
    run = port_fidelity if port else jax_fidelity
    results = {}
    for name in ('BasisIterSWO', 'DualSamplingSWO', 'LogOverlapSWO', 'SWO'):
        results[name] = []
        for seed in args.seed:
            start = time.perf_counter()
            results[name].append(run(name, seed, vector, states))
            print(f'{"port" if port else "JAX"} {name} seed {seed}: '
                  f'fidelity {results[name][-1]:.6f} after {DISTILL_EPOCHS} '
                  f'epochs ({time.perf_counter() - start:.1f} s on the CPU)',
                  flush=True)
    print(json.dumps(results))


if __name__ == '__main__':
    main()
