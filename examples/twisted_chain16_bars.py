"""The JAX package's accuracy on the two complex configurations, on the
CPU: the bars of chip_smoke.py phases 16 and 17.

    JAX_PLATFORMS=cpu python examples/twisted_chain16_bars.py [--port]
        [--config NAME ...] [--epochs N] [--seed S ...]

Runs configs/j1j2_chain8_complex_sr.json and configs/twisted_chain16_sr.json
unmodified (their own seeds and epochs) through `train`, then
`evaluate_operator` on the trained params, and prints for each: the mean of
the last 10 training energies, the evaluated energy with its error, the
exact ground energy (ED in the Sz=0 sector, with the twist phases where the
config has a twist) and the relative error of both against it.
chip_smoke.JAX_COMPLEX_REL_ERR holds the evaluated relative errors this
prints.  With --port the same runs go through the PyTorch port on the CPU,
as a rehearsal of those phases.  --seed runs each config once per given
seed in place of its own, to see how far a recipe's accuracy moves with the
random stream.  The last line is a JSON object of the numbers by config
(and seed, where --seed is given).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = ('j1j2_chain8_complex_sr', 'twisted_chain16_sr')


class Record:
    def __init__(self):
        self.energies = []

    def log(self, epoch, metrics):
        self.energies.append(float(metrics['energy']))


def exact_energy(ed, hamiltonian, n_sites):
    """ED ground energy of the Hamiltonian a config builds (its bonds,
    couplings and twist phases)."""
    e0, _ = ed.ground_state(
        n_sites, hamiltonian.bonds, j_x=hamiltonian.j_x, j_z=hamiltonian.j_z,
        couplings=hamiltonian.couplings,
        offdiag_couplings=hamiltonian.offdiag_couplings,
        twist_phases=hamiltonian.twist_phases)
    return e0


def run_jax(config_path, epochs, seed):
    from cgs_vmc_tpu.config import Config
    from cgs_vmc_tpu.evaluate import evaluate_operator
    from cgs_vmc_tpu.models import build_wavefunction
    from cgs_vmc_tpu.train import build_hamiltonian, train
    from cgs_vmc_tpu.utils import ed
    config = Config.load(config_path)
    if epochs:
        config = config.replace(num_epochs=epochs)
    if seed is not None:
        config = config.replace(seed=seed)
    record = Record()
    state = train(config, logger=record)
    hamiltonian = build_hamiltonian(config)
    result = evaluate_operator(build_wavefunction(config), state.params,
                               hamiltonian, config)
    return config, record, result, exact_energy(ed, hamiltonian,
                                                config.num_sites)


def run_port(config_path, epochs, seed):
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    from cgs_vmc_tpu_torch.utils import ed
    config = Config.load(config_path)
    if epochs:
        config = config.replace(num_epochs=epochs)
    if seed is not None:
        config = config.replace(seed=seed)
    record = Record()
    state = train(config, 'cpu', logger=record)
    hamiltonian = build_hamiltonian(config)
    result = evaluate_operator(models.build_wavefunction(config),
                               state.params, hamiltonian, config, 'cpu')
    return config, record, result, exact_energy(ed, hamiltonian,
                                                config.num_sites)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--port', action='store_true')
    parser.add_argument('--config', nargs='+', default=list(CONFIGS))
    parser.add_argument('--epochs', type=int, default=0,
                        help='override num_epochs (0: the config\'s own)')
    parser.add_argument('--seed', type=int, nargs='+', default=[None],
                        help='seeds to run in place of the config\'s own')
    args = parser.parse_args()
    run = run_port if args.port else run_jax
    who = 'port' if args.port else 'JAX'
    results = {}
    for name, seed in ((n, s) for n in args.config for s in args.seed):
        start = time.perf_counter()
        config, record, result, e0 = run(
            os.path.join(REPO, 'configs', f'{name}.json'), args.epochs, seed)
        tail = float(np.mean(record.energies[-10:]))
        key = name if seed is None else f'{name}:seed{seed}'
        results[key] = {
            'epochs': len(record.energies), 'e0': e0, 'train_tail_10': tail,
            'train_rel_err': (tail - e0) / abs(e0),
            'eval': result.mean, 'eval_err': result.error,
            'eval_rel_err': (result.mean - e0) / abs(e0),
            'acceptance': result.acceptance_rate}
        print(f'{who} {name} (seed {config.seed}): {len(record.energies)} '
              f'epochs, E0 {e0:.6f}; last-10 training mean {tail:.6f} '
              f'(rel err {results[key]["train_rel_err"]:.5f}); evaluated '
              f'{result.mean:.6f} +/- {result.error:.6f} (rel err '
              f'{results[key]["eval_rel_err"]:.5f}), acceptance '
              f'{result.acceptance_rate:.4f}; '
              f'{time.perf_counter() - start:.1f} s on the CPU', flush=True)
    print(json.dumps(results))


if __name__ == '__main__':
    main()
