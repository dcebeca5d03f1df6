"""Spinon dispersion demo on the PyTorch port: S(q, omega) of the N=20
Heisenberg chain (the port's counterpart of examples/dynamics_chain20.py).

Trains a complex(rbm x fc 64) ground state with dense SR, then runs the
antithetic linear-response protocol (cgs_vmc_tpu_torch/ops/dynamics.py) at
q = 2, 3, 5 x 2pi/N and reports each S(q, omega) peak beside the JAX
package's (artifacts/dynamics_chain20.json) and the des Cloizeaux-Pearson
lower edge omega_dCP(q) = (pi/2)|sin q|.  The configuration, the protocol
(eps 0.05, dt 0.05, 240 Heun steps, eta 0.2) and the omega grid are the JAX
script's.

Usage:  python examples/dynamics_chain20_port.py [N=20] [EPOCHS=600]
            [--device cuda|cpu] [--out PATH]
Writes: PATH (default build/dynamics_chain{N}_port.json): per-q correlators,
spectra and peaks, with the card's name and power limit and the seconds.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cgs_vmc_tpu_torch import lattice  # noqa: E402
from cgs_vmc_tpu_torch import models  # noqa: E402
from cgs_vmc_tpu_torch.config import Config  # noqa: E402
from cgs_vmc_tpu_torch.ops import dynamics  # noqa: E402
from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian  # noqa
from cgs_vmc_tpu_torch.ops.observables import chain_positions  # noqa: E402
from cgs_vmc_tpu_torch.optim import GROUND_STATE_OPTIMIZERS  # noqa: E402

MOMENTA = (2, 3, 5)


def card_name() -> str:
    if not torch.cuda.is_available():
        return 'cpu'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('n_sites', nargs='?', type=int, default=20)
    parser.add_argument('epochs', nargs='?', type=int, default=600)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--steps', type=int, default=240)
    parser.add_argument('--batch_size', type=int, default=512)
    parser.add_argument('--out', default='')
    args = parser.parse_args()
    n, epochs = args.n_sites, args.epochs
    device = torch.device(args.device)
    card = card_name()

    cfg = Config(num_sites=n, wavefunction_type='complex',
                 composite_wavefunction_types=('rbm', 'fully_connected'),
                 num_fc_layers=1, fc_layer_size=64,
                 wavefunction_optimizer_type='SR',
                 batch_size=args.batch_size, num_batches_per_epoch=2,
                 num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                 optimizer='gradient', learning_rates=[0.05, 0.02, 0.01],
                 learning_rate_stops=[epochs // 3, 2 * epochs // 3],
                 sr_solver='dense', sr_diag_shift=1e-3, sr_delta_clip=10.0,
                 heisenberg_jx=-1.0, seed=7)
    wf = models.build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(n), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(cfg.seed, device)

    t0 = time.time()
    print(f'training complex rbm x fc ground state, N={n} [{card}]',
          flush=True)
    energy = float('nan')
    for i in range(epochs):
        state, metrics = opt.epoch(state)
        if i % 50 == 49 or i == epochs - 1:
            energy = float(metrics['energy'])
            print(f'epoch {i + 1}: E={energy:.4f} t={time.time() - t0:.0f}s',
                  flush=True)
    train_s = time.time() - t0
    params = state.params

    reference = {}
    ref_path = os.path.join(REPO, 'artifacts', f'dynamics_chain{n}.json')
    if os.path.exists(ref_path):
        with open(ref_path) as f:
            reference = {m: r['peak']
                         for m, r in json.load(f)['results'].items()}

    positions = chain_positions(n)
    dt, eps, eta = 0.05, 0.05, 0.2
    omegas = np.linspace(0.05, 4.0, 400)
    results = {}
    for m in MOMENTA:
        start = time.time()
        q = 2.0 * np.pi * m / n
        probe = dynamics.FourierSz([q], positions)
        times, corr, _ = dynamics.sampled_linear_response(
            wf, params, ham, probe, cfg, eps, dt, args.steps, device)
        spec = dynamics.spectral_function(times, corr, omegas, eta)
        peak = float(omegas[int(np.argmax(spec))])
        dcp = 0.5 * np.pi * abs(np.sin(q))
        seconds = time.time() - start
        print(f'q = {m}*2pi/{n}: S(q,w) peak at {peak:.3f} (JAX package '
              f'{reference.get(str(m), float("nan")):.3f}, dCP lower edge '
              f'{dcp:.3f}); {args.steps} steps in {seconds:.1f} s [{card}]',
              flush=True)
        results[str(m)] = {'q': q, 'times': times.tolist(),
                           'correlator': corr.tolist(),
                           'spectrum': spec.tolist(), 'peak': peak,
                           'dcp_edge': dcp, 'seconds': seconds}

    out = args.out or os.path.join(REPO, 'build',
                                   f'dynamics_chain{n}_port.json')
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, 'w') as f:
        json.dump({'card': card, 'epochs': epochs, 'final_energy': energy,
                   'train_seconds': train_s, 'omegas': omegas.tolist(),
                   'eta': eta, 'eps': eps, 'results': results}, f)
    print(f'wrote {out}; training {train_s:.1f} s, all '
          f'{time.time() - t0:.1f} s [{card}]', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
