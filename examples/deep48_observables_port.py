"""The Lanczos step and S(pi, pi) of the 6x6 deep48 artifact through the
PyTorch port's CLI, timed, beside the JAX package's records.

    python examples/deep48_observables_port.py [--device cuda|cpu]
        [--lanczos_chains 64] [--lanczos_samples 60] [--sq_chains 1024]
        [--sq_samples 100] [--equilibration 50]

Runs `cli eval --observable lanczos` (energy shift 'auto'; the moments of
every chain at once, the inner local energies `energy_chunk_samples` = 128
boards a forward) and `cli eval --observable 'sq:1;1'` on
artifacts/heisenberg_6x6_deep48.msgpack (configs/square66_conv_sr.json at
7 x 48), each from `--equilibration` sweeps of fresh chains, and prints
each result with its seconds and the card's name and power limit.
Records: E/N -0.678824 +/- 0.000006 (RESULTS.md row 4e), QMC -0.678872;
S(pi,pi) 2.5069 +/- 0.0079 at L=6 (artifacts/staggered_flagship.json).
"""
import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cgs_vmc_tpu_torch import cli  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--lanczos_chains', type=int, default=64)
    parser.add_argument('--lanczos_samples', type=int, default=60)
    parser.add_argument('--sq_chains', type=int, default=1024)
    parser.add_argument('--sq_samples', type=int, default=100)
    parser.add_argument('--equilibration', type=int, default=50)
    args = parser.parse_args()
    card = (subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True).stdout.strip()
            if args.device != 'cpu' else 'cpu')
    base = ['eval', '--config',
            os.path.join(REPO, 'configs', 'square66_conv_sr.json'),
            '--params', os.path.join(REPO, 'artifacts',
                                     'heisenberg_6x6_deep48.msgpack'),
            '--device', args.device]
    runs = (('lanczos', args.lanczos_chains, args.lanczos_samples),
            ('sq:1;1', args.sq_chains, args.sq_samples))
    for observable, chains, samples in runs:
        override = (f'num_conv_layers=7,num_conv_filters=48,'
                    f'batch_size={chains},num_evaluation_samples={samples},'
                    f'num_equilibration_sweeps={args.equilibration}')
        print(f'== eval --observable {observable!r}: {chains} chains x '
              f'{samples} samples, {args.equilibration} equilibration '
              f'sweeps [{card}]', flush=True)
        start = time.perf_counter()
        rc = cli.main(base + ['--observable', observable,
                              '--override', override])
        print(f'== {observable}: rc {rc}, '
              f'{time.perf_counter() - start:.1f} s [{card}]', flush=True)
        if rc:
            return rc
    return 0


if __name__ == '__main__':
    sys.exit(main())
