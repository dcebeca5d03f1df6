"""Command-line interface of the port: ``train``, ``distill``, ``eval`` and
``dump``.

    python -m cgs_vmc_tpu_torch.cli train --config configs/chain40_sr.json \\
        --device cuda --checkpoint_dir RUN --override '...'
    python -m cgs_vmc_tpu_torch.cli distill --supervisor_dir RUN \\
        --config configs/chain40_sr.json --checkpoint_dir STUDENT \\
        --optimizer_type LogOverlapSWO --device cuda
    python -m cgs_vmc_tpu_torch.cli eval --checkpoint_dir RUN --device cuda
    python -m cgs_vmc_tpu_torch.cli dump --checkpoint_dir RUN --device cuda
    python -m cgs_vmc_tpu_torch.cli eval --config configs/square66_conv_sr.json \\
        --override num_conv_layers=7,num_conv_filters=48 \\
        --params artifacts/heisenberg_6x6_deep48.msgpack --device cuda

The flags are the JAX CLI's (``--config``, ``--override``,
``--checkpoint_dir`` and the field shortcuts, with the same helpers as
cgs_vmc_tpu/cli.py:19-70, copied here), plus ``--device``, which defaults
to cuda and fails if CUDA is absent.
``train`` defaults to ITSWO and ``distill`` to SWO, as in the JAX CLI.
``eval`` and ``dump`` restore only the params, so they work on any run
directory (ground-state or distilled); with ``--params`` they read a
params-only ``.msgpack`` artifact of the JAX package instead, the
architecture coming from ``--config`` (or the run directory's config.json).
``dump`` and ``train --generate_vectors`` write the full-basis amplitudes
to ``wavefunction_epoch_{n}.txt`` in the run directory.  The JAX CLI's
``--ema``, ``--orthogonal_to``, ``evolve`` and observables other than the
energy are not ported.
"""

from __future__ import annotations

import argparse
import os
import sys

from cgs_vmc_tpu_torch.config import Config


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--checkpoint_dir', default='',
                        help='Run directory for checkpoints/metrics/config.')
    parser.add_argument('--config', default='',
                        help='Path to a config.json to start from.')
    parser.add_argument('--override', default='',
                        help='Comma-separated name=value config overrides '
                             '(lists as [a;b;c]).')
    parser.add_argument('--num_sites', type=int, default=None)
    parser.add_argument('--num_epochs', type=int, default=None)
    parser.add_argument('--wavefunction_type', default=None)
    parser.add_argument('--optimizer_type', default=None,
                        help='Ground-state or supervised optimizer name.')
    parser.add_argument('--heisenberg_jx', type=float, default=None)
    parser.add_argument('--seed', type=int, default=None)


def _build_config(args: argparse.Namespace, default_optimizer: str,
                  base: Config | None = None) -> Config:
    if base is not None:
        config = base
    else:
        config = Config.load(args.config) if args.config else Config()
    updates = {}
    if args.checkpoint_dir:
        updates['checkpoint_dir'] = args.checkpoint_dir
    for field in ('num_sites', 'num_epochs', 'wavefunction_type',
                  'heisenberg_jx', 'seed'):
        value = getattr(args, field)
        if value is not None:
            updates[field] = value
    if args.optimizer_type is not None:
        updates['wavefunction_optimizer_type'] = args.optimizer_type
    config = config.override_from_dict(updates)
    if not config.wavefunction_optimizer_type:
        config = config.replace(
            wavefunction_optimizer_type=default_optimizer)
    if args.override:
        config = config.parse(args.override)
    return config


def _resume_base(args: argparse.Namespace) -> Config | None:
    """--resume without --config: reload the run's persisted config.json
    (the reference likewise reread hparams.pbtxt from the run directory,
    cgs_vmc/run_energy_evaluation.py:45-47)."""
    if not (getattr(args, 'resume', False)
            and not args.config and args.checkpoint_dir):
        return None
    path = os.path.join(args.checkpoint_dir, 'config.json')
    return Config.load(path) if os.path.exists(path) else None


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument('--device', default='cuda',
                        help="Torch device to run on ('cuda', 'cuda:N' or "
                             "'cpu'); there is no fallback to the CPU.")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='cgs_vmc_tpu_torch',
        description='Neural-quantum-state VMC, PyTorch/CUDA port.')
    sub = parser.add_subparsers(dest='command', required=True)

    p_train = sub.add_parser('train', help='Ground-state optimization.')
    _add_common(p_train)
    _add_device(p_train)
    p_train.add_argument('--resume', action='store_true',
                         help='Resume from the latest checkpoint.')
    p_train.add_argument('--generate_vectors', action='store_true',
                         help='Dump full-basis amplitudes after training.')
    p_train.add_argument('--basis_file_path', default='',
                         help='Basis file for --generate_vectors (defaults '
                              'to enumerating the Sz sector).')

    p_distill = sub.add_parser(
        'distill', help='Supervised distillation toward a trained target.')
    _add_common(p_distill)
    _add_device(p_distill)
    p_distill.add_argument('--supervisor_dir', required=True,
                           help='Run directory of the trained supervisor.')
    p_distill.add_argument('--resume', action='store_true',
                           help='Resume from the latest checkpoint.')

    p_eval = sub.add_parser('eval', help='Monte Carlo energy evaluation.')
    _add_common(p_eval)
    _add_device(p_eval)
    p_eval.add_argument(
        '--params', default='',
        help='Evaluate a params-only .msgpack artifact (e.g. '
             'artifacts/heisenberg_6x6_deep48.msgpack) instead of the run '
             "directory's latest checkpoint; --config (or --checkpoint_dir "
             'with a config.json) describes the ansatz.')
    p_eval.add_argument('--observable', default='energy',
                        help="What to measure; the port has 'energy' only.")

    p_dump = sub.add_parser(
        'dump', help='Write full-basis wavefunction amplitudes to a file.')
    _add_common(p_dump)
    _add_device(p_dump)
    p_dump.add_argument('--params', default='',
                        help='Params-only .msgpack artifact to dump.')

    args = parser.parse_args(argv)

    if args.command == 'train':
        from cgs_vmc_tpu_torch.train import train
        config = _build_config(args, default_optimizer='ITSWO',
                               base=_resume_base(args))
        if args.basis_file_path:
            config = config.replace(basis_file_path=args.basis_file_path)
        state = train(config, args.device, resume=args.resume)
        if args.generate_vectors:
            from cgs_vmc_tpu_torch import models
            from cgs_vmc_tpu_torch.evaluate import evaluate_vector
            evaluate_vector(models.build_wavefunction(config), state.params,
                            config, epoch_num=config.num_epochs)
        return 0

    if args.command == 'distill':
        from cgs_vmc_tpu_torch.train import distill
        config = _build_config(args, default_optimizer='SWO',
                               base=_resume_base(args))
        config = config.replace(supervisor_dir=args.supervisor_dir)
        distill(config, args.device, resume=args.resume)
        return 0

    if getattr(args, 'observable', 'energy') != 'energy':
        print(f'Unknown or unported observable {args.observable!r}; the '
              "port evaluates 'energy' only", file=sys.stderr)
        return 1
    import torch

    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator, evaluate_vector
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    from cgs_vmc_tpu_torch.utils import checkpoint as ckpt_lib
    from cgs_vmc_tpu_torch.utils.device import resolve_device

    # Reload the run's persisted config; evaluation needs the wavefunction
    # parameters only, never the optimizer's state.
    run_dir = args.checkpoint_dir
    loaded = Config.load(args.config or os.path.join(run_dir, 'config.json'))
    config = _build_config(
        args, default_optimizer=(loaded.wavefunction_optimizer_type
                                 or 'ITSWO'),
        base=loaded).replace(checkpoint_dir=run_dir)
    device = resolve_device(args.device)
    wf = models.build_wavefunction(config)
    if args.params:
        params = ckpt_lib.restore_params_only(
            args.params, wf.init(torch.Generator(device=device)))
    else:
        latest = ckpt_lib.latest_checkpoint(run_dir)
        if latest is None:
            print(f'No checkpoint found in {run_dir!r}', file=sys.stderr)
            return 1
        params = ckpt_lib.restore_params_from_checkpoint(latest, device)
    if args.command == 'dump':
        psi = evaluate_vector(wf, params, config)
        print(f'Wrote {psi.shape[0]} amplitudes to '
              f'{run_dir}/wavefunction_epoch_0.txt')
        return 0
    result = evaluate_operator(wf, params, build_hamiltonian(config), config,
                               device)
    print(f'Energy: {result.mean} +/- {result.error}')
    print(f'Acceptance rate: {result.acceptance_rate:.4f}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
