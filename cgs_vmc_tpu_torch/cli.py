"""Command-line interface of the port: ``train``, ``distill``, ``eval``,
``dump`` and ``evolve``.

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
    python -m cgs_vmc_tpu_torch.cli eval --checkpoint_dir RUN \\
        --observable 'transverse:1' --device cuda   # or szsz:, sq:, lanczos
    python -m cgs_vmc_tpu_torch.cli evolve --checkpoint_dir RUN --mode imag \\
        --dt 0.01 --steps 20 --device cuda          # or --linear_response 1
    python -m cgs_vmc_tpu_torch.cli train --config configs/chain40_sr.json \\
        --optimizer_type ExcitedSR --orthogonal_to RUN --checkpoint_dir EXC

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
to ``wavefunction_epoch_{n}.txt`` in the run directory.  ``eval
--observable`` takes every form of the JAX CLI (szsz:, transverse:, sq:,
staggered_m2, total_spin2, renyi2:, lanczos), with the same messages and
return codes; ``evolve`` writes ``evolution.jsonl`` or, with
``--linear_response``, ``linear_response.jsonl`` with the JAX CLI's keys;
``train --orthogonal_to`` names the frozen lower states of the
ExcitedPenalty and ExcitedSR optimizers.  ``eval --ema`` evaluates the
EMA weights of a run that trained with ``param_ema_decay`` > 0.  A run
directory may be the JAX package's: its ``ckpt_epoch_*.msgpack`` params
serve ``eval``, ``dump`` and ``distill --supervisor_dir``.

Multi-GPU: one process a GPU under ``torchrun``, which sets WORLD_SIZE;
the CLI then joins the process group (NCCL for ``--device cuda``, which
means ``cuda:LOCAL_RANK``; gloo for ``--device cpu``), only rank 0 prints,
and ``num_devices`` must equal the number of processes:

    torchrun --nproc_per_node=8 -m cgs_vmc_tpu_torch.cli train \
        --config CONFIG --override num_devices=8 --checkpoint_dir RUN
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
    p_train.add_argument('--orthogonal_to', action='append', default=[],
                         help='Frozen lower state (run dir or .msgpack '
                              'params artifact) for the ExcitedPenalty and '
                              'ExcitedSR optimizers; repeatable.')

    p_distill = sub.add_parser(
        'distill', help='Supervised distillation toward a trained target.')
    _add_common(p_distill)
    _add_device(p_distill)
    p_distill.add_argument('--supervisor_dir', required=True,
                           help='Run directory of the trained supervisor.')
    p_distill.add_argument('--resume', action='store_true',
                           help='Resume from the latest checkpoint.')

    p_eval = sub.add_parser('eval', help='Monte Carlo observable evaluation.')
    _add_common(p_eval)
    _add_device(p_eval)
    p_eval.add_argument(
        '--params', default='',
        help='Evaluate a params-only .msgpack artifact (e.g. '
             'artifacts/heisenberg_6x6_deep48.msgpack) instead of the run '
             "directory's latest checkpoint; --config (or --checkpoint_dir "
             'with a config.json) describes the ansatz.')
    p_eval.add_argument(
        '--ema', action='store_true',
        help='Evaluate the Polyak/EMA-averaged weights '
             "(TrainState.extra['ema_params']) instead of the raw params; "
             'requires the run to have trained with param_ema_decay > 0.')
    p_eval.add_argument(
        '--observable', default='energy',
        help="What to measure: 'energy' (default), 'szsz:<dx>[;<dy>]' "
             '(longitudinal spin-spin correlation at lattice displacement '
             '(dx,dy); dy required iff BOTH size_x > 1 and size_y > 1 — '
             'a 1xN geometry is treated as a chain), '
             "'transverse:<dx>[;<dy>]' (SxSx+SySy, off-diagonal), "
             "'staggered_m2' (squared staggered magnetization), "
             "'total_spin2' (SU(2) Casimir <S_tot^2>; 0 for a singlet — "
             'Marshall-gauge-corrected automatically when the run '
             'trained with jx < 0), '
             "'sq:<qx>[;<qy>]' (longitudinal structure factor S(q), "
             'momentum in units of pi; qy required iff the lattice is '
             '2-D), '
             "'renyi2:<i>-<j>' (Renyi-2 entanglement entropy of sites "
             'i..j by the two-replica swap estimator), or '
             "'lanczos' (single Lanczos-step energy E(alpha*) of "
             '(1+aH)|psi> plus the zero-variance extrapolation, '
             'ops/lanczos.py).')

    p_dump = sub.add_parser(
        'dump', help='Write full-basis wavefunction amplitudes to a file.')
    _add_common(p_dump)
    _add_device(p_dump)
    p_dump.add_argument('--params', default='',
                        help='Params-only .msgpack artifact to dump.')

    p_evolve = sub.add_parser(
        'evolve', help='t-VMC time evolution from a trained checkpoint.')
    _add_common(p_evolve)
    _add_device(p_evolve)
    p_evolve.add_argument('--params', default='',
                          help='Params-only .msgpack artifact to evolve.')
    p_evolve.add_argument('--dt', type=float, default=0.005,
                          help='Integrator time step.')
    p_evolve.add_argument('--steps', type=int, default=100,
                          help='Number of dt steps.')
    p_evolve.add_argument('--mode', choices=('real', 'imag'), default='real',
                          help="'real' = unitary dynamics (complex ansatz); "
                               "'imag' = normalized imaginary-time flow.")
    p_evolve.add_argument('--integrator', choices=('euler', 'heun'),
                          default='heun')
    p_evolve.add_argument(
        '--linear_response', default='',
        help='Momentum (units of pi) of a FourierSz probe, e.g. "1" on a '
             'chain or "1;1" on a 2-D lattice: runs the antithetic '
             'linear-response protocol (quench e^{±eps O_q}, evolve, '
             'C(t) = symmetric difference / 4 eps) instead of a plain '
             'evolution, and writes (t, C(t)) plus the spectral function '
             'S(q, omega) to linear_response.jsonl (ops/dynamics.py).')
    p_evolve.add_argument('--eps', type=float, default=0.05,
                          help='Quench strength for --linear_response.')

    args = parser.parse_args(argv)
    joined = _join_process_group(args)
    try:
        if not joined:
            return _run(args)
        import contextlib
        import torch.distributed as dist
        if dist.get_rank() == 0:
            return _run(args)
        # Only rank 0 prints.
        with open(os.devnull, 'w') as sink, \
                contextlib.redirect_stdout(sink):
            return _run(args)
    finally:
        if joined:
            import torch.distributed as dist
            dist.destroy_process_group()


def _join_process_group(args) -> bool:
    """Under torchrun (WORLD_SIZE set): joins the process group, NCCL for
    a CUDA device (this process's cuda:LOCAL_RANK) and gloo for the CPU.
    Returns whether it did."""
    import torch
    import torch.distributed as dist
    if 'WORLD_SIZE' not in os.environ or dist.is_initialized():
        return False
    from cgs_vmc_tpu_torch.parallel.mesh import initialize_distributed
    device = torch.device(args.device)
    if device.type == 'cuda':
        args.device = f'cuda:{int(os.environ.get("LOCAL_RANK", 0))}'
    initialize_distributed('nccl' if device.type == 'cuda' else 'gloo')
    return True


def _run(args) -> int:
    if args.command == 'train':
        from cgs_vmc_tpu_torch.train import train
        config = _build_config(args, default_optimizer='ITSWO',
                               base=_resume_base(args))
        if args.basis_file_path:
            config = config.replace(basis_file_path=args.basis_file_path)
        if args.orthogonal_to:
            config = config.replace(orthogonal_to=list(args.orthogonal_to))
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

    import torch

    from cgs_vmc_tpu_torch import models
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
    template = wf.init(torch.Generator(device=device))
    ema = getattr(args, 'ema', False)
    if args.params:
        if ema:
            print('--ema cannot be combined with --params: standalone '
                  'artifacts are params-only and carry no EMA slot',
                  file=sys.stderr)
            return 1
        params = ckpt_lib.restore_params_only(args.params, template)
    else:
        latest = ckpt_lib.latest_checkpoint(run_dir)
        if latest is None:
            print(f'No checkpoint found in {run_dir!r}', file=sys.stderr)
            return 1
        restore = (ckpt_lib.restore_ema_from_checkpoint if ema
                   else ckpt_lib.restore_params_from_checkpoint)
        params = restore(latest, device, template)
    hamiltonian = build_hamiltonian(config)
    if args.command == 'dump':
        from cgs_vmc_tpu_torch.evaluate import evaluate_vector
        psi = evaluate_vector(wf, params, config)
        print(f'Wrote {psi.shape[0]} amplitudes to '
              f'{run_dir}/wavefunction_epoch_0.txt')
        return 0
    if args.command == 'evolve':
        if args.linear_response:
            return _linear_response(args, config, wf, params, hamiltonian,
                                    device)
        return _evolve(args, config, wf, params, hamiltonian, device)
    return _evaluate(args.observable, config, wf, params, hamiltonian,
                     device)


def _positions(config):
    """Site coordinates of the config's lattice: 2-D when size_y > 1."""
    from cgs_vmc_tpu_torch.ops.observables import (chain_positions,
                                                   square_positions)
    if config.size_y > 1:
        return square_positions(config.size_x, config.size_y)
    return chain_positions(config.num_sites)


def _evaluate(observable, config, wf, params, hamiltonian, device) -> int:
    """`eval --observable`: measures one observable and prints it."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.ops import observables as obs

    if observable.startswith('renyi2:'):
        from cgs_vmc_tpu_torch.ops.renyi import evaluate_renyi2
        lo, hi = (int(v) for v in observable.split(':', 1)[1].split('-'))
        s2, err = evaluate_renyi2(wf, params, list(range(lo, hi + 1)),
                                  config, device)
        print(f'Renyi-2 S2(sites {lo}..{hi}): {s2} +/- {err}')
        return 0
    if observable == 'lanczos':
        from cgs_vmc_tpu_torch.ops.lanczos import evaluate_lanczos
        res = evaluate_lanczos(wf, params, hamiltonian, config, device,
                               sample_chunk=config.energy_chunk_samples,
                               energy_shift='auto')
        print(f'Energy <H>: {res.e0} +/- {res.e0_err}')
        print(f'Lanczos step alpha* (of 1 + aH): {res.alpha_physical}  '
              f"[shifted-basis a'={res.alpha}, shift={res.shift}]")
        print(f'Lanczos energy E(alpha*): {res.energy} +/- '
              f'{res.energy_err}')
        print(f'Variance: {res.variance0} -> {res.variance_alpha}')
        print(f'Zero-variance extrapolation: {res.extrapolated}')
        print(f'Acceptance rate: {res.acceptance_rate:.4f}')
        return 0
    chunk = config.energy_chunk_samples
    if observable == 'energy':
        operator, label = hamiltonian, 'Energy'
    elif observable.startswith(('szsz:', 'transverse:')):
        kind, spec = observable.split(':', 1)
        parts = [int(v) for v in spec.split(';')]
        # lattice.displacement_pairs' own 2-D condition (a 1xN geometry is
        # a chain there).
        is_2d = (config.size_x > 1 and config.size_y > 1
                 and config.size_x * config.size_y == config.num_sites)
        if is_2d and len(parts) != 2:
            print(f'{kind}: a {config.size_x}x{config.size_y} lattice needs '
                  f'a displacement VECTOR dx;dy (got {spec!r})',
                  file=sys.stderr)
            return 1
        if not is_2d and len(parts) != 1:
            print(f'{kind}: a chain takes a scalar offset (got {spec!r})',
                  file=sys.stderr)
            return 1
        dx, dy = (parts if is_2d else (parts[0], 0))
        pairs = lattice.displacement_pairs(
            config.num_sites, config.size_x, config.size_y, dx, dy)
        disp = f'({dx},{dy})' if is_2d else str(dx)
        if kind == 'szsz':
            operator, label = obs.SzSzCorrelation(pairs), f'SzSz(d={disp})'
        elif config.heisenberg_jx < 0:
            # A state trained with jx < 0 is the ground state in the
            # Marshall gauge U = prod_B sigma^z, which flips Sx, Sy on
            # sublattice B: for pairs straddling the sublattices the
            # physical correlator is minus the measured one.  Applied per
            # pair, so exact for pair sets mixing same- and
            # cross-sublattice displacements.
            sub = lattice.marshall_sublattice(
                config.num_sites, config.size_x, config.size_y)
            operator = obs.TransverseCorrelation(
                pairs, sample_chunk=chunk,
                pair_signs=sub[pairs[:, 0]] * sub[pairs[:, 1]])
            label = (f'SxSx+SySy(d={disp}) physical (Marshall-gauge '
                     'corrected)')
        else:
            operator = obs.TransverseCorrelation(pairs, sample_chunk=chunk)
            label = f'SxSx+SySy(d={disp})'
    elif observable.startswith('sq:'):
        import numpy as np
        spec = observable.split(':', 1)[1]
        q = [float(v) * np.pi for v in spec.split(';')]
        pos = _positions(config)
        if len(q) != pos.shape[1]:
            print(f'S(q) needs {pos.shape[1]} momentum component(s)',
                  file=sys.stderr)
            return 1
        operator, label = obs.SpinStructureFactor(q, pos), f'S(q={spec}pi)'
    elif observable == 'total_spin2':
        # Marshall-gauged state: gauge-correct the exchange terms per pair.
        sub_mask = (lattice.marshall_sublattice(
            config.num_sites, config.size_x, config.size_y)
            if config.heisenberg_jx < 0 else None)
        operator = obs.TotalSpinSquared(config.num_sites, sample_chunk=chunk,
                                        sublattice=sub_mask)
        label = 'Total spin S^2'
    elif observable == 'staggered_m2':
        operator = obs.StaggeredMagnetizationSquared(
            lattice.marshall_sublattice(config.num_sites, config.size_x,
                                        config.size_y))
        label = 'Staggered m^2'
    else:
        print(f'Unknown observable {observable!r}', file=sys.stderr)
        return 1
    result = evaluate_operator(wf, params, operator, config, device)
    print(f'{label}: {result.mean} +/- {result.error}')
    print(f'Acceptance rate: {result.acceptance_rate:.4f}')
    return 0


def _linear_response(args, config, wf, params, hamiltonian, device) -> int:
    """`evolve --linear_response`: C(t) and S(q, omega) to
    linear_response.jsonl."""
    import json

    import numpy as np
    from cgs_vmc_tpu_torch.ops import dynamics
    q = [float(v) * np.pi for v in args.linear_response.split(';')]
    pos = _positions(config)
    if len(q) != pos.shape[1]:
        print(f'--linear_response needs {pos.shape[1]} momentum '
              'component(s)', file=sys.stderr)
        return 1
    times, corr, _ = dynamics.sampled_linear_response(
        wf, params, hamiltonian, dynamics.FourierSz(q, pos), config,
        eps=args.eps, dt=args.dt, n_steps=args.steps, device=device)
    omegas = np.linspace(0.0, np.pi * 3, 256)
    spec = dynamics.spectral_function(times, corr, omegas)
    out_path = os.path.join(config.checkpoint_dir, 'linear_response.jsonl')
    with open(out_path, 'w') as f:
        f.write(json.dumps({'q_over_pi': args.linear_response,
                            'eps': args.eps, 'times': times.tolist(),
                            'correlator': corr.tolist()}) + '\n')
        f.write(json.dumps({'omegas': omegas.tolist(),
                            'spectral_function': spec.tolist()}) + '\n')
    peak = float(omegas[int(np.argmax(spec))])
    print(f'Linear response C(t) over {args.steps} steps of dt={args.dt}; '
          f'S(q,omega) peak at omega={peak:.4f}')
    print(f'Wrote {out_path}')
    return 0


def _evolve(args, config, wf, params, hamiltonian, device) -> int:
    """`evolve`: t-VMC from equilibrated chains, the trajectory to
    evolution.jsonl."""
    import json

    import torch
    from cgs_vmc_tpu_torch.optim.tvmc import TimeEvolution
    evo = TimeEvolution(wf, hamiltonian, config, dt=args.dt, mode=args.mode,
                        integrator=args.integrator)
    sampler = evo.init_state(config.seed + 1, params, device)
    with torch.no_grad():
        sampler = evo.sweeps(params, sampler,
                             config.num_equilibration_sweeps)
    params, sampler, records = evo.evolve(params, sampler, args.steps)
    out_path = os.path.join(config.checkpoint_dir, 'evolution.jsonl')
    with open(out_path, 'w') as f:
        for i, rec in enumerate(records):
            f.write(json.dumps({'t': (i + 1) * args.dt, **rec}) + '\n')
    print(f'Evolved {args.steps} steps of dt={args.dt} ({args.mode} time); '
          f'trajectory in {out_path}')
    print(f"Final energy: {records[-1]['energy']}")
    return 0


if __name__ == '__main__':
    sys.exit(main())
