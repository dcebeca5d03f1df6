"""One training epoch of each optimizer, from its equations, given the
chain positions the sampler reached.

Monte Carlo draws are the sampler's and cannot be made again here, so an
epoch takes them as given: `positions` holds the boards after each block
of sweeps of the epoch (after the equilibration, then after each batch's
decorrelation).  Which positions an optimizer records is its definition:

 * SR records a batch, then decorrelates: positions 0 .. B-1.  It solves
   (S + ε·diag) δ = g in sample space (minSR):
     O = J - <J>,  T = O Oᵀ / M + ε·mean(diag(O Oᵀ / M))·I,
     δ = Oᵀ T⁻¹ (E - <E>) / M,
   gated as configured (a non-finite δ takes the gradient g; a residual
   |Oᵀ(T y - r)| over sr_reject_residual·|g| zeroes the step; |δ| clipped
   to sr_delta_clip), then θ ← θ - lr·δ.  For a complex log ψ
   (log|ψ| + i·phase, real θ), with ΔO = O_re + i·O_im and ε = E - <E>,
   S = Re<ΔO* ΔO> and g = Re<ΔO* ε> are the least squares of the stacked
   rows [O_re; O_im] against [Re ε; Im ε], each part centred by itself:
   the same solve, shift rule and gating with the [2M, 2M] T (divisor M),
   and the reported energy is Re<E_loc>.
 * ITSWO (a real log ψ only) decorrelates, then records: positions
   1 .. B.  ω is θ at the
   start of the epoch; for each batch the loss
     L = < (ψ_θ/stop(ψ_θ) - (ψ_ω/ψ_θ)(1 - β E_loc^ω) / N)² >
   takes a gradient step, N being the previous epoch's moving average of
   sqrt(1 - 2β<E> + β²<E²>) (TensorFlow's ExponentialMovingAverage with
   num_updates, decay 0.999).

The learning rate is rates[#(epoch >= stops)], and the update is plain
gradient descent (``optimizer`` 'gradient').
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference import energy, lattice, models

Params = models.Params


def learning_rate(cfg: dict, epoch: int) -> float:
    return cfg['learning_rates'][sum(epoch >= s
                                     for s in cfg['learning_rate_stops'])]


def _check_optimizer(cfg: dict) -> None:
    if cfg['optimizer'] != 'gradient':
        raise ValueError("the reference steps are plain gradient descent "
                         "(optimizer 'gradient')")


def _flat(p: Params) -> Tuple[torch.Tensor, list]:
    names = list(p)
    return torch.cat([p[n].reshape(-1) for n in names]), names


def _unflat(flat: torch.Tensor, like: Params) -> Params:
    out, at = {}, 0
    for name, leaf in like.items():
        out[name] = flat[at:at + leaf.numel()].view(leaf.shape)
        at += leaf.numel()
    return out


def jacobian(log_psi, p: Params, s: torch.Tensor, rows: int,
             complex_log: bool = False) -> List[torch.Tensor]:
    """The [M, P] rows ∂ log ψ(s_m) / ∂θ, leaves in the order of `p`: one
    block for a real log ψ; for a complex one two, the rows of its real
    part ∂log|ψ| and of its imaginary part ∂phase, each the gradient of a
    real output."""
    flat, _ = _flat(p)
    parts = (torch.real, torch.imag) if complex_log else (lambda z: z,)

    def rows_of(part):
        def one(f, board):
            return part(log_psi(_unflat(f, p), board[None])[0])
        return torch.func.vmap(torch.func.grad(one), in_dims=(None, 0),
                               chunk_size=rows)(flat, s)
    return [rows_of(part) for part in parts]


class Sides:
    """What the reference needs of one configuration: its log ψ, bonds and
    couplings (lattice.py; the configuration's where not given), and the
    block size of its batched evaluations."""

    def __init__(self, cfg: dict, bonds: torch.Tensor, rows: int,
                 couplings: Optional[Tuple[torch.Tensor, torch.Tensor]]
                 = None):
        self.cfg = cfg
        self.log_psi = models.build(cfg)
        self.complex = models.is_complex(cfg)
        self.bonds = bonds
        self.couplings = (lattice.couplings(cfg) if couplings is None
                          else couplings)
        self.rows = rows

    def log(self, p: Params, s: torch.Tensor) -> torch.Tensor:
        return models.chunked(self.log_psi, p, s, self.rows)

    def e_loc(self, p: Params, s: torch.Tensor) -> torch.Tensor:
        return energy.local_energy(self.log_psi, p, s, self.bonds,
                                   self.cfg['heisenberg_jx'],
                                   self.cfg['heisenberg_jz'], self.rows,
                                   self.couplings)


def sr_epoch(side: Sides, p: Params, epoch: int,
             positions: List[torch.Tensor], extra: Dict[str, float]
             ) -> Tuple[Params, Dict, Dict[str, float]]:
    """(θ after the epoch, {'energy': <E_loc>}, `extra` unchanged) of one
    SR epoch."""
    cfg = side.cfg
    _check_optimizer(cfg)
    if cfg['sr_solver'] != 'dense':
        raise ValueError("the reference SR solves 'dense' only")
    with torch.no_grad():
        s = torch.cat(positions[:cfg['num_batches_per_epoch']])
        e = side.e_loc(p, s)
    m = s.shape[0]
    o = torch.cat([rows - rows.mean(dim=0) for rows in
                   jacobian(side.log_psi, p, s, side.rows,
                            side.complex)]).detach()
    eps = e - e.mean()
    r = (torch.cat([eps.real, eps.imag]) if eps.is_complex() else eps) / m
    t = o @ o.T / m
    t = t + cfg['sr_diag_shift'] * torch.diagonal(t).mean() * torch.eye(
        o.shape[0], dtype=t.dtype, device=t.device)
    y = torch.linalg.solve(t, r)
    delta, grad = o.T @ y, o.T @ r
    if not bool(torch.isfinite(delta).all()):
        delta = grad
    elif cfg['sr_reject_residual'] > 0:
        residual = torch.linalg.vector_norm(o.T @ (t @ y - r))
        if residual >= cfg['sr_reject_residual'] * (
                torch.linalg.vector_norm(grad) + 1e-12):
            delta = torch.zeros_like(delta)
    delta = delta * min(1.0, cfg['sr_delta_clip']
                        / (float(torch.linalg.vector_norm(delta)) + 1e-12))
    flat, _ = _flat(p)
    new = _unflat(flat - learning_rate(cfg, epoch) * delta, p)
    return new, {'energy': float(e.mean().real)}, extra


def _ema(shadow: float, value: float, count: float) -> float:
    d = min(0.999, (1.0 + count) / (10.0 + count))
    return shadow * d + value * (1.0 - d)


def itswo_epoch(side: Sides, p: Params, epoch: int,
                positions: List[torch.Tensor], extra: Dict[str, float]
                ) -> Tuple[Params, Dict, Dict[str, float]]:
    """(θ after the epoch, {'energy', 'loss'}, the moving averages after
    it) of one ITSWO epoch; `extra` holds 'ite_normalization',
    'ema_norm', 'ema_energy' and 'ema_count' before it."""
    cfg = side.cfg
    _check_optimizer(cfg)
    if side.complex:
        raise ValueError('the reference ITSWO takes a real log ψ only')
    beta = cfg['time_evolution_beta']
    lr = learning_rate(cfg, epoch)
    omega = {k: v.detach().clone() for k, v in p.items()}
    norm = extra['ite_normalization']
    ema_norm, ema_energy, count = (extra['ema_norm'], extra['ema_energy'],
                                   extra['ema_count'])
    losses = []
    for s in positions[1:cfg['num_batches_per_epoch'] + 1]:
        with torch.no_grad():
            log_omega = side.log(omega, s)
            e = side.e_loc(omega, s)
        e_mean, e2_mean = float(e.mean()), float((e * e).mean())
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in p.items()}
        log_theta = side.log(leaves, s)
        with torch.no_grad():
            target = torch.exp(log_omega - log_theta) * (1.0 - beta * e) / norm
            weight = 2.0 * (1.0 - target) / s.shape[0]
        grads = torch.autograd.grad((weight * log_theta).sum(),
                                    list(leaves.values()))
        p = {k: (v - lr * g).detach()
             for (k, v), g in zip(p.items(), grads)}
        losses.append(float(((1.0 - target) ** 2).mean()))
        ite = math.sqrt(1.0 - 2.0 * beta * e_mean + beta ** 2 * e2_mean)
        ema_norm = _ema(ema_norm, ite, count)
        ema_energy = _ema(ema_energy, e_mean, count)
        count += 1.0
    after = {'ite_normalization': ema_norm, 'ema_norm': ema_norm,
             'ema_energy': ema_energy, 'ema_count': count}
    return p, {'energy': ema_energy, 'loss': sum(losses) / len(losses)}, after


EPOCHS = {'SR': sr_epoch, 'ITSWO': itswo_epoch}
