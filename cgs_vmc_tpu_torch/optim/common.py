"""Shared optimizer scaffolding (port of cgs_vmc_tpu/optim/common.py):
train state, the SGD family with an epoch-keyed learning rate, the
log-derivative pullback and the sweeps-function dispatch.

The update rules are written out with optax's semantics instead of using
torch.optim: adam is ``scale_by_adam(b1=0.9, b2=beta2, eps=1e-8)``,
rms_prop ``scale_by_rms()`` (decay 0.9, eps 1e-8 inside the root),
momentum ``trace(decay=0.9)`` and gradient the identity, each followed by
``p - lr * u`` with lr a function of the epoch counter.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from cgs_vmc_tpu_torch.models.base import (
    Params, Wavefunction, tree_leaves, tree_map, tree_unflatten)
from cgs_vmc_tpu_torch.ops.logamp import LogAmp
from cgs_vmc_tpu_torch.sampler import metropolis
from cgs_vmc_tpu_torch.sampler.metropolis import SamplerState
from cgs_vmc_tpu_torch.utils.device import resolve_device


class TrainState(NamedTuple):
    """Everything a training run carries between epochs, all checkpointed
    (sampler configs and generator state included)."""
    params: Params
    opt_state: Dict[str, Any]
    sampler: SamplerState
    epoch: int                # drives the LR schedule
    extra: Dict[str, Any]     # optimizer-specific


_ADAM_B1 = 0.9
_EPS = 1e-8
_DECAY = 0.9   # rms_prop's and momentum's decay


class SgdOptimizer:
    """adam/gradient/rms_prop/momentum plus the reference's piecewise-
    constant learning rate keyed on the EPOCH counter, independent of how
    many updates an optimizer performs per epoch."""

    KINDS = ('adam', 'gradient', 'rms_prop', 'momentum')

    def __init__(self, kind: str, rates, stops, beta2: float = 0.99):
        if kind not in self.KINDS:
            raise ValueError(f'Unknown optimizer {kind!r}; known: '
                             f'{sorted(self.KINDS)}')
        rates, stops = tuple(rates), tuple(stops)
        if len(rates) != len(stops) + 1:
            raise ValueError(
                'learning_rates must have one more entry than '
                f'learning_rate_stops; got {len(rates)} vs {len(stops)}')
        self.kind = kind
        self.rates = rates
        self.stops = stops
        self.beta2 = float(beta2)

    def init(self, params: Params) -> Dict[str, Any]:
        def zeros():
            return tree_map(torch.zeros_like, params)
        if self.kind == 'adam':
            return {'count': 0, 'mu': zeros(), 'nu': zeros()}
        if self.kind == 'rms_prop':
            return {'nu': zeros()}
        if self.kind == 'momentum':
            return {'trace': zeros()}
        return {}

    def learning_rate(self, epoch: int) -> float:
        return self.rates[sum(epoch >= s for s in self.stops)]

    def update(self, grads: Params, opt_state: Dict[str, Any],
               params: Params, epoch: int):
        """Returns (new_params, new_opt_state) after one descent step."""
        if self.kind == 'adam':
            b2 = self.beta2
            mu = tree_map(lambda g, m: (1 - _ADAM_B1) * g + _ADAM_B1 * m,
                          grads, opt_state['mu'])
            nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v,
                          grads, opt_state['nu'])
            count = opt_state['count'] + 1
            c1 = 1 - _ADAM_B1 ** count
            c2 = 1 - b2 ** count
            updates = tree_map(
                lambda m, v: (m / c1) / (torch.sqrt(v / c2) + _EPS), mu, nu)
            opt_state = {'count': count, 'mu': mu, 'nu': nu}
        elif self.kind == 'rms_prop':
            nu = tree_map(lambda g, v: (1 - _DECAY) * g ** 2 + _DECAY * v,
                          grads, opt_state['nu'])
            updates = tree_map(lambda g, v: torch.rsqrt(v + _EPS) * g,
                               grads, nu)
            opt_state = {'nu': nu}
        elif self.kind == 'momentum':
            updates = tree_map(lambda g, t: g + _DECAY * t, grads,
                               opt_state['trace'])
            opt_state = {'trace': updates}
        else:
            updates = grads
        lr = self.learning_rate(epoch)
        new_params = tree_map(lambda p, u: p - lr * u, params, updates)
        return new_params, opt_state


def make_sgd_optimizer(config) -> SgdOptimizer:
    return SgdOptimizer(config.optimizer, config.learning_rates,
                        config.learning_rate_stops, config.beta2)


def init_train_state(wf: Wavefunction, sgd: SgdOptimizer, config, seed: int,
                     device, n_chains: Optional[int] = None,
                     extra: Optional[Dict[str, Any]] = None) -> TrainState:
    """Epoch-0 state: params from a CPU generator seeded with `seed` (the
    same params on every device), moved to `device`; chains from a
    generator on `device` seeded with seed + 1."""
    device = resolve_device(device)
    params = wf.init(torch.Generator().manual_seed(seed))
    params = tree_map(lambda x: x.to(device), params)
    sampler = metropolis.init_sampler_for(seed + 1, wf, params, config,
                                          device, n_chains)
    return TrainState(params=params, opt_state=sgd.init(params),
                      sampler=sampler, epoch=0, extra=extra or {})


def log_derivative_pullback(wf: Wavefunction, params: Params,
                            configs: torch.Tensor):
    """Returns (amp, pullback) with pullback(w) = d/dparams Σ_b w_b log|ψ_b|.

    One forward pass serves every estimator moment (⟨∇logψ⟩ with w = 1/M,
    ⟨E_loc ∇logψ⟩ with w = E_loc/M); amp is detached and feeds the local
    value directly."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    amp = wf.apply(tree_unflatten(params, leaves), configs)
    if amp.log.is_complex():
        raise NotImplementedError(
            'This optimizer path supports real-log ansatzes only; '
            'complex-phase wavefunctions train with EnergyGradient or '
            "SR (sr_solver='dense'), which use log_amp_phase_pullback.")

    def pullback(weights: torch.Tensor) -> Params:
        grads = torch.autograd.grad(amp.log, leaves, grad_outputs=weights,
                                    retain_graph=True)
        return tree_unflatten(params, list(grads))

    return LogAmp(amp.sign.detach(), amp.log.detach()), pullback


def log_amp_phase_pullback(wf: Wavefunction, params: Params,
                           configs: torch.Tensor):
    """Complex-log twin of `log_derivative_pullback`.

    Returns (amp, pullback) with
      pullback(w_re, w_im) = d/dparams Σ_b [w_re_b·log|ψ_b| + w_im_b·phase_b].
    The complex log is split into two real outputs before autograd sees
    it, so no complex cotangent (and none of its conjugation conventions)
    is involved: O_k = ∂log|ψ| + i·∂phase is consumed as its real and
    imaginary parts (energy gradient: 2·Re[⟨O*·(E−Ē)⟩] = 2[⟨O_r·E_r⟩c +
    ⟨O_i·E_i⟩c]).  A real log has phase 0 and contributes only w_re.
    """
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    amp = wf.apply(tree_unflatten(params, leaves), configs)
    if amp.log.is_complex():
        outputs = (amp.log.real, amp.log.imag)
    else:
        outputs = (amp.log,)

    def pullback(w_re: torch.Tensor, w_im: torch.Tensor) -> Params:
        grads = torch.autograd.grad(
            outputs, leaves, grad_outputs=(w_re, w_im)[:len(outputs)],
            retain_graph=True, allow_unused=True)
        grads = [torch.zeros_like(leaf) if g is None else g
                 for g, leaf in zip(grads, leaves)]
        return tree_unflatten(params, grads)

    return LogAmp(amp.sign.detach(), amp.log.detach()), pullback


def tree_weighted_diff(g_scaled: Params, g_plain: Params, coeff) -> Params:
    """g_scaled - coeff * g_plain, leafwise (variance-reduced gradients)."""
    return tree_map(lambda a, b: a - coeff * b, g_scaled, g_plain)


def grad_global_norm(grads: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree_leaves(grads)))


def make_sweeps_fn(wf: Wavefunction, config):
    """Returns sweeps(params, sampler_state, num_sweeps) -> sampler_state,
    dispatched by the sampler fast-path registry."""
    from cgs_vmc_tpu_torch.sampler import registry
    return registry.resolve_sweeps_fn(wf, config)

