"""Signed log-amplitude arithmetic (port of cgs_vmc_tpu/ops/logamp.py).

Every wavefunction returns amplitudes as ``(sign, log)`` pairs,
psi = sign * exp(log), so Metropolis ratios, local-energy off-diagonal
terms and sums of wavefunctions are overflow-free by construction.
Complex wavefunctions carry a complex ``log`` (log|psi| + i*phase) with a
real ±1 ``sign``; every modulus-based consumer reads ``log.real``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LogAmp(NamedTuple):
    """A batch of signed log-amplitudes: psi = sign * exp(log)."""
    sign: torch.Tensor
    log: torch.Tensor


def from_value(value: torch.Tensor) -> LogAmp:
    """Converts raw amplitudes to signed-log form."""
    return LogAmp(torch.sign(value), torch.log(torch.abs(value)))


def to_value(amp: LogAmp) -> torch.Tensor:
    """Materializes raw amplitudes (use only in tests / tiny systems)."""
    return amp.sign * torch.exp(amp.log)


def mul(a: LogAmp, b: LogAmp) -> LogAmp:
    """psi_a * psi_b."""
    return LogAmp(a.sign * b.sign, a.log + b.log)


def scale(a: LogAmp, factor: float) -> LogAmp:
    """psi_a * factor for a real (possibly negative) scalar."""
    factor = torch.as_tensor(factor, dtype=a.log.dtype, device=a.log.device)
    return LogAmp(a.sign * torch.sign(factor),
                  a.log + torch.log(torch.abs(factor)))


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    # Both terms -inf: shift by 0 instead of producing nan.
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def add(a: LogAmp, b: LogAmp) -> LogAmp:
    """psi_a + psi_b with cancellation-safe signed logsumexp."""
    if a.log.is_complex() or b.log.is_complex():
        m = _finite_or_zero(torch.maximum(a.log.real, b.log.real))
        v = a.sign * torch.exp(a.log - m) + b.sign * torch.exp(b.log - m)
        # log of a complex value = log|v| + i*arg(v): the phase rides along.
        return LogAmp(torch.ones_like(m), m + torch.log(v))
    m = _finite_or_zero(torch.maximum(a.log, b.log))
    v = a.sign * torch.exp(a.log - m) + b.sign * torch.exp(b.log - m)
    return LogAmp(torch.sign(v), m + torch.log(torch.abs(v)))


def sub(a: LogAmp, b: LogAmp) -> LogAmp:
    """psi_a - psi_b."""
    return add(a, LogAmp(-b.sign, b.log))


def sum_terms(signs: torch.Tensor, logs: torch.Tensor, axis: int = -1
              ) -> LogAmp:
    """Signed logsumexp reduction: sum_k sign_k * exp(log_k) along `axis`."""
    if logs.is_complex():
        m = _finite_or_zero(torch.amax(logs.real, dim=axis, keepdim=True))
        v = torch.sum(signs * torch.exp(logs - m), dim=axis)
        m = m.squeeze(axis)
        return LogAmp(torch.ones_like(m), m + torch.log(v))
    m = _finite_or_zero(torch.amax(logs, dim=axis, keepdim=True))
    v = torch.sum(signs * torch.exp(logs - m), dim=axis)
    m = m.squeeze(axis)
    return LogAmp(torch.sign(v), m + torch.log(torch.abs(v)))


def ratio(num: LogAmp, den: LogAmp) -> torch.Tensor:
    """Raw ratio psi_num / psi_den = s_n * conj(s_d) * exp(log_n - log_d)."""
    return num.sign * torch.conj(den.sign) * torch.exp(num.log - den.log)


def log_abs_ratio(num: LogAmp, den: LogAmp) -> torch.Tensor:
    """log |psi_num / psi_den| (reads .real for complex logs)."""
    return num.log.real - den.log.real


def apply_activation(pre: torch.Tensor, activation: str) -> LogAmp:
    """Turns a network's pre-activation output into a signed log-amplitude:
    'exp' is the identity in log space (sign = +1); any other activation f
    gives (sign(f(x)), log|f(x)|)."""
    if activation == 'exp':
        return LogAmp(torch.ones_like(pre), pre)
    value = ACTIVATIONS[activation](pre)
    return LogAmp(torch.sign(value), torch.log(torch.abs(value)))


# Name -> elementwise fn, the same registry as the JAX package.
ACTIVATIONS = {
    'relu': torch.relu,
    'exp': torch.exp,
    'cos': torch.cos,
    'tan': torch.tan,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'selu': torch.selu,
    'identity': lambda x: x,
    'none': lambda x: x,
}
