"""Dynamical structure factor S(q, omega) by linear-response t-VMC (port of
cgs_vmc_tpu/ops/dynamics.py).

The standard linear-response protocol on the TDVP machinery
(optim/tvmc.py):

1. Quench: |psi_eps> = e^{eps O_q}|0> projected onto the variational
   manifold — one imaginary-"time" TDVP direction under the probe O_q
   integrated for -eps (the tangent-space projection of multiplying by
   (1 + eps O_q); exact on a complete parameterization).
2. Evolve |psi_eps> under H in real time (complex-log ansatz), recording
   A(t) = <O_q>(t).
3. Response: for a Hermitian probe and real eps,
       (A(t) - <O_q>_0) / (2 eps) = Re <0| O_q(t) O_q |0>_connected
   to first order in eps — the symmetric dynamical correlator C(t).
4. Spectrum: S(q, omega) = 2 ∫_0^T dt cos(omega t) e^{-eta t} C(t) peaks
   at the excitation energies E_n - E_0 with the weights |<n|O_q|0>|².

The probe O_q = N^{-1/2} Σ_i cos(q·r_i) Sz_i is diagonal: its local value
needs no extra wavefunction evaluations, the quenched state stays in the
sampled Sz sector, and <O_q> is a plain sampled mean.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, tree_map
from cgs_vmc_tpu_torch.ops.heisenberg import Operator
from cgs_vmc_tpu_torch.ops.logamp import LogAmp
from cgs_vmc_tpu_torch.ops.observables import SiteTables
from cgs_vmc_tpu_torch.optim.tvmc import TimeEvolution, tdvp_direction
from cgs_vmc_tpu_torch.sampler import metropolis


class FourierSz(Operator):
    """O_q = N^{-1/2} Σ_i cos(q·r_i) Sz_i — the (cosine) momentum-q
    longitudinal spin probe; diagonal in the computational basis."""

    def __init__(self, q: Sequence[float], positions: np.ndarray):
        q = np.asarray(q, np.float64).reshape(-1)
        positions = np.asarray(positions, np.float64)
        if positions.ndim != 2 or positions.shape[1] != q.shape[0]:
            raise ValueError(
                f'positions must be [n_sites, {q.shape[0]}], '
                f'got {positions.shape}')
        n = positions.shape[0]
        self.coeff = (np.cos(positions @ q) / np.sqrt(n)).astype(np.float32)
        self._tables = SiteTables(self.coeff)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: torch.Tensor, amp: Optional[LogAmp] = None
                    ) -> torch.Tensor:
        del wf, params, amp  # diagonal
        (coeff,) = self._tables.on(configs.device)
        return torch.sum(0.5 * configs * coeff, dim=-1)


def quench_params(wf: Wavefunction, params: Params, configs: torch.Tensor,
                  probe: Operator, eps: float,
                  diag_shift: float = 1e-6,
                  weights: Optional[torch.Tensor] = None,
                  jacobian_chunk: int = 0) -> Params:
    """Tangent-space projection of |psi> -> e^{eps O}|psi>: one 'imag'
    TDVP direction under the probe integrated for -eps, theta' = theta -
    eps * theta_dot (the imag direction tracks e^{-tau O})."""
    with torch.no_grad():
        o_loc = probe.local_value(wf, params, configs)
        if wf.apply(params, configs[:1]).log.is_complex():
            o_loc = o_loc.to(torch.complex64)
    theta_dot, _, _ = tdvp_direction(wf, params, configs, o_loc,
                                     mode='imag', diag_shift=diag_shift,
                                     weights=weights,
                                     jacobian_chunk=jacobian_chunk)
    return tree_map(lambda p, d: p - eps * d, params, theta_dot)


def _basis_weights(wf: Wavefunction, params: Params,
                   states: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return torch.softmax(2.0 * wf.apply(params, states).log.real, dim=0)


def exact_linear_response(
    wf: Wavefunction, params: Params, hamiltonian: Operator,
    probe: Operator, states: torch.Tensor, eps: float, dt: float,
    n_steps: int, diag_shift: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, list]]:
    """C(t) on the full enumerated basis (deterministic |psi|² weights,
    Heun integration) — the oracle / small-system path.

    Returns (times [n_steps+1], C [n_steps+1], diagnostics) with
    C(t) = (<O>(t) - <O>_0) / (2 eps) ~= Re <O(t) O>_c.
    """
    def observe(p):
        with torch.no_grad():
            return float(torch.sum(_basis_weights(wf, p, states)
                                   * probe.local_value(wf, p, states).real))

    def direction(p):
        with torch.no_grad():
            amp = wf.apply(p, states)
            w = torch.softmax(2.0 * amp.log.real, dim=0)
            e_loc = hamiltonian.local_value(wf, p, states, amp)
        return tdvp_direction(wf, p, states, e_loc, mode='real',
                              diag_shift=diag_shift, weights=w)

    o_base = observe(params)
    p = quench_params(wf, params, states, probe, eps, diag_shift=diag_shift,
                      weights=_basis_weights(wf, params, states))
    values = [observe(p)]
    diagnostics = {'energy': [], 'tdvp_r2': []}
    for _ in range(n_steps):
        k1, e, r2 = direction(p)
        k2, _, _ = direction(tree_map(lambda a, d: a + 0.5 * dt * d, p, k1))
        p = tree_map(lambda a, d: a + dt * d, p, k2)
        values.append(observe(p))
        diagnostics['energy'].append(complex(e))
        diagnostics['tdvp_r2'].append(float(r2))
    times = dt * np.arange(n_steps + 1)
    corr = (np.asarray(values) - o_base) / (2.0 * eps)
    return times, corr, diagnostics


def coupled_copy(state: metropolis.SamplerState) -> metropolis.SamplerState:
    """The same chains with a second generator in the same state: sweeps of
    the copy draw exactly the random numbers the original's draw."""
    generator = torch.Generator(device=state.generator.device)
    generator.set_state(state.generator.get_state())
    return state._replace(generator=generator)


def sampled_linear_response(
    wf: Wavefunction, params: Params, hamiltonian: Operator,
    probe: Operator, config, eps: float, dt: float, n_steps: int,
    device, seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """MC version with antithetic coupled chains: quench to +eps and -eps
    from the same equilibrated chains, evolve both trajectories on
    identical random-number streams (`coupled_copy`), and take

        C(t) = (<O>_{+eps}(t) - <O>_{-eps}(t)) / (4 eps).

    The symmetric difference cancels the even-order quench bias and the
    chain-sampling noise, which is strongly correlated between
    trajectories that differ by O(eps).  Each trajectory's chains
    re-equilibrate under its quenched amplitudes before t = 0 is recorded.

    Returns (times, C, per-step records of the +eps trajectory).
    """
    evo = TimeEvolution(wf, hamiltonian, config, dt=dt, mode='real',
                        integrator='heun')
    sampler = evo.init_state(config.seed if seed is None else seed, params,
                             device)
    sampler = metropolis.refresh_amplitudes(wf, params, sampler)
    sampler = evo.sweeps(params, sampler, config.num_equilibration_sweeps)

    def probe_mean(configs):
        with torch.no_grad():
            return float(torch.mean(probe.local_value(wf, None,
                                                      configs).real))

    chunk = config.sr_jacobian_chunk
    p_pos = quench_params(wf, params, sampler.configs, probe, eps,
                          diag_shift=config.sr_diag_shift,
                          jacobian_chunk=chunk)
    p_neg = quench_params(wf, params, sampler.configs, probe, -eps,
                          diag_shift=config.sr_diag_shift,
                          jacobian_chunk=chunk)

    def equilibrate(p, smp):
        smp = metropolis.refresh_amplitudes(wf, p, smp)
        return evo.sweeps(p, smp, config.num_equilibration_sweeps)

    s_neg = coupled_copy(sampler)          # same start, same draws
    s_pos = equilibrate(p_pos, sampler)
    s_neg = equilibrate(p_neg, s_neg)

    values = [(probe_mean(s_pos.configs), probe_mean(s_neg.configs))]
    records = []
    for _ in range(n_steps):
        p_pos, s_pos, metrics = evo.step(p_pos, s_pos)
        p_neg, s_neg, _ = evo.step(p_neg, s_neg)
        values.append((probe_mean(s_pos.configs), probe_mean(s_neg.configs)))
        records.append({k: float(v) for k, v in metrics.items()})
    times = dt * np.arange(n_steps + 1)
    values = np.asarray(values)
    corr = (values[:, 0] - values[:, 1]) / (4.0 * eps)
    return times, corr, records


def spectral_function(times: np.ndarray, corr: np.ndarray,
                      omegas: np.ndarray, eta: float = 0.2) -> np.ndarray:
    """S(omega) = 2 ∫_0^T dt cos(omega t) e^{-eta t} C(t), trapezoid rule.

    eta damps the finite-T cutoff (Lorentzian broadening ~eta around each
    excitation peak).
    """
    times = np.asarray(times, np.float64)
    corr = np.asarray(corr, np.float64)
    omegas = np.asarray(omegas, np.float64)
    damped = corr * np.exp(-eta * times)
    integrand = np.cos(np.outer(omegas, times)) * damped[None, :]
    trapezoid = getattr(np, 'trapezoid', None) or np.trapz
    return 2.0 * trapezoid(integrand, times, axis=1)
