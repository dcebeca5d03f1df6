"""Single Lanczos-step evaluation and zero-variance extrapolation (port of
cgs_vmc_tpu/ops/lanczos.py).

Given a trained state |psi>, measure the Hamiltonian moments

    h_p = <psi|H^p|psi> / <psi|psi>,   p = 1..4,

and from them the energy of the one-step Lanczos (Becca–Sorella) state

    |psi_a> = (1 + a H)|psi>,
    E(a) = (h1 + 2a h2 + a^2 h3) / (1 + 2a h1 + a^2 h2),

minimized in closed form over real a — a variational improvement computed
at measurement time, with no retraining.  With h4 the variance of |psi_a>
follows too, and with it the two-point zero-variance extrapolation
E(sigma^2 -> 0).

Estimators (one level of connected-configuration fan-out; H hermitian):

    h1 = E[ E_loc ],            E_loc = (H psi)(R) / psi(R)
    h2 = E[ |E_loc|^2 ]
    h3 = E[ conj(E_loc) * H2_loc ],  H2_loc = (H^2 psi)(R) / psi(R)
    h4 = E[ |H2_loc|^2 ]

with H2_loc(R) = diag(R) E_loc(R) + sum_k w_k(R) r_k(R) E_loc(R_k) and
r_k = psi(R_k)/psi(R): the local energy's diagonal + connected
decomposition applied once more at every connected configuration, so a
sample costs O(K^2) amplitude evaluations (K = n_bonds).  The moments are
torch on the params' device; the closed-form step, the variance
extrapolation and the block jackknife are float64 numpy, the JAX package's
code unchanged, so both give the same numbers from the same [n, 4] array.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cgs_vmc_tpu_torch import basis as basis_lib
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, tree_leaves
from cgs_vmc_tpu_torch.ops.heisenberg import LocalOperator
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


@torch.no_grad()
def moment_local_values(operator: LocalOperator, wf: Wavefunction,
                        params: Params, configs: torch.Tensor,
                        amp: Optional[LogAmp] = None,
                        shift: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Per-sample moment estimators (e1, |e1|^2, conj(e1)*h2loc, |h2loc|^2).

    Returns four [batch] tensors whose |psi|^2-averages are h1..h4.  The
    inner E_loc at each connected configuration goes through the
    operator's own `local_value`, so its `sample_chunk` bounds the
    [batch*K, K] fan-out.

    shift: moments are taken of H' = H - shift*1.  At |E| >> sigma the raw
    moments sit at E, E^2, E^3, E^4 and the quantities that matter
    (variances, h3 - h1 h2, ...) are O(sigma^2) cancellations of those huge
    numbers, beyond f32 mantissas on big lattices.  Shifting by ~<H> makes
    every moment O(sigma^p) directly.  span{psi, H'psi} = span{psi, Hpsi},
    so the Lanczos step is the same one; energies shift back by +shift
    (evaluate_lanczos does)."""
    if amp is None:
        amp = wf.apply(params, configs)
    batch, n_sites = configs.shape
    flipped, weights = operator.connected(configs)
    k = flipped.shape[1]
    flat = flipped.reshape(batch * k, n_sites)
    amp_f = wf.apply(params, flat)
    log_f = amp_f.log.reshape(batch, k)
    sign_f = amp_f.sign.reshape(batch, k)
    # The ratio convention of LocalOperator._offdiag_ratio_sum.
    ratios = (sign_f * amp.sign[:, None]
              * torch.exp(log_f - amp.log[:, None]))
    diag = operator.diagonal(configs)
    e1 = diag + torch.sum(weights * ratios, dim=-1)
    e_conn = operator.local_value(wf, params, flat, amp_f).reshape(batch, k)
    h2loc = diag * e1 + torch.sum(weights * ratios * e_conn, dim=-1)
    if shift:
        # ((H-s)^2 psi)/psi = H2_loc - 2s E_loc + s^2; (H-s)psi/psi = e1-s.
        h2loc = h2loc - 2.0 * shift * e1 + shift * shift
        e1 = e1 - shift
    m2 = torch.abs(e1) ** 2
    m3 = torch.conj(e1) * h2loc
    m4 = torch.abs(h2loc) ** 2
    return e1, m2, m3, m4


def _moment_rows(operator, wf, params, configs, shift, amp=None):
    """[batch, 4] real parts of the moment estimators."""
    return torch.stack([v.real for v in moment_local_values(
        operator, wf, params, configs, amp, shift=shift)], dim=1)


def lanczos_energy(alpha: float, h: Tuple[float, float, float, float]
                   ) -> float:
    h1, h2, h3, _ = h
    num = h1 + 2.0 * alpha * h2 + alpha * alpha * h3
    den = 1.0 + 2.0 * alpha * h1 + alpha * alpha * h2
    return num / den


def lanczos_variance(alpha: float, h: Tuple[float, float, float, float]
                     ) -> float:
    h1, h2, h3, h4 = h
    den = 1.0 + 2.0 * alpha * h1 + alpha * alpha * h2
    hsq = (h2 + 2.0 * alpha * h3 + alpha * alpha * h4) / den
    e = lanczos_energy(alpha, h)
    return hsq - e * e


def optimal_alpha(h: Tuple[float, float, float, float],
                  var_floor: float = 0.0) -> float:
    """argmin_a E(a): dE/da = 0 reduces to the quadratic

        (h1 h3 - h2^2) a^2 + (h3 - h1 h2) a + (h2 - h1^2) = 0.

    Picks the real root with positive norm D(a) and the lower E(a);
    returns 0 when the state is (numerically) an eigenstate (variance
    h2 - h1^2 ~ 0, where the quadratic coefficients are pure noise).

    var_floor: treat var0 <= var_floor as the eigenstate case.  Callers
    with SHIFTED moments must pass it: under a shift of ~<H> every
    moment is O(sigma^p), so the relative guard below (against the
    moments' own scale) can never fire — the floor has to come from
    outside knowledge (estimator noise, or eps_f32 * E^2;
    result_from_values derives one)."""
    h1, h2, h3, _ = h
    var0 = h2 - h1 * h1
    scale = max(abs(h2), h1 * h1, 1e-30)
    if var0 <= max(1e-12 * scale, var_floor):
        return 0.0
    a = h1 * h3 - h2 * h2
    b = h3 - h1 * h2
    c = var0
    if abs(a) < 1e-30 * max(abs(b), 1.0):
        roots = [-c / b] if b != 0.0 else []
    else:
        disc = b * b - 4.0 * a * c
        if disc < 0.0:
            return 0.0
        sq = np.sqrt(disc)
        roots = [(-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)]
    best, best_e = 0.0, lanczos_energy(0.0, h)
    for r in roots:
        den = 1.0 + 2.0 * r * h1 + r * r * h2
        if den <= 0.0 or not np.isfinite(r):
            continue
        e = lanczos_energy(r, h)
        if e < best_e:
            best, best_e = float(r), e
    return best


class LanczosResult(NamedTuple):
    """Basis convention: `e0`, `energy`, `extrapolated` are energies of
    the PHYSICAL H (shift added back); `moments`, `values`, and `alpha`
    live in the recorded H' = H - `shift` basis, so the internal
    invariant is lanczos_energy(alpha, moments) + shift == energy.  Use
    `alpha_physical` for the coefficient of the (1 + a H) state."""
    e0: float                 # <H> of |psi> (h1 + shift)
    e0_err: float
    alpha: float              # optimal coefficient of (1 + a (H - shift))
    energy: float             # E(alpha) — the improved variational energy
    energy_err: float         # block-jackknife over recorded samples
    variance0: float          # sigma^2 of |psi> (shift-invariant)
    variance_alpha: float     # sigma^2 of |psi_alpha>
    extrapolated: float       # two-point E(sigma^2 -> 0)
    moments: Tuple[float, float, float, float]   # of H - shift
    values: np.ndarray        # [num_samples, 4] recorded batch means
    acceptance_rate: float
    shift: float = 0.0        # the energy shift the moments carry

    @property
    def alpha_physical(self) -> float:
        """Coefficient of (1 + a H)|psi> spanning the same state:
        1 + a'(H - s) = (1 - a's)(1 + a'/(1 - a's) H) — the overall
        constant is a normalization and drops."""
        den = 1.0 - self.alpha * self.shift
        return self.alpha / den if den != 0.0 else float('inf')


def _combine(values: np.ndarray, var_floor: float = 0.0
             ) -> Tuple[float, float, float, float, float]:
    """(h1..h4, E(alpha*)) from recorded [n, 4] sample means."""
    h = tuple(float(v) for v in values.mean(axis=0))
    alpha = optimal_alpha(h, var_floor)
    return h + (lanczos_energy(alpha, h),)


def _block_jackknife(values: np.ndarray, var_floor: float,
                     min_blocks: int = 8) -> Tuple[float, float]:
    """(e0_err, energy_err) by delete-one-BLOCK jackknife, taking the
    max over doubling block sizes — the jackknife analog of
    evaluate.binned_error's plateau search, so consecutive correlated
    batch means don't fake tight error bars while the full nonlinear
    alpha/E(alpha) pipeline still propagates exactly."""
    n = values.shape[0]
    e0_err = e_err = 0.0
    size = 1
    # The size-1 level always runs (plain delete-one jackknife), so small
    # sample counts report a (possibly autocorrelation-naive) error
    # instead of a silent 0; larger sizes need >= min_blocks blocks.
    while size == 1 or n // size >= min_blocks:
        nb = n // size
        if nb < 2:
            break
        blocks = values[:nb * size].reshape(nb, size, values.shape[1])
        block_means = blocks.mean(axis=1)
        jk_e0 = np.empty(nb)
        jk_e = np.empty(nb)
        for i in range(nb):
            sub = np.delete(block_means, i, axis=0)
            h1_i, _, _, _, e_i = _combine(sub, var_floor)
            jk_e0[i] = h1_i
            jk_e[i] = e_i
        factor = (nb - 1) / nb
        e0_err = max(e0_err, float(np.sqrt(
            factor * np.sum((jk_e0 - jk_e0.mean()) ** 2))))
        e_err = max(e_err, float(np.sqrt(
            factor * np.sum((jk_e - jk_e.mean()) ** 2))))
        size *= 2
    return e0_err, e_err


def result_from_values(values: np.ndarray, acceptance_rate: float = 0.0,
                       shift: float = 0.0) -> LanczosResult:
    """Builds the full LanczosResult (closed-form step + block-jackknife
    errors + two-point variance extrapolation) from [n, 4] recorded means.

    shift: the energy shift the moments were recorded under (see
    moment_local_values); reported energies are shifted back to H's."""
    values = np.asarray(values, np.float64)
    n = values.shape[0]
    # Eigenstate guard floor: under a shift the moments carry no O(E^p)
    # scale to compare the variance against, so derive an absolute floor
    # from (a) the f32 estimator's resolution at the physical energy and
    # (b) when n allows, the statistical noise of var0 itself.
    h1_raw = float(values[:, 0].mean())
    floor = 1.2e-7 * (h1_raw + shift) ** 2
    if n > 1:
        jk_var = np.empty(n)
        for i in range(n):
            sub = np.delete(values, i, axis=0)
            m1 = sub[:, 0].mean()
            jk_var[i] = sub[:, 1].mean() - m1 * m1
        var0_err = float(np.sqrt(
            (n - 1) / n * np.sum((jk_var - jk_var.mean()) ** 2)))
        floor = max(floor, 3.0 * var0_err)
    h1, h2, h3, h4, energy = _combine(values, floor)
    h = (h1, h2, h3, h4)
    alpha = optimal_alpha(h, floor)
    var0 = lanczos_variance(0.0, h)
    var_a = lanczos_variance(alpha, h)
    # Two-point zero-variance extrapolation through (var, E) at a=0 and
    # a=alpha*; degenerate when the step doesn't reduce the variance.
    if var0 > var_a > 0.0:
        extrap = energy - var_a * (h1 - energy) / (var0 - var_a)
    else:
        extrap = energy
    if n > 1:
        e0_err, e_err = _block_jackknife(values, floor)
    else:
        e0_err = e_err = float('nan')
    return LanczosResult(
        e0=h1 + shift, e0_err=e0_err, alpha=alpha, energy=energy + shift,
        energy_err=e_err, variance0=var0, variance_alpha=var_a,
        extrapolated=extrap + shift, moments=h, values=values,
        acceptance_rate=acceptance_rate, shift=shift)


def evaluate_lanczos(
    wf: Wavefunction,
    params: Params,
    operator: LocalOperator,
    config,
    device,
    seed: Optional[int] = None,
    state=None,
    sample_chunk: int = 0,
    energy_shift=0.0,
) -> LanczosResult:
    """MC Lanczos-step evaluation: equilibrate, then alternate (record the
    batch-mean moments / decorrelate by num_monte_carlo_sweeps).

    Chains start from `state` or from a fresh sampler on `device` seeded
    with `seed` (default config.seed).  sample_chunk > 0 evaluates the
    moment estimators that many samples at a time (bounds the [chunk*K, K]
    fan-out).  energy_shift: measure moments of H - shift (see
    moment_local_values); reported energies include the shift back.
    'auto' takes the shift from one equilibrated batch's plain local
    energies.
    """
    from cgs_vmc_tpu_torch.optim.common import make_sweeps_fn
    from cgs_vmc_tpu_torch.sampler import metropolis

    if state is None:
        state = metropolis.init_sampler_for(
            config.seed if seed is None else seed, wf, params, config,
            device)
    state = metropolis.refresh_amplitudes(wf, params, state)
    sweeps_fn = make_sweeps_fn(wf, config)

    with torch.no_grad():
        state = metropolis.reset_stats(state)
        state = sweeps_fn(params, state, config.num_equilibration_sweeps)
        if energy_shift == 'auto':
            energy_shift = float(torch.mean(operator.local_value(
                wf, params, state.configs).real))

        values = []
        for _ in range(config.num_evaluation_samples):
            configs = state.configs
            chunk = sample_chunk or configs.shape[0]
            rows = torch.cat([
                _moment_rows(operator, wf, params,
                             configs[start:start + chunk], energy_shift)
                for start in range(0, configs.shape[0], chunk)])
            values.append(torch.mean(rows, dim=0))
            state = sweeps_fn(params, state, config.num_monte_carlo_sweeps)
        acc = float(metropolis.acceptance_rate(state))
    values = torch.stack(values).cpu().numpy()
    return result_from_values(values, acc, shift=energy_shift)


def exact_lanczos(wf: Wavefunction, params: Params,
                  operator: LocalOperator, num_sites: int,
                  n_down: Optional[int] = None, batch: int = 1024,
                  energy_shift: float = 0.0,
                  basis_states: Optional[np.ndarray] = None
                  ) -> LanczosResult:
    """Deterministic moments over an enumerated basis (no MCMC) on the
    params' device — the zero-variance companion to `evaluate_lanczos`,
    practical up to num_sites ~ 16 (the fan-out is dim * K^2).

    basis_states: the basis to sum over; defaults to the fixed-Sz sector
    (Heisenberg).  Pass `basis.enumerate_full_basis(n)` for operators that
    do not conserve Sz (the TFIM)."""
    states = (basis_states if basis_states is not None
              else basis_lib.enumerate_sz_basis(num_sites, n_down))
    device = tree_leaves(params)[0].device
    logs, rows = [], []
    with torch.no_grad():
        for start in range(0, states.shape[0], batch):
            chunk = torch.as_tensor(
                np.asarray(states[start:start + batch], np.float32),
                device=device)
            amp = wf.apply(params, chunk)
            logs.append(amp.log.real)
            rows.append(_moment_rows(operator, wf, params, chunk,
                                     energy_shift, amp))
    logs = torch.cat(logs).cpu().numpy().astype(np.float64)
    rows = torch.cat(rows).cpu().numpy()
    weights = np.exp(2.0 * (logs - logs.max()))
    weights /= weights.sum()
    means = (weights[:, None] * rows).sum(axis=0)
    return result_from_values(means[None, :], shift=energy_shift)
