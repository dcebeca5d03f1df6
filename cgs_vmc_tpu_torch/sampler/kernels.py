"""Fused RBM Metropolis exchange sweeps: CUDA kernels and plain versions
(port of cgs_vmc_tpu/sampler/kernels.py).

For the classic RBM (logψ = a·s + Σ_h logcosh(s·W + b)_h) an exchange move
has an O(H) incremental update, instead of the O(N·H) forward pass the
generic sampler pays per proposal.  Each chain exchanges, per step, its
k_down-th −1 spin with its k_up-th +1 spin (ranks in site order) and
accepts when 2Δlogψ > log u.

Two kernels, both in ``csrc/rbm_sweep.cu`` (design notes there):

* K1 ``rbm_sweeps``: ranks and log-uniforms streamed as tensors — the
  bitwise oracle, fed the same draws as its plain version.
* K2 ``rbm_sweeps_prng``: every draw made in the kernel with Philox4x32-10
  keyed by (seed, chain), counter (step).  ``philox_draws`` makes the same
  words in int64 torch arithmetic, so K2's plain version is K1's plain
  version fed those draws, and the kernel is compared trajectory for
  trajectory.

Each public wrapper dispatches on the device of its tensors: a CPU tensor
runs the plain version; a CUDA tensor launches the kernel or raises.  There
is no fallback from the kernel to the plain version.  Both wrappers
recompute θ and logψ from the final configs with one matmul, which removes
the drift of thousands of incremental updates.

The plain versions sum Σ_h with torch.sum, as the JAX kernel's oracle does,
so a decision within rounding of the accept threshold may go the other way
in the kernel.  The lane-order witnesses (``rbm_sweeps_lanes_plain``,
``rbm_sweeps_prng_lanes_plain``) make the kernels' decisions in their own
float32 order, θ carried through the call, and the kernels are held to
them bit for bit on every chain.

A chain runs on a group of G lanes; the launcher picks G from the hidden
width by a fixed rule (``instance`` reports its choice).  The module-private
``_rbm_sweeps`` / ``_rbm_sweeps_prng`` force a width, for the card's tests
and chip_smoke.py only.
"""

from __future__ import annotations

import ctypes
import re
from typing import NamedTuple, Union

import torch

from cgs_vmc_tpu_torch.models.nn import log_cosh
from cgs_vmc_tpu_torch.utils import cuda_build

MAX_SITES = 256     # spins are a bitmask of 8 words in the kernel
MAX_UNITS_PER_LANE = 16
LANES = (16, 32)  # lanes a chain the kernels are built for
MAX_HIDDEN = MAX_UNITS_PER_LANE * 32

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_STEP_BLOCK = 1024  # steps of Philox draws materialized at a time


class RbmSweepResult(NamedTuple):
    configs: torch.Tensor       # [chains, n_sites] updated spins
    theta: torch.Tensor         # [chains, hidden] θ of the final configs
    log_amp: torch.Tensor       # [chains] logψ of the final configs
    num_accepted: torch.Tensor  # [chains] accepted moves this call


def _caches(w, b, a, configs):
    theta = configs @ w + b
    return theta, configs @ a + torch.sum(log_cosh(theta), dim=-1)


# ---------------------------------------------------------------------------
# Plain torch versions.

def rbm_sweeps_plain(w, b, a, configs, picks, log_u) -> RbmSweepResult:
    """K1's plain version: incremental θ/logcosh updates, one step at a
    time over all chains; any device.  Equal to the JAX kernel and its
    oracle on the same draws (Σ_h by torch.sum)."""
    n_chains, n_sites = configs.shape
    theta = configs @ w + b
    lc = log_cosh(theta)
    down = configs < 0
    accepted = torch.zeros(n_chains, dtype=torch.float32,
                           device=configs.device)
    rows = torch.arange(n_chains, device=configs.device)
    for t in range(picks.shape[0]):
        active, site_d, site_u = _pick_sites(down, picks[t])
        theta_new = theta + 2.0 * (w[site_d] - w[site_u])
        lc_new = log_cosh(theta_new)
        d_log = 2.0 * (a[site_d] - a[site_u]) + torch.sum(lc_new - lc, -1)
        acc = active & (2.0 * d_log > log_u[t])
        theta = torch.where(acc[:, None], theta_new, theta)
        lc = torch.where(acc[:, None], lc_new, lc)
        down[rows, site_d] ^= acc
        down[rows, site_u] ^= acc
        accepted += acc
    new_configs = torch.where(down, -1.0, 1.0).to(torch.float32)
    return RbmSweepResult(new_configs, *_caches(w, b, a, new_configs),
                          accepted)


def _pick_sites(down: torch.Tensor, picks: torch.Tensor):
    """(active, down site, up site) of one step's rank picks [chains, 2]:
    the k_down-th down and the k_up-th up spin in site order; a rank past
    the chain's counts makes the step inactive (its sites are then 0)."""
    up = ~down
    rank_down = torch.cumsum(down, dim=1) - down.long()
    rank_up = torch.cumsum(up, dim=1) - up.long()
    hit_down = down & (rank_down == picks[:, 0:1])
    hit_up = up & (rank_up == picks[:, 1:2])
    active = hit_down.any(dim=1) & hit_up.any(dim=1)
    return (active, torch.argmax(hit_down.to(torch.uint8), dim=1),
            torch.argmax(hit_up.to(torch.uint8), dim=1))


# ---------------------------------------------------------------------------
# The lane-order witness: the kernels' decisions in their float32 order.

class _LaneLayout(NamedTuple):
    columns: torch.Tensor   # [chains, lanes · slots] int64 hidden unit
    present: torch.Tensor   # [chains, lanes, slots] bool: the slot holds one
    partners: tuple         # butterfly levels: [lanes] int64, lane ^ m


def _lane_layout(n_chains: int, hidden: int, lanes: int,
                 device) -> _LaneLayout:
    """Which hidden unit each slot of each lane holds in the kernels
    (csrc/rbm_sweep.cu): slot i of lane l of chain c holds unit
    G·((i + g) mod ⌈H/G⌉) + l, g = c mod (32/G) the chain's group in its
    warp.  The kernels' instance may carry more slots than ⌈H/G⌉; those,
    like a unit past H, add exactly +0.0 (a difference ln − lc is never
    −0.0), which leaves every sum as it was."""
    if lanes not in LANES:
        raise ValueError(f'lanes must be one of {LANES}, got {lanes}')
    n_slots = -(-hidden // lanes)
    slot = torch.arange(n_slots, device=device)
    lane = torch.arange(lanes, device=device)
    group = torch.arange(n_chains, device=device) % (32 // lanes)
    rotated = (slot[None, :] + group[:, None]) % n_slots      # [chains, S]
    columns = lanes * rotated[:, None, :] + lane[None, :, None]
    present = columns < hidden
    columns = torch.where(present, columns, 0)
    partners = tuple(lane ^ (lanes >> k)
                     for k in range(1, lanes.bit_length()))
    return _LaneLayout(columns.reshape(n_chains, -1), present, partners)


def _lane_sum(d: torch.Tensor, layout: _LaneLayout) -> torch.Tensor:
    """Σ_h d[c, h] as the kernels add it: each lane sums its slots in
    order from +0.0, then the butterfly adds v[l ^ m] to v[l] for m = G/2,
    …, 1 (every lane ends with the same value).  Elementwise adds only."""
    present = layout.present
    slots = torch.where(present, torch.gather(d, 1, layout.columns)
                        .view(present.shape), 0.0)
    part = torch.zeros(present.shape[:2], dtype=d.dtype, device=d.device)
    for i in range(present.shape[2]):
        part = part + slots[:, :, i]
    for partner in layout.partners:
        part = part + part[:, partner]
    return part[:, 0]


def lane_order_sum(d: torch.Tensor, lanes: int) -> torch.Tensor:
    """[chains] Σ_h of d [chains, H] float32 in the order of the sweep
    kernels on `lanes` lanes a chain."""
    return _lane_sum(d, _lane_layout(d.shape[0], d.shape[1], lanes,
                                     d.device))


def _lane_steps(w, a, down, theta, lc, accepted, picks, log_u, layout,
                margin):
    """len(picks) steps of the witness; flips `down` and counts into
    `accepted` in place, returns the carried (θ, logcosh θ)."""
    rows = torch.arange(down.shape[0], device=down.device)
    for t in range(picks.shape[0]):
        active, site_d, site_u = _pick_sites(down, picks[t])
        theta_new = theta + 2.0 * (w[site_d] - w[site_u])
        lc_new = log_cosh(theta_new)
        d_log = (2.0 * (a[site_d] - a[site_u])
                 + _lane_sum(lc_new - lc, layout))
        acc = active & (2.0 * d_log > log_u[t])
        if margin is not None:
            torch.minimum(margin, torch.where(
                active, (2.0 * d_log - log_u[t]).abs(), torch.inf),
                out=margin)
        theta = torch.where(acc[:, None], theta_new, theta)
        lc = torch.where(acc[:, None], lc_new, lc)
        down[rows, site_d] ^= acc
        down[rows, site_u] ^= acc
        accepted += acc
    return theta, lc


def rbm_sweeps_lanes_plain(w, b, a, configs, theta, picks, log_u,
                           lanes: int, margin=None) -> RbmSweepResult:
    """K1's lane-order witness: K1's decisions in K1's float32 operation
    order on `lanes` lanes a chain, in elementwise torch ops; any device.

    It differs from `rbm_sweeps_plain` in two ways only, both the kernel's:
    Σ_h is added per lane and then by a butterfly (`lane_order_sum`), and
    θ starts from the given `theta` (the wrapper's configs @ w + b) and is
    carried through the whole call.  On the card it equals K1 bit for bit
    in every output; it equals `rbm_sweeps_plain` wherever no decision
    lies within rounding of the accept threshold.

    `margin`, a [chains] float32 tensor on the configs' device, is lowered
    in place to each chain's least |2Δlogψ − log u| over its active
    proposals: how near its decisions came to the threshold."""
    down = configs < 0
    accepted = torch.zeros(configs.shape[0], dtype=torch.float32,
                           device=configs.device)
    layout = _lane_layout(configs.shape[0], w.shape[1], lanes,
                          configs.device)
    _lane_steps(w, a, down, theta, log_cosh(theta), accepted, picks, log_u,
                layout, margin)
    new_configs = torch.where(down, -1.0, 1.0).to(torch.float32)
    return RbmSweepResult(new_configs, *_caches(w, b, a, new_configs),
                          accepted)


def rbm_sweeps_reference(w, b, a, configs, picks, log_u) -> RbmSweepResult:
    """Full-recompute oracle with the same rank-pick semantics (JAX
    kernels.py:520-556): logψ of every proposal from scratch."""
    def log_psi(c):
        return c @ a + torch.sum(log_cosh(c @ w + b), dim=-1)

    accepted = torch.zeros(configs.shape[0], dtype=torch.float32,
                           device=configs.device)
    for t in range(picks.shape[0]):
        down = configs < 0
        up = ~down
        rank_down = torch.cumsum(down, dim=1) - down.long()
        rank_up = torch.cumsum(up, dim=1) - up.long()
        onehot_down = down & (rank_down == picks[t, :, 0:1])
        onehot_up = up & (rank_up == picks[t, :, 1:2])
        proposed = configs + 2.0 * (onehot_down.float() - onehot_up.float())
        d_log = log_psi(proposed) - log_psi(configs)
        active = onehot_down.any(dim=1) & onehot_up.any(dim=1)
        accept = active & (2.0 * d_log > log_u[t])
        configs = torch.where(accept[:, None], proposed, configs)
        accepted += accept
    return RbmSweepResult(configs, *_caches(w, b, a, configs), accepted)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64
    tensor x in [0, 2^32), without overflowing int64: m is split into
    16-bit halves so every partial product stays below 2^49."""
    p_hi = x * (m >> 16)
    p_lo = x * (m & 0xFFFF)
    mid = p_hi + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding unsigned 32-bit words.

    counter: 4 words, key: 2 words (tensors or ints, broadcastable).
    Returns the 4 output words, bitwise those of the CUDA kernel."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_draws(seed: torch.Tensor, first_step: int, n_steps: int,
                 n_chains: int, n_down: int, n_up: int):
    """K2's draws for steps [first_step, first_step + n_steps):
    (picks [n_steps, chains, 2] int32, log_u [n_steps, chains] float32).

    Words of Philox4x32-10 keyed by (seed, chain) at counter (step, 0, 0,
    0): ranks floor(u24·n) from words 0 and 1, log u = log(u24) from word
    2, with u24 = low 24 bits × 2⁻²⁴."""
    device = seed.device
    step = torch.arange(first_step, first_step + n_steps, device=device,
                        dtype=torch.int64)[:, None]
    chain = torch.arange(n_chains, device=device, dtype=torch.int64)[None]
    zero = torch.zeros_like(step)
    r0, r1, r2, _ = philox4x32_10((step, zero, zero, zero),
                                  (seed.reshape(()) & _MASK32, chain))
    k_down = ((r0 & 0xFFFFFF) * n_down) >> 24
    k_up = ((r1 & 0xFFFFFF) * n_up) >> 24
    log_u = torch.log((r2 & 0xFFFFFF).to(torch.float32) * 2.0 ** -24)
    return torch.stack([k_down, k_up], dim=-1).to(torch.int32), log_u


def rbm_sweeps_prng_plain(w, b, a, configs, n_steps: int,
                          seed: torch.Tensor) -> RbmSweepResult:
    """K2's plain version: K1's plain version fed K2's own Philox draws."""
    n_chains, n_sites = configs.shape
    n_down = n_sites // 2
    accepted = torch.zeros(n_chains, dtype=torch.float32,
                           device=configs.device)
    out = None
    for start in range(0, n_steps, _STEP_BLOCK):
        steps = min(_STEP_BLOCK, n_steps - start)
        picks, log_u = philox_draws(seed, start, steps, n_chains, n_down,
                                    n_sites - n_down)
        out = rbm_sweeps_plain(w, b, a, configs, picks, log_u)
        configs = out.configs
        accepted += out.num_accepted
    if out is None:
        return RbmSweepResult(configs, *_caches(w, b, a, configs), accepted)
    return out._replace(num_accepted=accepted)


def rbm_sweeps_prng_lanes_plain(w, b, a, configs, theta, n_steps: int,
                                seed: torch.Tensor, lanes: int,
                                margin=None) -> RbmSweepResult:
    """K2's lane-order witness: `rbm_sweeps_lanes_plain` fed K2's own
    Philox draws, θ carried across the draw blocks as the kernel carries
    it through the call."""
    n_chains, n_sites = configs.shape
    n_down = n_sites // 2
    down = configs < 0
    accepted = torch.zeros(n_chains, dtype=torch.float32,
                           device=configs.device)
    layout = _lane_layout(n_chains, w.shape[1], lanes, configs.device)
    lc = log_cosh(theta)
    for start in range(0, n_steps, _STEP_BLOCK):
        picks, log_u = philox_draws(seed, start,
                                    min(_STEP_BLOCK, n_steps - start),
                                    n_chains, n_down, n_sites - n_down)
        theta, lc = _lane_steps(w, a, down, theta, lc, accepted, picks,
                                log_u, layout, margin)
    new_configs = torch.where(down, -1.0, 1.0).to(torch.float32)
    return RbmSweepResult(new_configs, *_caches(w, b, a, new_configs),
                          accepted)


def sample_picks(generator: torch.Generator, num_steps: int, n_sites: int,
                 n_chains: int) -> torch.Tensor:
    """Per-chain (k_down, k_up) rank picks, [num_steps, n_chains, 2] int32.

    In the half-filled sector every configuration has n_sites//2 down and
    n_sites − n_sites//2 up spins, so a uniform rank is a uniform down/up
    site whatever the configuration."""
    device = generator.device
    n_down = n_sites // 2
    kd = torch.randint(0, n_down, (num_steps, n_chains), generator=generator,
                       device=device, dtype=torch.int32)
    ku = torch.randint(0, n_sites - n_down, (num_steps, n_chains),
                       generator=generator, device=device, dtype=torch.int32)
    return torch.stack([kd, ku], dim=-1)


# ---------------------------------------------------------------------------
# CUDA kernels.

def library() -> cuda_build.Library:
    """csrc/rbm_sweep.cu, built at first use."""
    return cuda_build.load('rbm_sweep', 'rbm_sweep.cu')


def build() -> None:
    """Builds and loads the kernels now instead of at their first launch."""
    library()


def kernel_resources() -> dict:
    """ptxas's registers and spills of every built kernel instance, keyed
    by (kernel 'K1' or 'K2', lanes a chain, bitmask words, unit slots a
    lane)."""
    out = {}
    for symbol, record in cuda_build.ptxas_report(library().path).items():
        m = re.search(r'rbm_sweep_kernelILi(\d+)ELi(\d+)ELi(\d+)E\w*?'
                      r'(StreamedDraws|PhiloxDraws)', symbol)
        if m:
            kernel = 'K1' if m.group(4) == 'StreamedDraws' else 'K2'
            out[(kernel, *map(int, m.group(1, 2, 3)))] = record
    return out


def instance(n_sites: int, hidden: int, lanes: int = 0) -> tuple:
    """(lanes a chain, bitmask words, unit slots a lane) of the kernel
    instance the launcher runs at this shape; lanes 0 asks for the fixed
    rule, which picks the lanes from H (csrc/rbm_sweep.cu,
    lanes_for_hidden)."""
    out = (ctypes.c_int * 3)()
    lib = library()
    lib.check(lib.call('rbm_sweep_instance', n_sites, hidden, lanes, out),
              f'rbm_sweep_instance({n_sites}, {hidden}, {lanes})')
    return tuple(out)


def log1p_mismatches(device) -> int:
    """The floats of [0, 1] on which the kernels' branch-free log1p differs
    in any bit from the CUDA math library's log1pf (0 when the kernels'
    logcosh is the plain version's), counted on `device`."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    library().launch('rbm_sweep_log1p_mismatches', count)
    return int(count.item())


def _check_lanes(lanes: int, hidden: int) -> None:
    if lanes == 0:
        return
    if lanes not in LANES:
        raise ValueError(f'lanes_per_chain must be 0 or one of {LANES}, got '
                         f'{lanes}')
    if -(-hidden // lanes) > MAX_UNITS_PER_LANE:
        raise ValueError(
            f'{lanes} lanes a chain would hold {-(-hidden // lanes)} hidden '
            f'units a lane; the kernels hold at most {MAX_UNITS_PER_LANE}')


def _check_inputs(w, b, a, configs) -> None:
    n_chains, n_sites = configs.shape
    hidden = w.shape[-1]
    expected = {'w': (w, (n_sites, hidden)), 'b': (b, (hidden,)),
                'a': (a, (n_sites,)), 'configs': (configs,
                                                  (n_chains, n_sites))}
    for name, (x, shape) in expected.items():
        if tuple(x.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(x.shape)}, expected '
                             f'{shape}')
        if x.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {x.dtype}')
        if x.device != configs.device:
            raise ValueError(f'{name} is on {x.device}, configs on '
                             f'{configs.device}')
    if configs.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {configs.device}')
    if configs.device.type == 'cuda':
        if not (2 <= n_sites <= MAX_SITES and 1 <= hidden <= MAX_HIDDEN):
            raise ValueError(
                f'the CUDA sweep kernels take 2 <= n_sites <= {MAX_SITES} '
                f'and 1 <= hidden <= {MAX_HIDDEN}; got n_sites={n_sites}, '
                f'hidden={hidden}')
        for name, x in (('w', w), ('a', a), ('configs', configs)):
            if not x.is_contiguous():
                raise ValueError(f'{name} must be contiguous')


def rbm_sweeps(w: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
               configs: torch.Tensor, picks: torch.Tensor,
               log_u: torch.Tensor) -> RbmSweepResult:
    """K1: len(picks) fused per-chain exchange steps with streamed draws.

    Replaces the TPU kernel cgs_vmc_tpu/sampler/kernels.py::_sweep_kernel
    (driven by rbm_sweeps there, which drew log_u from a key itself).

    Args:
      w: [n_sites, hidden] RBM kernel.  b: [hidden] hidden bias.
      a: [n_sites] visible (on-site) bias.
      configs: [chains, n_sites] ±1 float32.
      picks: [n_steps, chains, 2] int32 (k_down, k_up) rank picks.
      log_u: [n_steps, chains] float32 log acceptance uniforms.

    Launches on the current CUDA stream and does not synchronise.
    """
    return _rbm_sweeps(w, b, a, configs, picks, log_u, 0)


def _rbm_sweeps(w, b, a, configs, picks, log_u,
                lanes: int) -> RbmSweepResult:
    """K1 on `lanes` lanes a chain (0: the kernels' rule)."""
    _check_inputs(w, b, a, configs)
    _check_lanes(lanes, w.shape[-1])
    n_chains, n_sites = configs.shape
    n_steps = picks.shape[0]
    if (tuple(picks.shape) != (n_steps, n_chains, 2)
            or picks.dtype != torch.int32):
        raise ValueError(f'picks must be int32 [n_steps, {n_chains}, 2], '
                         f'got {picks.dtype} {tuple(picks.shape)}')
    if (tuple(log_u.shape) != (n_steps, n_chains)
            or log_u.dtype != torch.float32):
        raise ValueError(f'log_u must be float32 [{n_steps}, {n_chains}], '
                         f'got {log_u.dtype} {tuple(log_u.shape)}')
    if configs.device.type == 'cpu':
        return rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    for name, x in (('picks', picks), ('log_u', log_u)):
        if x.device != configs.device or not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous on {configs.device}')
    theta = configs @ w + b
    configs_out = torch.empty_like(configs)
    accepted = torch.empty(n_chains, dtype=torch.float32,
                           device=configs.device)
    library().launch('rbm_sweeps_streamed_f32', configs, theta, w, a, picks,
                     log_u, configs_out, accepted, n_chains, n_sites,
                     w.shape[1], n_steps, lanes, counter='k1.launches')
    return RbmSweepResult(configs_out, *_caches(w, b, a, configs_out),
                          accepted)


def rbm_sweeps_prng(w: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
                    configs: torch.Tensor, n_steps: int,
                    seed: Union[int, torch.Tensor]) -> RbmSweepResult:
    """K2: `rbm_sweeps` with every draw made in the kernel (half-filled
    sector only).

    Replaces the TPU kernel
    cgs_vmc_tpu/sampler/kernels.py::_sweep_kernel_prng (driven by
    rbm_sweeps_prng there).  `seed` is an int or a one-element int64 tensor
    on the configs' device (its low 32 bits key Philox); vary it per call.
    A device tensor seed lets the caller draw it without a host sync.
    """
    return _rbm_sweeps_prng(w, b, a, configs, n_steps, seed, 0)


def _rbm_sweeps_prng(w, b, a, configs, n_steps: int, seed,
                     lanes: int) -> RbmSweepResult:
    """K2 on `lanes` lanes a chain (0: the kernels' rule)."""
    _check_inputs(w, b, a, configs)
    _check_lanes(lanes, w.shape[-1])
    n_chains, n_sites = configs.shape
    if n_sites % 2:
        raise ValueError('rbm_sweeps_prng requires the half-filled sector '
                         f'(even n_sites); got n_sites={n_sites}')
    if n_steps < 0:
        raise ValueError(f'n_steps must be >= 0, got {n_steps}')
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([int(seed) & _MASK32], dtype=torch.int64,
                            device=configs.device)
    if (seed.dtype != torch.int64 or seed.numel() != 1
            or seed.device != configs.device):
        raise ValueError('seed must be an int or a one-element int64 '
                         f'tensor on {configs.device}')
    if configs.device.type == 'cpu':
        return rbm_sweeps_prng_plain(w, b, a, configs, n_steps, seed)
    n_down = n_sites // 2
    theta = configs @ w + b
    configs_out = torch.empty_like(configs)
    accepted = torch.empty(n_chains, dtype=torch.float32,
                           device=configs.device)
    library().launch('rbm_sweeps_philox_f32', configs, theta, w, a,
                     seed.reshape(1).contiguous(), n_down, n_sites - n_down,
                     configs_out, accepted, n_chains, n_sites, w.shape[1],
                     n_steps, lanes, counter='k2.launches')
    return RbmSweepResult(configs_out, *_caches(w, b, a, configs_out),
                          accepted)
