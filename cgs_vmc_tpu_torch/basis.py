"""Sz-sector basis utilities (port of cgs_vmc_tpu/basis.py).

Random fixed-Sz configurations on a device, full-basis enumeration, and the
Lin-table index scheme (Lin, H.Q. 1990).  Enumeration and the Lin tables
are host numpy and match the JAX package exactly; random configurations
come from a torch.Generator and are held by their invariants only.
"""

from __future__ import annotations

import itertools
from math import comb

import numpy as np
import torch


def random_configurations(generator: torch.Generator, n_sites: int,
                          batch_size: int, n_down: int | None = None
                          ) -> torch.Tensor:
    """Random spin configurations in a fixed-Sz sector, values ±1, float32,
    on the generator's device: an independent random permutation of an
    (n_sites − n_down)-up / n_down-down template per chain.  The default
    sector is Sz=0 (n_down = n_sites // 2)."""
    if n_down is None:
        n_down = n_sites // 2
    if not 0 <= n_down <= n_sites:
        raise ValueError(f'n_down must be in [0, {n_sites}], got {n_down}')
    device = generator.device
    template = torch.ones(n_sites, dtype=torch.float32, device=device)
    template[n_sites - n_down:] = -1.0
    keys = torch.rand((batch_size, n_sites), generator=generator,
                      device=device)
    return template[torch.argsort(keys, dim=1)]


def n_down_for(n_sites: int, total_sz2: int) -> int:
    """Number of down spins for a total-Sz sector given 2·Sz_total."""
    if (n_sites + total_sz2) % 2 != 0 or abs(total_sz2) > n_sites:
        raise ValueError(
            f'total_sz2={total_sz2} is not a valid sector for '
            f'{n_sites} sites: n_up = (n_sites + total_sz2)/2 must be an '
            'integer in [0, n_sites]')
    return (n_sites - total_sz2) // 2


def random_spin_configurations(generator: torch.Generator, n_sites: int,
                               batch_size: int) -> torch.Tensor:
    """Uniformly random ±1 configurations over the full 2^N space."""
    bits = torch.randint(0, 2, (batch_size, n_sites), generator=generator,
                         device=generator.device)
    return (2.0 * bits - 1.0).to(torch.float32)


def enumerate_sz_basis(n_sites: int, n_down: int | None = None) -> np.ndarray:
    """Every configuration of a fixed-Sz sector as ±1 rows, float32,
    lexicographic in down-spin positions (the JAX package's order)."""
    if n_down is None:
        n_down = n_sites // 2
    out = np.ones((comb(n_sites, n_down), n_sites), dtype=np.float32)
    for row, downs in enumerate(itertools.combinations(range(n_sites),
                                                       n_down)):
        out[row, list(downs)] = -1.0
    return out


def enumerate_full_basis(n_sites: int) -> np.ndarray:
    """Every configuration of the full 2^N space as ±1 rows, float32.

    Row index r encodes the configuration bitwise: site k holds +1 iff bit
    k of r is set (LSB = site 0), the ordering `utils.ed.ising_matrix`
    uses, so amplitude vectors line up without an index map."""
    r = np.arange(2 ** n_sites, dtype=np.int64)
    bits = (r[:, None] >> np.arange(n_sites)[None, :]) & 1
    return (2.0 * bits - 1.0).astype(np.float32)


def save_basis_file(path: str, basis_pm1: np.ndarray) -> None:
    """Writes ±1 configurations as a basis file in the reference's 0/1
    space-separated format, one configuration a row (what
    `load_basis_file` reads)."""
    zeros_ones = ((np.asarray(basis_pm1) + 1) / 2).astype(np.int64)
    np.savetxt(path, zeros_ones, fmt='%d')


def load_basis_file(path: str) -> np.ndarray:
    """Reads a basis file in the reference's 0/1 space-separated format (one
    configuration a row) and returns ±1 float32 configurations."""
    data = np.atleast_2d(np.genfromtxt(path, dtype=np.float32))
    return (data * 2.0 - 1.0).astype(np.float32)


def config_basis(config) -> np.ndarray:
    """The configurations of config.basis_file_path if it is set, else the
    whole total_sz2 sector in `enumerate_sz_basis` order."""
    if config.basis_file_path:
        return load_basis_file(config.basis_file_path)
    return enumerate_sz_basis(
        config.num_sites,
        n_down_for(config.num_sites, getattr(config, 'total_sz2', 0)))


def _popcount_table(n_bits: int) -> np.ndarray:
    return np.array([bin(i).count('1') for i in range(2 ** n_bits)],
                    dtype=np.int64)


def make_lin_tables(n_sites: int, n_up: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(top_table, bot_table) for the fixed-Sz sector: the dense index of a
    configuration is top_table[top_bits] + bot_table[bot_bits], with the
    "bot" half sites [0, n/2) and up spins as set bits (see the JAX
    package's make_lin_tables for the full convention)."""
    bot_len = n_sites // 2
    top_len = n_sites - bot_len
    if n_up is None:
        n_up = n_sites - n_sites // 2
    pop_bot = _popcount_table(bot_len)
    pop_top = _popcount_table(top_len)

    bot_table = np.zeros(2 ** bot_len, dtype=np.int64)
    counters: dict[int, int] = {}
    for w in range(2 ** bot_len):
        k = int(pop_bot[w])
        bot_table[w] = counters.get(k, 0)
        counters[k] = counters.get(k, 0) + 1

    top_table = np.zeros(2 ** top_len, dtype=np.int64)
    offset = 0
    for t in range(2 ** top_len):
        k_b = n_up - int(pop_top[t])
        stride = comb(bot_len, k_b) if 0 <= k_b <= bot_len else 0
        if stride > 0:
            top_table[t] = offset
            offset += stride
    return top_table, bot_table


def lin_index(configs: torch.Tensor, top_table, bot_table) -> torch.Tensor:
    """Maps ±1 configs [batch, n_sites] to dense sector indices [batch].

    The tables may be numpy arrays (copied to the configs' device on every
    call) or int64 tensors already on that device (used as they are: no
    copy, no host sync), which is what a caller on the card should hold."""
    n_sites = configs.shape[-1]
    bot_len = n_sites // 2
    device = configs.device
    weights = 2 ** torch.arange(n_sites - bot_len, device=device)
    ups = (configs > 0).to(torch.int64)
    bot_bits = torch.sum(ups[..., :bot_len] * weights[:bot_len], dim=-1)
    top_bits = torch.sum(ups[..., bot_len:] * weights, dim=-1)
    return (torch.as_tensor(top_table, device=device)[top_bits]
            + torch.as_tensor(bot_table, device=device)[bot_bits])
