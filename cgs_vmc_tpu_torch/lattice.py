"""Lattice geometry: bond lists and couplings (the port's own copy of the
part of cgs_vmc_tpu/lattice.py that building a Hamiltonian reaches).

Every bond builder `bonds_and_couplings_for_config` dispatches to, the bond
file loaders and `j1j2_marshall_gauged`, unchanged, so both packages build
the same bonds from the same config (tests/test_torch_config_lattice.py);
`twist_phases` (twisted boundaries), the adjacency helpers of the graph
ansatz, and `displacement_pairs` / `marshall_sublattice` (the pair sets and
the gauge signs of the observables) likewise.

The reference represented a lattice only implicitly: a Python list of
(i, j) bond tuples read from ``J.txt`` or defaulting to a 1-D periodic
chain (cgs_vmc/run_training.py:103-109).  Here bonds are a static
``[n_bonds, 2]`` int32 array so the Heisenberg local-energy kernel can
generate every spin-exchanged configuration in one vectorized shot
(see ops/heisenberg.py).
"""

from __future__ import annotations

import numpy as np


def chain_bonds(n_sites: int, periodic: bool = True) -> np.ndarray:
    """Nearest-neighbour bonds of a 1-D chain.

    Matches the reference default ``[(i, (i+1) % n) for i in range(n)]``
    (cgs_vmc/run_training.py:109), which double-counts nothing but does
    include the wrap bond (n-1, 0) when periodic.
    """
    if periodic:
        bonds = [(i, (i + 1) % n_sites) for i in range(n_sites)]
    else:
        bonds = [(i, i + 1) for i in range(n_sites - 1)]
    return np.asarray(bonds, dtype=np.int32)


def square_lattice_bonds(
    size_x: int, size_y: int, periodic: bool = True
) -> np.ndarray:
    """Nearest-neighbour bonds of a size_x × size_y square lattice.

    Site index convention: site = x * size_y + y (row-major in x), which
    matches the reshape used by the 2-D conv ansatzes
    (cgs_vmc/wavefunctions.py:593-594 reshapes flat configs to
    [-1, size_x, size_y, 1]).
    """
    def site(x: int, y: int) -> int:
        return (x % size_x) * size_y + (y % size_y)

    bonds = []
    seen = set()
    for x in range(size_x):
        for y in range(size_y):
            if periodic or x + 1 < size_x:
                bonds.append((site(x, y), site(x + 1, y)))
            if periodic or y + 1 < size_y:
                bonds.append((site(x, y), site(x, y + 1)))
    # Deduplicate unordered pairs (an L=2 periodic direction would emit the
    # same physical bond twice) and drop self-loops (L=1 direction).
    unique = []
    for i, j in bonds:
        key = (min(i, j), max(i, j))
        if i == j or key in seen:
            continue
        seen.add(key)
        unique.append((i, j))
    return np.asarray(unique, dtype=np.int32)


def triangular_lattice_bonds(size_x: int, size_y: int,
                             periodic: bool = True) -> np.ndarray:
    """Nearest-neighbour bonds of a triangular lattice on a rhombic
    size_x × size_y torus (site = x*size_y + y, same convention as
    square_lattice_bonds): +x, +y and +x+y neighbours — 3 bonds/site,
    coordination 6.  Geometrically frustrated for antiferromagnetic
    couplings (no bipartition, no Marshall gauge) — the physical regime
    for the complex-phase ansatzes.  Beyond the reference, whose built-in
    geometry is the 1-D chain (cgs_vmc/run_training.py:103-109)."""
    def site(x: int, y: int) -> int:
        return (x % size_x) * size_y + (y % size_y)

    bonds, seen = [], set()
    for x in range(size_x):
        for y in range(size_y):
            steps = []
            if periodic or x + 1 < size_x:
                steps.append((x + 1, y))
            if periodic or y + 1 < size_y:
                steps.append((x, y + 1))
            if periodic or (x + 1 < size_x and y + 1 < size_y):
                steps.append((x + 1, y + 1))
            for nx_, ny_ in steps:
                i, j = site(x, y), site(nx_, ny_)
                key = (min(i, j), max(i, j))
                if i == j or key in seen:
                    continue
                seen.add(key)
                bonds.append((i, j))
    return np.asarray(bonds, dtype=np.int32)


def honeycomb_lattice_bonds(size_x: int, size_y: int,
                            periodic: bool = True) -> np.ndarray:
    """Nearest-neighbour bonds of a honeycomb lattice: size_x × size_y
    rhombic cells of the triangular Bravais lattice with a 2-site (A, B)
    basis; site = (x*size_y + y)*2 + s, so num_sites = 2*size_x*size_y.
    Each A bonds to B in cells (x, y), (x-1, y), (x, y-1) — coordination
    3, BIPARTITE (every bond joins A to B, i.e. even to odd site index,
    so `marshall_sublattice`'s parity fallback is the correct mask and
    training with heisenberg_jx = -1 applies the Marshall gauge exactly
    as on the square lattice).  Beyond the reference, whose built-in
    geometry is the 1-D chain (cgs_vmc/run_training.py:103-109).

    Width-1/2 tori wrap two cell directions onto the same neighbour;
    duplicate pairs are emitted once (same convention as
    `triangular_lattice_bonds`)."""
    def site(x: int, y: int, s: int) -> int:
        return ((x % size_x) * size_y + (y % size_y)) * 2 + s

    bonds, seen = [], set()
    for x in range(size_x):
        for y in range(size_y):
            a = site(x, y, 0)
            cells = [(x, y)]
            if periodic or x > 0:
                cells.append((x - 1, y))
            if periodic or y > 0:
                cells.append((x, y - 1))
            for cx, cy in cells:
                b = site(cx, cy, 1)
                key = (min(a, b), max(a, b))
                if key in seen:
                    continue
                seen.add(key)
                bonds.append((a, b))
    return np.asarray(bonds, dtype=np.int32)


def kagome_lattice_bonds(size_x: int, size_y: int,
                         periodic: bool = True) -> np.ndarray:
    """Nearest-neighbour bonds of a kagome lattice: size_x × size_y
    rhombic cells of the triangular Bravais lattice with a 3-site
    (A, B, C) basis; site = (x*size_y + y)*3 + s, so
    num_sites = 3*size_x*size_y.  Bonds are the corner-sharing
    triangles: the up triangle (A-B, B-C, C-A in-cell) and the down
    triangle (B(x,y)-A(x+1,y), C(x,y)-A(x,y+1), B(x,y)-C(x+1,y-1)) —
    coordination 4, geometrically frustrated (odd cycles, no
    bipartition), the canonical quantum-spin-liquid candidate geometry.
    Beyond the reference (built-in geometry: the 1-D chain,
    cgs_vmc/run_training.py:103-109).

    Width-1/2 tori wrap duplicate pairs; emitted once (same convention
    as `triangular_lattice_bonds`)."""
    def site(x: int, y: int, s: int) -> int:
        return ((x % size_x) * size_y + (y % size_y)) * 3 + s

    bonds, seen = [], set()
    for x in range(size_x):
        for y in range(size_y):
            a, b, c = site(x, y, 0), site(x, y, 1), site(x, y, 2)
            pairs = [(a, b), (b, c), (c, a)]
            if periodic or x + 1 < size_x:
                pairs.append((b, site(x + 1, y, 0)))
            if periodic or y + 1 < size_y:
                pairs.append((c, site(x, y + 1, 0)))
            if periodic or (x + 1 < size_x and y > 0):
                pairs.append((b, site(x + 1, y - 1, 2)))
            for i, j in pairs:
                key = (min(i, j), max(i, j))
                if i == j or key in seen:
                    continue
                seen.add(key)
                bonds.append((i, j))
    return np.asarray(bonds, dtype=np.int32)


def j1j2_chain_bonds(n_sites: int, periodic: bool = True
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Bonds of the J1–J2 chain: (bonds, j2_mask) where j2_mask is 1.0 on
    next-nearest-neighbour bonds and 0.0 on nearest-neighbour bonds.
    Per-bond couplings are then ``(1 - mask) + j2 * mask``."""
    nn = chain_bonds(n_sites, periodic)
    if periodic:
        nnn, seen = [], set()
        for i in range(n_sites):
            j = (i + 2) % n_sites
            key = (min(i, j), max(i, j))
            # Dedup unordered pairs: an n=4 periodic chain emits each NNN
            # bond twice ((0,2)/(2,0)), which would silently double J2.
            if i == j or key in seen:
                continue
            seen.add(key)
            nnn.append((i, j))
    else:
        nnn = [(i, i + 2) for i in range(n_sites - 2)]
    bonds = np.concatenate([nn, np.asarray(nnn, np.int32)], axis=0)
    mask = np.concatenate([np.zeros(len(nn)), np.ones(len(nnn))])
    return bonds.astype(np.int32), mask.astype(np.float64)


def j1j2_square_bonds(size_x: int, size_y: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """J1–J2 square lattice: nearest-neighbour bonds plus the two diagonal
    next-nearest neighbours per plaquette (periodic).  Returns
    (bonds, j2_mask) as in `j1j2_chain_bonds`."""
    nn = square_lattice_bonds(size_x, size_y)

    def site(x: int, y: int) -> int:
        return (x % size_x) * size_y + (y % size_y)

    diag, seen = [], set()
    for x in range(size_x):
        for y in range(size_y):
            for (dx, dy) in ((1, 1), (1, -1)):
                i, j = site(x, y), site(x + dx, y + dy)
                key = (min(i, j), max(i, j))
                if i == j or key in seen:
                    continue
                seen.add(key)
                diag.append((i, j))
    bonds = np.concatenate([nn, np.asarray(diag, np.int32)], axis=0)
    mask = np.concatenate([np.zeros(len(nn)), np.ones(len(diag))])
    return bonds.astype(np.int32), mask.astype(np.float64)


def load_bonds(path: str) -> np.ndarray:
    """Loads a bond list from a whitespace-separated file of ``i j`` rows.

    Same format as the reference's ``J.txt`` (cgs_vmc/run_training.py:105-107:
    ``np.genfromtxt(path, dtype=int)`` then first two columns per row).
    """
    data = np.genfromtxt(path, dtype=np.float64)
    data = np.atleast_2d(data)
    return data[:, :2].astype(np.int32)


def load_bonds_and_couplings(path: str
                             ) -> tuple[np.ndarray, np.ndarray | None]:
    """Loads ``i j [J_ij]`` rows: the reference's two-column J.txt format,
    extended with an optional per-bond coupling third column (None when
    the file has no coupling column)."""
    data = np.atleast_2d(np.genfromtxt(path, dtype=np.float64))
    bonds = data[:, :2].astype(np.int32)
    couplings = data[:, 2].copy() if data.shape[1] >= 3 else None
    return bonds, couplings


def bonds_for_config(config) -> np.ndarray:
    """Resolves the bond list for a run configuration (couplings dropped —
    use `bonds_and_couplings_for_config` for J1–J2 / weighted lattices)."""
    return bonds_and_couplings_for_config(config)[0]


def bonds_and_couplings_for_config(config
                                   ) -> tuple[np.ndarray, np.ndarray | None]:
    """Resolves (bonds, per-bond couplings | None) for a run configuration.

    Priority: explicit J-file (optional coupling column) > explicit
    ``lattice_type`` ('triangular') > J1–J2 lattice when
    ``heisenberg_j2 != 0`` (chain or square by geometry) > 2-D square
    lattice (size_x*size_y == num_sites, both > 1) > 1-D periodic chain
    (the reference fallback, cgs_vmc/run_training.py:103-109).
    """
    if config.j_file_path:
        return load_bonds_and_couplings(config.j_file_path)
    lattice_type = getattr(config, 'lattice_type', '')
    if lattice_type == 'triangular':
        if (config.size_x <= 1 or config.size_y <= 1
                or config.size_x * config.size_y != config.num_sites):
            raise ValueError('triangular lattice requires size_x, size_y '
                             '> 1 with size_x*size_y == num_sites')
        if getattr(config, 'heisenberg_j2', 0.0):
            raise ValueError(
                'heisenberg_j2 is not supported on the triangular lattice '
                '(the built-in J1-J2 generators are chain/square); supply '
                'an explicit bonds-and-couplings file via j_file_path')
        return triangular_lattice_bonds(config.size_x, config.size_y), None
    if lattice_type == 'honeycomb':
        if (config.size_x < 1 or config.size_y < 1
                or 2 * config.size_x * config.size_y != config.num_sites):
            raise ValueError('honeycomb lattice requires num_sites == '
                             '2 * size_x * size_y (size_x x size_y cells '
                             'of a 2-site basis)')
        if getattr(config, 'heisenberg_j2', 0.0):
            raise ValueError(
                'heisenberg_j2 is not supported on the honeycomb lattice '
                '(the built-in J1-J2 generators are chain/square); supply '
                'an explicit bonds-and-couplings file via j_file_path')
        return honeycomb_lattice_bonds(config.size_x, config.size_y), None
    if lattice_type == 'kagome':
        if (config.size_x < 1 or config.size_y < 1
                or 3 * config.size_x * config.size_y != config.num_sites):
            raise ValueError('kagome lattice requires num_sites == '
                             '3 * size_x * size_y (size_x x size_y cells '
                             'of a 3-site basis)')
        if getattr(config, 'heisenberg_j2', 0.0):
            raise ValueError(
                'heisenberg_j2 is not supported on the kagome lattice '
                '(the built-in J1-J2 generators are chain/square); supply '
                'an explicit bonds-and-couplings file via j_file_path')
        return kagome_lattice_bonds(config.size_x, config.size_y), None
    if lattice_type and lattice_type not in ('', 'auto'):
        raise ValueError(
            f'unknown lattice_type {lattice_type!r}; known: '
            "'', 'auto', 'triangular', 'honeycomb', 'kagome'")
    is_square = (config.size_x > 1 and config.size_y > 1
                 and config.size_x * config.size_y == config.num_sites)
    j2 = getattr(config, 'heisenberg_j2', 0.0)
    if j2:
        if is_square:
            bonds, mask = j1j2_square_bonds(config.size_x, config.size_y)
        else:
            bonds, mask = j1j2_chain_bonds(config.num_sites)
        return bonds, (1.0 - mask) + j2 * mask
    if is_square:
        return square_lattice_bonds(config.size_x, config.size_y), None
    return chain_bonds(config.num_sites), None


def j1j2_marshall_gauged(config) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bonds, couplings, offdiag_couplings) for the Marshall-gauged
    J1–J2 lattice implied by the config (chain or square by geometry).

    Rotating every sublattice-A spin by pi about z flips the exchange
    sign on J1 bonds (they connect the two sublattices) and leaves J2
    bonds (same sublattice) unchanged: diagonal couplings (J1, J2),
    off-diagonal (−J1, +J2) with a global ``heisenberg_jx=+1``.  The
    spectrum is gauge-invariant (tests/test_j1j2.py) but the ground
    state is near-positive at small-to-moderate J2/J1, which positive or
    phase-augmented ansatzes represent far more easily — the J1–J2
    generalization of the reference's bipartite jx=−1 Marshall trick
    (cgs_vmc/run_training.py:118: MARSHALL_SIGN => J=-1).
    """
    is_square = (config.size_x > 1 and config.size_y > 1
                 and config.size_x * config.size_y == config.num_sites)
    j2 = getattr(config, 'heisenberg_j2', 0.0)
    if is_square:
        bonds, mask = j1j2_square_bonds(config.size_x, config.size_y)
    else:
        bonds, mask = j1j2_chain_bonds(config.num_sites)
    j1 = 1.0 - mask
    return bonds, j1 + j2 * mask, -j1 + j2 * mask


def displacement_pairs(num_sites: int, size_x: int, size_y: int,
                       dx: int, dy: int = 0) -> np.ndarray:
    """All (i, i+Δ) site pairs at lattice displacement Δ (periodic).

    On a square lattice (size_x·size_y == num_sites, both > 1) the
    displacement is the 2-vector (dx, dy) in the site convention
    site = x * size_y + y (see `square_lattice_bonds`); on a chain it is
    the scalar offset dx.  One pair per site, [num_sites, 2] int32 — the
    translation-averaged correlator estimator C(Δ) = (1/N) Σᵢ ⟨S_i S_{i+Δ}⟩.
    """
    if size_x > 1 and size_y > 1 and size_x * size_y == num_sites:
        def site(x: int, y: int) -> int:
            return (x % size_x) * size_y + (y % size_y)
        pairs = [(site(x, y), site(x + dx, y + dy))
                 for x in range(size_x) for y in range(size_y)]
    else:
        pairs = [(i, (i + dx) % num_sites) for i in range(num_sites)]
    return np.asarray(pairs, dtype=np.int32)


def marshall_sublattice(num_sites: int, size_x: int = 1, size_y: int = 1
                        ) -> np.ndarray:
    """The ±1 sublattice mask of the Marshall sign rule: +1 on sublattice
    A, -1 on B (checkerboard on a square lattice, alternating on a chain).

    A state trained with ``heisenberg_jx = -1`` on a bipartite lattice is
    the ground state in the Marshall gauge U = Π_B σᶻ; observables that do
    not commute with U are corrected with these signs.
    """
    if size_x > 1 and size_y > 1 and size_x * size_y == num_sites:
        x = np.arange(num_sites) // size_y
        y = np.arange(num_sites) % size_y
        return np.where((x + y) % 2 == 0, 1, -1).astype(np.int32)
    return np.where(np.arange(num_sites) % 2 == 0, 1, -1).astype(np.int32)


def load_adjacency(path: str) -> np.ndarray:
    """Loads a ``[n_sites, num_neighbors]`` adjacency list (int) from file.

    Format matches the reference's graph-conv input
    (cgs_vmc/utils.py:51-55, cgs_vmc/wavefunctions.py:1148).
    """
    adj = np.genfromtxt(path, dtype=np.int64)
    return np.atleast_2d(adj).astype(np.int32)


def adjacency_from_bonds(bonds: np.ndarray, num_sites: int) -> np.ndarray:
    """Builds a fixed-width adjacency list from a bond list.

    Utility for graph-conv ansatzes when no adjacency file is given; pads
    ragged neighbour lists by repeating the site's own index (self-loop),
    keeping the table rectangular.
    """
    neigh = [[] for _ in range(num_sites)]
    for i, j in np.asarray(bonds):
        neigh[int(i)].append(int(j))
        neigh[int(j)].append(int(i))
    width = max(len(x) for x in neigh)
    out = np.zeros((num_sites, width), dtype=np.int32)
    for s in range(num_sites):
        row = neigh[s] or [s]
        while len(row) < width:
            row.append(s)
        out[s] = row[:width]
    return out


def twist_phases(num_sites: int, bonds: np.ndarray, phi: float,
                 size_x: int, size_y: int = 1,
                 direction: str = 'x') -> np.ndarray:
    """Per-bond gauge phases for a uniform boundary twist of total angle phi.

    Twisted boundary conditions measure the spin stiffness (superfluid
    density analog): rho_s = L_dir^2/N * d^2(E(phi)/N)/dphi^2 at phi=0.
    Each bond carries delta_b = phi * d_b / L_dir where d_b is the
    MINIMAL-IMAGE displacement of the bond along the twist direction —
    the uniform gauge, so every directed loop winding the torus once
    accumulates exactly phi (a telescoping raw-coordinate difference
    would be pure gauge and twist nothing).  Feed the result to
    ``HeisenbergHamiltonian(twist_phases=...)`` /
    ``utils.ed.heisenberg_matrix(twist_phases=...)``.

    Site index convention matches square_lattice_bonds: site = x*size_y+y
    (size_y=1 covers chains).  Works for any bond list over that indexing
    (nearest-neighbour, J1-J2 diagonals, custom J-files).
    """
    bonds = np.asarray(bonds)
    if direction not in ('x', 'y'):
        raise ValueError(f"direction must be 'x' or 'y', got {direction!r}")
    coord = (bonds // size_y) if direction == 'x' else (bonds % size_y)
    length = size_x if direction == 'x' else size_y
    d = (coord[:, 1] - coord[:, 0]).astype(np.float64)
    d -= length * np.round(d / length)          # minimal image
    return (phi / length) * d
