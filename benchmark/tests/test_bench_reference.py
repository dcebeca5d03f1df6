"""The plain reference's J1–J2 couplings and complex log ψ on the CPU:
the local energy of an exact ground state is E0 on every board, the
stacked complex SR step is the parameter-space solve, the cache gap
reads a phase modulo 2π, the operation counts of the complex composite,
and the reference's log ψ, local energy and SR step of that composite
against the port's on the J1–J2 chain and torus.

The ground states come from a Hamiltonian built here from site
coordinates, independently of ``reference/lattice.py``."""

import functools
import json
import math

import numpy as np
import pytest
import scipy.sparse
import scipy.sparse.linalg
import torch

from benchmark.harness import check, program, spec
from benchmark.reference import energy, lattice, models, steps

BENCH = spec.load_benchmark()
CHAIN8 = json.loads((spec.ROOT / 'configs'
                     / 'j1j2_chain8_complex_sr.json').read_text())
TORUS44 = dict(CHAIN8, num_sites=16, size_x=4, size_y=4)


def _coordinate_bonds(cfg):
    """{(i, j): J} of the J1–J2 model from each site's neighbours."""
    n = cfg['num_sites']
    if cfg['size_x'] > 1:
        lx, ly = cfg['size_x'], cfg['size_y']

        def site(x, y):
            return (x % lx) * ly + y % ly
        shells = {1.0: [(1, 0), (0, 1)],
                  cfg['heisenberg_j2']: [(1, 1), (1, -1)]}
        pairs = [(site(x, y), site(x + dx, y + dy), j)
                 for j, steps_ in shells.items() for dx, dy in steps_
                 for x in range(lx) for y in range(ly)]
    else:
        pairs = [(i, (i + d) % n, j) for d, j in
                 ((1, 1.0), (2, cfg['heisenberg_j2'])) for i in range(n)]
    return {(min(i, j), max(i, j)): c for i, j, c in pairs}


def _sector(n):
    """The Sz = 0 boards as ±1 rows and their indices by bits."""
    codes = [c for c in range(2 ** n) if bin(c).count('1') == n // 2]
    boards = np.array([[1.0 if c >> k & 1 else -1.0 for k in range(n)]
                       for c in codes])
    return boards, {c: i for i, c in enumerate(codes)}, codes


@functools.lru_cache(maxsize=None)
def _ground_state(name):
    """(E0, v, boards) of the J1–J2 Heisenberg model, S·S per bond, on
    the Sz = 0 sector: dense for the chain, Lanczos for the torus."""
    cfg = {'chain8': CHAIN8, 'torus44': TORUS44}[name]
    n = cfg['num_sites']
    boards, index, codes = _sector(n)
    rows, cols, vals = [], [], []
    for a, code in enumerate(codes):
        diagonal = 0.0
        for (i, j), c in _coordinate_bonds(cfg).items():
            if (code >> i & 1) == (code >> j & 1):
                diagonal += 0.25 * c
            else:
                diagonal -= 0.25 * c
                rows.append(a)
                cols.append(index[code ^ (1 << i) ^ (1 << j)])
                vals.append(0.5 * c)
        rows.append(a)
        cols.append(a)
        vals.append(diagonal)
    h = scipy.sparse.csr_matrix((vals, (rows, cols)),
                                shape=(len(codes),) * 2)
    if len(codes) < 100:
        e, v = np.linalg.eigh(h.toarray())
        return e[0], v[:, 0], boards
    e, v = scipy.sparse.linalg.eigsh(h, k=1, which='SA', tol=0.0,
                                     ncv=40, v0=np.ones(len(codes)))
    return e[0], v[:, 0], boards


def _lookup_log_psi(v, boards, gauge):
    """log ψ(s) = log|v_s| + iπ·[v_s < 0] by a table over the boards'
    bits; with `gauge` the Marshall-rotated state (one sublattice's
    spins turned by π about z: v_s · Π_A s_i)."""
    n = boards.shape[1]
    weights = 2 ** torch.arange(n)
    codes = ((torch.as_tensor(boards) > 0).long() * weights).sum(-1)
    if gauge:
        v = v * np.prod(boards[:, _sublattice_a(n, boards)], axis=1)
    log = torch.complex(torch.as_tensor(np.log(np.abs(v) + 1e-300)),
                        torch.as_tensor(np.pi * (v < 0)))
    table = torch.zeros(2 ** n, dtype=torch.complex128)
    table[codes] = log

    def log_psi(p, s):
        return table[((s > 0).long() * weights).sum(-1)]
    return log_psi, np.abs(v)


def _sublattice_a(n, boards):
    side = int(round(math.sqrt(n)))
    if side * side == n and n > 8:
        x, y = np.arange(n) // side, np.arange(n) % side
        return (x + y) % 2 == 0
    return np.arange(n) % 2 == 0


@pytest.mark.parametrize('gauge', [False, True], ids=['plain', 'marshall'])
@pytest.mark.parametrize('name', ['chain8', 'torus44'])
def test_local_energy_of_the_ground_state_is_e0(name, gauge):
    """Zero variance: E_loc(s) = E0 on every board where |v| > 1e-12, in
    float64, with the couplings of lattice.py (and under the Marshall
    gauge its exchange factors on the rotated state)."""
    cfg = dict(CHAIN8 if name == 'chain8' else TORUS44,
               heisenberg_marshall_gauge=gauge)
    e0, v, boards = _ground_state(name)
    if name == 'chain8':
        assert e0 == pytest.approx(-3.0, abs=1e-12)     # Majumdar–Ghosh
    log_psi, modulus = _lookup_log_psi(v, boards, gauge)
    s = torch.as_tensor(boards[modulus > 1e-12])
    e = energy.local_energy(log_psi, {}, s, lattice.bonds(cfg), 1.0, 1.0,
                            4096, lattice.couplings(cfg))
    assert e.dtype == torch.complex128 and s.shape[0] > len(boards) // 4
    assert float((e - e0).abs().max()) < 1e-9


def test_bonds_and_couplings():
    nearest = dict(TORUS44, heisenberg_j2=0.0)
    for cfg, count in ((nearest, 32), (TORUS44, 64), (CHAIN8, 16),
                       (dict(TORUS44, num_sites=100, size_x=10, size_y=10),
                        400)):
        b = lattice.bonds(cfg)
        assert b.shape == (count, 2)
        assert len({tuple(sorted(p)) for p in b.tolist()}) == count
    assert set(map(tuple, np.sort(lattice.bonds(TORUS44).numpy(), 1))) == (
        set(_coordinate_bonds(TORUS44)))
    assert torch.equal(lattice.bonds(TORUS44)[:32], lattice.bonds(nearest))
    diagonal, exchange = lattice.couplings(TORUS44)
    assert diagonal.tolist() == [1.0] * 32 + [0.5] * 32 == exchange.tolist()
    diagonal, exchange = lattice.couplings(
        dict(TORUS44, heisenberg_marshall_gauge=True))
    assert exchange.tolist() == [-1.0] * 32 + [0.5] * 32
    assert diagonal.tolist() == [1.0] * 32 + [0.5] * 32
    assert lattice.couplings(nearest)[1].tolist() == [1.0] * 32
    for bad in ({'j_file_path': 'J.txt'}, {'lattice_type': 'triangular'},
                {'twist_phi': 0.1}, {'hamiltonian_type': 'ising'},
                {'heisenberg_j2': 0.0, 'heisenberg_marshall_gauge': True}):
        with pytest.raises(ValueError):
            lattice.bonds(dict(TORUS44, **bad))


def _tiny_complex(dtype=torch.float64):
    """The chain's complex composite (modulus and phase fully connected),
    its params moved by noise, and 4 batches of 8 boards."""
    cfg = dict(CHAIN8, fc_layer_size=4, sr_reject_residual=0.0,
               sr_delta_clip=1e6)
    wf = program.wavefunction(program.config_from(cfg))
    gen = torch.Generator().manual_seed(5)
    flat = {k: (v + 0.4 * torch.randn(v.shape, generator=gen)).to(dtype)
            for k, v in check.flat_params(wf.init(gen)).items()}
    template = torch.tensor([1.0, -1.0]).repeat(4)
    positions = [torch.stack([template[torch.randperm(8, generator=gen)]
                              for _ in range(8)]).to(dtype)
                 for _ in range(4)]
    return cfg, wf, flat, positions


def test_complex_sr_step_is_the_parameter_space_solve():
    """In float64: θ − lr·(S + λ)⁻¹F with S = Re<ΔO*ΔO>, F = Re<ΔO*ΔE>
    and λ = shift · tr(S) / 2M (the mean diagonal of the stacked
    [2M, 2M] system, whose trace is tr(S)), O = ∂log ψ complex."""
    cfg, _, flat, positions = _tiny_complex()
    side = steps.Sides(cfg, lattice.bonds(cfg), 64)
    assert side.complex
    new, metrics, _ = steps.sr_epoch(side, flat, 0, positions, {})
    s = torch.cat(positions)
    m = s.shape[0]
    theta, names = steps._flat(flat)

    def part(fn):
        return torch.autograd.functional.jacobian(
            lambda t: fn(side.log_psi(steps._unflat(t, flat), s)), theta)
    o = torch.complex(part(torch.real), part(torch.imag))
    d_o = o - o.mean(dim=0)
    e = side.e_loc(flat, s)
    d_e = e - e.mean()
    big_s = (d_o.conj().T @ d_o).real / m
    force = (d_o.conj().T @ d_e).real / m
    shift = cfg['sr_diag_shift'] * torch.trace(big_s) / (2 * m)
    delta = torch.linalg.solve(
        big_s + shift * torch.eye(theta.numel(), dtype=theta.dtype), force)
    want = theta - steps.learning_rate(cfg, 0) * delta
    got, _ = steps._flat(new)
    gap = torch.linalg.vector_norm(got - want)
    assert float(gap / torch.linalg.vector_norm(want - theta)) < 1e-10
    assert metrics['energy'] == float(e.mean().real)


def test_itswo_takes_a_real_log_psi_only():
    cfg, _, flat, positions = _tiny_complex()
    side = steps.Sides(cfg, lattice.bonds(cfg), 64)
    with pytest.raises(ValueError):
        steps.itswo_epoch(side, flat, 0, positions, {})


def _blocks(log_amp, boards):
    return [check.Block({}, boards, log_amp, 1)]


@pytest.mark.parametrize('error', [0.0, 0.1, 2 * math.pi, -2 * math.pi,
                                   3 * math.pi])
def test_cache_gap_reads_the_phase_modulo_two_pi(error):
    boards = torch.ones(5, 4)
    ref = torch.complex(torch.linspace(-1.0, 1.0, 5),
                        torch.linspace(-3.0, 3.0, 5))

    def log_fn(p, s):
        return ref

    cached = torch.complex(ref.real, ref.imag + error)
    gap = check.cache_gap(log_fn, _blocks(cached, boards))
    want = abs(math.remainder(error, 2 * math.pi))
    assert gap == pytest.approx(want, abs=2e-6)
    shifted = torch.complex(ref.real + 0.01, ref.imag + 2 * math.pi)
    assert check.cache_gap(log_fn, _blocks(shifted, boards)) == (
        pytest.approx(0.01, abs=2e-6))
    assert check.control_cache_gap(log_fn, _blocks(cached, boards)) == 0.0


def test_cache_gap_of_a_real_log_psi_is_unchanged():
    boards = torch.ones(3, 4)
    ref = torch.tensor([0.5, -1.0, 2.0])
    cached = torch.complex(ref + torch.tensor([0.0, 1e-3, -2e-3]),
                           torch.full((3,), 7.0))
    # A real reference: the gap of the real parts alone, as before.
    assert check.cache_gap(lambda p, s: ref, _blocks(cached, boards)) == (
        float((cached.real - ref).abs().max()))


def test_complex_composite_counts():
    cell = spec.cell('chain40_rbm.train_sr', BENCH)
    cfg = dict(TORUS44, batch_size=32)
    model = spec.flops(cell, 'complex')
    sr = spec.flops(cell, 'sr')
    n, h = 16, 16
    part = (n * h + h) + (h + 1)
    assert model.params(cfg) == 2 * part
    wf = program.wavefunction(program.config_from(cfg))
    assert model.params(cfg) == sum(
        t.numel() for t in check.flat_params(wf.init(torch.Generator()))
        .values())
    fwd = 2 * (2 * n * h + 2 * h)
    assert model.forward(cfg) == model.proposal(cfg) == fwd
    m, r, anti = 128, 256, 20.0
    want = ((10 + 4 * 1) * n * 32 * fwd + m * (1 + anti) * fwd
            + r * 2 * fwd + 2 * r * r * 2 * part + r ** 3 / 3 + 2 * r * r)
    assert sr.unit(cfg, model, anti) == pytest.approx(want, rel=1e-12)
    rbm = spec.flops(cell, 'rbm')
    real = sr.unit(cell.config, rbm, anti)
    m = 8192
    assert real == pytest.approx(
        14 * 40 * 2048 * 11 * 160 + m * 21 * rbm.forward(cell.config)
        + m * 2 * rbm.forward(cell.config) + 2 * m * m * 6601 + m ** 3 / 3
        + 2 * m * m, rel=1e-12)


@pytest.mark.parametrize(
    'cfg', [CHAIN8, TORUS44, dict(TORUS44, heisenberg_marshall_gauge=True)],
    ids=['chain8', 'torus44', 'torus44-marshall'])
def test_complex_composite_agrees_with_the_port(cfg):
    """log ψ bit for bit (the same f32 products), the local energy to f32
    rounding and one SR step to 1e-4 of the reference's (worst leaf)."""
    config = program.config_from(cfg)
    opt = program.optimizer(config)
    gen = torch.Generator().manual_seed(8)
    params = _moved(opt.wf.init(gen), gen)
    flat = check.flat_params(params)
    n = cfg['num_sites']
    template = torch.tensor([1.0, -1.0]).repeat(n // 2)
    positions = [torch.stack([template[torch.randperm(n, generator=gen)]
                              for _ in range(16)]) for _ in range(4)]
    boards = torch.cat(positions)
    side = steps.Sides(cfg, lattice.bonds(cfg), 64)
    with torch.no_grad():
        amp = opt.wf.apply(params, boards)
        e_port = opt.hamiltonian.local_value(opt.wf, params, boards, amp)
    assert amp.log.is_complex() and models.is_complex(cfg)
    assert torch.equal(amp.log, side.log(flat, boards))
    e_ref = side.e_loc(flat, boards)
    assert float((e_port - e_ref).abs().max()) < 1e-5 * float(
        e_ref.abs().max())
    new, _, _, _ = opt.update_from_samples(
        params, opt.sgd.init(params), torch.tensor(0), boards, e_port)
    ref, metrics, _ = steps.sr_epoch(side, flat, 0, positions, {})
    assert check.leaf_gap(check.flat_params(new), ref, flat) < 1e-4
    assert check.rel_gap(float(e_port.mean().real), metrics['energy']) < 1e-6


def _moved(tree, gen):
    return {k: _moved(v, gen) if isinstance(v, dict)
            else v + 0.3 * torch.randn(v.shape, generator=gen)
            for k, v in tree.items()}
