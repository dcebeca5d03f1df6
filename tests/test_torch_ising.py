"""The transverse-field Ising Hamiltonian of the PyTorch port, its exact
diagonalization and its `build_hamiltonian` branch, on the CPU.

`diagonal`, `connected` and the local energies against the JAX package at
1e-5 on the same numpy-seeded inputs; the |ψ|²-weighted local energy
against `ising_matrix` on N <= 10 at 1e-5; `ising_ground_state` and the
full basis against the JAX functions exactly (both are numpy); then
configs/tfim_chain16_sr.json through the CLI at a cut depth.
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

from cgs_vmc_tpu import basis as jax_basis
from cgs_vmc_tpu.config import Config
from cgs_vmc_tpu.models import build_wavefunction as jax_build
from cgs_vmc_tpu.ops.ising import (
    TransverseFieldIsingHamiltonian as JaxIsing)
from cgs_vmc_tpu.utils import ed as jax_ed
from cgs_vmc_tpu_torch import basis, cli, lattice, models
from cgs_vmc_tpu_torch.evaluate import evaluate_operator
from cgs_vmc_tpu_torch.ops.ising import TransverseFieldIsingHamiltonian
from cgs_vmc_tpu_torch.sampler import registry
from cgs_vmc_tpu_torch.train import build_hamiltonian, train
from cgs_vmc_tpu_torch.utils import ed, interop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TFIM_CONFIG = os.path.join(REPO, 'configs', 'tfim_chain16_sr.json')


def _problem(n_sites, seed, weighted=False, batch=24):
    """(JAX wf, its params, the port's wf, its params, bonds, couplings,
    random full-space configurations)."""
    config = Config(num_sites=n_sites, wavefunction_type='rbm',
                    num_fc_layers=0, fc_layer_size=6)
    jax_wf = jax_build(config)
    rng = np.random.default_rng(seed)
    raw = jax.tree.map(
        lambda x: (np.asarray(x) + 0.3 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jax.device_get(jax_wf.init(jax.random.key(seed))))
    bonds = lattice.chain_bonds(n_sites)
    couplings = (rng.uniform(0.5, 1.5, len(bonds)).astype(np.float32)
                 if weighted else None)
    configs = rng.choice([-1.0, 1.0], size=(batch, n_sites)
                         ).astype(np.float32)
    return (jax_wf, raw, models.build_wavefunction(config),
            interop.params_from_numpy(raw, 'cpu'), bonds, couplings, configs)


@pytest.mark.parametrize('sample_chunk', [0, 7])
@pytest.mark.parametrize('weighted', [False, True])
def test_diagonal_connected_and_local_value_match_jax(weighted,
                                                      sample_chunk):
    jax_wf, raw, wf, params, bonds, couplings, configs = _problem(
        10, seed=1, weighted=weighted)
    theirs = JaxIsing(bonds, h_x=0.7, j_zz=1.3, sample_chunk=sample_chunk,
                      couplings=couplings)
    ours = TransverseFieldIsingHamiltonian(
        bonds, h_x=0.7, j_zz=1.3, sample_chunk=sample_chunk,
        couplings=couplings)
    tconfigs = torch.as_tensor(configs)
    np.testing.assert_allclose(ours.diagonal(tconfigs).numpy(),
                               np.asarray(theirs.diagonal(configs)),
                               rtol=1e-5, atol=1e-5)
    flipped, weights = ours.connected(tconfigs)
    ref_flipped, ref_weights = theirs.connected(configs)
    np.testing.assert_array_equal(flipped.numpy(), np.asarray(ref_flipped))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(ref_weights))
    with torch.no_grad():
        got = ours.local_value(wf, params, tconfigs)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(theirs.local_value(jax_wf, raw, configs)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('n_sites', [4, 10])
def test_local_energy_matches_the_ed_matrix(n_sites):
    """Σ|ψ|² E_loc over the full 2^N basis equals <ψ|H|ψ>/<ψ|ψ> with
    `ising_matrix`, and H ψ = E_loc ψ row by row."""
    _, _, wf, params, bonds, couplings, _ = _problem(n_sites, seed=2,
                                                     weighted=True)
    ham = TransverseFieldIsingHamiltonian(bonds, h_x=0.9, j_zz=1.1,
                                          couplings=couplings)
    states = basis.enumerate_full_basis(n_sites)
    with torch.no_grad():
        amp = wf.apply(params, torch.as_tensor(states))
        e_loc = ham.local_value(wf, params, torch.as_tensor(states), amp
                                ).double().numpy()
    psi = np.exp(amp.log.double().numpy())
    matrix = ed.ising_matrix(n_sites, bonds, h_x=0.9, j_zz=1.1,
                             couplings=couplings, sparse=False)
    np.testing.assert_allclose(e_loc * psi, matrix @ psi, rtol=1e-5,
                               atol=1e-5 * np.abs(matrix @ psi).max())
    np.testing.assert_allclose(
        np.sum(psi ** 2 * e_loc) / np.sum(psi ** 2),
        psi @ matrix @ psi / (psi @ psi), rtol=1e-5)


@pytest.mark.parametrize('n_sites,sparse', [(6, False), (6, True),
                                            (13, None)])
def test_ising_ed_matches_jax(n_sites, sparse):
    """`ising_matrix` (dense and sparse), `ising_ground_state` and
    `enumerate_full_basis` equal the JAX package's; the N=13 case takes
    the sparse default (dim 8192 > 4096)."""
    bonds = lattice.chain_bonds(n_sites)
    couplings = np.linspace(0.8, 1.2, len(bonds))
    ours = ed.ising_matrix(n_sites, bonds, 0.6, 1.4, couplings, sparse)
    theirs = jax_ed.ising_matrix(n_sites, bonds, 0.6, 1.4, couplings, sparse)
    assert hasattr(ours, 'toarray') == hasattr(theirs, 'toarray')
    if hasattr(ours, 'toarray'):
        assert abs(ours - theirs).max() == 0.0
    else:
        np.testing.assert_array_equal(ours, theirs)
    e_ours, v_ours = ed.ising_ground_state(n_sites, bonds, 0.6, 1.4,
                                           couplings)
    e_theirs, v_theirs = jax_ed.ising_ground_state(n_sites, bonds, 0.6, 1.4,
                                                   couplings)
    assert abs(e_ours - e_theirs) < 1e-9
    assert abs(abs(v_ours @ v_theirs) - 1.0) < 1e-8
    if n_sites <= 6:
        np.testing.assert_array_equal(basis.enumerate_full_basis(n_sites),
                                      jax_basis.enumerate_full_basis(n_sites))


def test_tfim_chain16_ground_energy_is_the_recorded_one():
    config = Config.load(TFIM_CONFIG)
    ham = build_hamiltonian(config)
    assert isinstance(ham, TransverseFieldIsingHamiltonian)
    e0, _ = ed.ising_ground_state(16, ham.bonds, ham.h_x, ham.j_zz)
    assert abs(e0 - (-20.40459)) < 1e-4


def test_build_hamiltonian_errors():
    base = dict(num_sites=8, wavefunction_type='rbm')
    with pytest.raises(ValueError, match="requires mc_move_type='flip'"):
        build_hamiltonian(Config(hamiltonian_type='ising',
                                 mc_move_type='exchange', **base))
    with pytest.raises(ValueError, match="requires mc_move_type='exchange'"):
        build_hamiltonian(Config(hamiltonian_type='heisenberg',
                                 mc_move_type='flip', **base))
    with pytest.raises(ValueError, match="known: .'heisenberg', 'ising'"):
        build_hamiltonian(Config(hamiltonian_type='hubbard', **base))
    ham = build_hamiltonian(Config(
        hamiltonian_type='ising', mc_move_type='flip', ising_h=0.5,
        ising_j=2.0, energy_chunk_samples=3, **base))
    assert (ham.h_x, ham.j_zz, ham.sample_chunk) == (0.5, 2.0, 3)


def test_tfim_training_approaches_the_ed_energy():
    """SR on an N=8 TFIM chain through `train` (flip move, full-space
    chains, generic sampler) falls to within 2% of `ising_ground_state`."""
    config = Config.load(TFIM_CONFIG).replace(
        num_sites=8, fc_layer_size=16, batch_size=128, num_epochs=60,
        learning_rates=(0.05,), learning_rate_stops=(), checkpoint_dir='')

    class Keep:
        energies = []

        def log(self, epoch, metrics):
            self.energies.append(float(metrics['energy']))

    keep = Keep()
    state = train(config, 'cpu', logger=keep)
    wf = models.build_wavefunction(config)
    assert registry.resolved_name(wf, config) == 'generic'
    assert len(state.sampler.configs.sum(dim=1).unique()) > 1
    ham = build_hamiltonian(config)
    e0, _ = ed.ising_ground_state(8, ham.bonds, ham.h_x, ham.j_zz)
    result = evaluate_operator(wf, state.params, ham, config.replace(
        num_evaluation_samples=40), 'cpu')
    assert np.mean(keep.energies[-5:]) < np.mean(keep.energies[:5])
    assert result.mean >= e0 - 5 * result.error
    assert abs(result.mean - e0) / abs(e0) < 0.02


def test_cli_trains_the_tfim_config(tmp_path, capsys):
    """`cli train --device cpu --config configs/tfim_chain16_sr.json` at a
    cut depth, then `cli eval` on the run."""
    assert cli.main(['train', '--config', TFIM_CONFIG, '--device', 'cpu',
                     '--checkpoint_dir', str(tmp_path), '--override',
                     'num_epochs=3,batch_size=64']) == 0
    with open(tmp_path / 'metrics.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert [r['epoch'] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r['energy']) for r in records)
    capsys.readouterr()
    assert cli.main(['eval', '--checkpoint_dir', str(tmp_path), '--device',
                     'cpu', '--override', 'num_evaluation_samples=5']) == 0
    out = capsys.readouterr().out
    energy = float(out.split('Energy: ')[1].split(' +/- ')[0])
    assert np.isfinite(energy) and energy > -20.40459 - 1.0
