"""Configuration schema of the port (its own copy of cgs_vmc_tpu/config.py).

The same dataclass fields and defaults, and the same ``replace`` /
``override_from_dict`` / ``parse`` / ``to_json`` / ``save`` / ``load`` /
``parse_overrides`` as the JAX package's, so the same ``configs/*.json``
drive both packages and a run directory's ``config.json`` written by either
loads in the other (tests/test_torch_config_lattice.py holds the two
together).  Fields of features the port has not ported yet are kept so the
files stay interchangeable; ``train`` refuses non-default values of them.

Typed dataclass replacement for the reference's TF HParams schema
(reference: cgs_vmc/utils.py:15-150), persisted as JSON next to
checkpoints; `parse_overrides` provides the comma-separated ``name=value``
override string the reference accepted via ``hparams.parse``
(cgs_vmc/run_training.py:60-64,90).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Tuple


@dataclasses.dataclass
class Config:
    """All hyperparameters of a run.

    Field groups mirror the reference schema (cgs_vmc/utils.py:87-148);
    fields below the "TPU-native additions" marker are new.
    """

    # Directory parameters.
    checkpoint_dir: str = ''
    supervisor_dir: str = ''
    basis_file_path: str = ''

    # System parameters.
    wavefunction_type: str = ''
    composite_wavefunction_types: Tuple[str, str] = ('', '')
    wavefunction_optimizer_type: str = ''
    num_sites: int = 40
    size_x: int = 1
    size_y: int = 1
    size_z: int = 1

    # Fully connected parameters.
    num_fc_layers: int = 3
    fc_layer_size: int = 80

    # Convolutional parameters.
    num_conv_layers: int = 5
    conv_strides: int = 1
    kernel_size: int = 5
    num_conv_filters: int = 16

    # ResNet parameters.
    num_resnet_blocks: int = 2
    # Use bottleneck residual blocks (1x1 reduce -> kxk -> 1x1 expand);
    # the reference's BottleneckResBlock1d was unreachable AND crashed
    # (layers.py:348 `_output_channels` never set) — here it's wired.
    resnet_bottleneck: bool = False

    # MPS parameters.
    bond_dimension: int = 4

    # ED state parameters (FullVector ansatz; Lin 1990 index tables).
    top_lin_table_file: str = ''
    bot_lin_table_file: str = ''
    ed_vector_file: str = ''

    # GraphConvNetwork parameters.
    adjacency_list_path: str = ''

    # SpinTransformer parameters (wavefunction_type='transformer';
    # ansatz family beyond the reference, models/attention.py).
    num_attention_layers: int = 2
    attention_dim: int = 32
    num_attention_heads: int = 4

    nonlinearity: str = 'relu'
    output_activation: str = 'exp'
    # Symmetry projection (new vs reference): average the ansatz over the
    # square-lattice point group (+ global spin flip) in log domain.
    symmetrize: bool = False
    symmetrize_spin_flip: bool = True
    composite_output_activations: Tuple[str, str] = ('', '')

    # Monte Carlo parameters.
    num_equilibration_sweeps: int = 100
    num_monte_carlo_sweeps: int = 1

    # Training parameters.
    num_epochs: int = 500
    batch_size: int = 200
    num_batches_per_epoch: int = 50
    time_evolution_beta: float = 0.12
    learning_rates: List[float] = dataclasses.field(
        default_factory=lambda: [1e-3, 1e-4, 2e-5, 1e-5])
    learning_rate_stops: List[int] = dataclasses.field(
        default_factory=lambda: [300, 600, 1000])
    optimizer: str = 'adam'
    beta2: float = 0.99

    # Evaluation parameters.
    num_evaluation_samples: int = 100

    # ------------------------------------------------------------------
    # TPU-native additions (not present in the reference).
    # ------------------------------------------------------------------
    seed: int = 42
    # Reduced-precision compute for conv ansatzes ('float32' | 'bfloat16');
    # weights/optimizer state stay f32, conv accumulation is f32.
    compute_dtype: str = 'float32'
    # Hamiltonian family: 'heisenberg' (the reference's only operator) |
    # 'ising' (transverse-field Ising, ops/ising.py — requires
    # mc_move_type='flip' since it does not conserve Sz).
    hamiltonian_type: str = 'heisenberg'
    # Hamiltonian (the reference took jx from a CLI flag and jz was fixed
    # to 1.0, cgs_vmc/run_training.py:27-29,112-113).
    heisenberg_jx: float = 1.0
    heisenberg_jz: float = 1.0
    # Transverse-field Ising parameters (hamiltonian_type='ising'):
    # H = -ising_j * sum_bonds sz*sz - ising_h * sum_i sx  (Pauli).
    ising_h: float = 1.0
    ising_j: float = 1.0
    # Metropolis move set: 'exchange' (Sz-conserving down×up pair swap,
    # the reference's move, graph_builders.py:59-65) | 'flip' (single
    # spin flip over the full 2^N space, for non-conserving Hamiltonians).
    mc_move_type: str = 'exchange'
    # Twice the total-Sz sector the exchange-move chains sample (the move
    # conserves Sz, so the init pins the sector): 0 = the reference's
    # Sz=0 sector; e.g. 2 = the Sz=1 (lowest-triplet) sector for
    # spin-gap measurements.  Must have the parity of num_sites; only
    # meaningful with mc_move_type='exchange'.
    total_sz2: int = 0
    # Twisted boundary conditions (spin stiffness): total twist angle
    # accumulated winding the torus once along twist_direction.  Nonzero
    # phi makes local energies COMPLEX (pair with a sign/phase-capable
    # ansatz, e.g. wavefunction_type='complex'); rho_s follows from the
    # E(phi) curvature at 0 (lattice.twist_phases, tests/test_twist.py).
    twist_phi: float = 0.0
    twist_direction: str = 'x'
    # Next-nearest-neighbour coupling J2/J1 (frustrated J1-J2 model on the
    # chain or square lattice; 0 = plain nearest-neighbour Heisenberg).
    heisenberg_j2: float = 0.0
    # Marshall-gauge the J1-J2 lattice: off-diagonal sign flipped on J1
    # bonds only (lattice.j1j2_marshall_gauged) — spectrum-preserving,
    # makes the ground state near-positive at moderate J2/J1.
    heisenberg_marshall_gauge: bool = False
    j_file_path: str = ''        # bonds file: 'i j [J_ij]' rows
    # --- Excited states (beyond the reference) -------------------------
    # Frozen lower states the 'ExcitedPenalty' optimizer orthogonalizes
    # against: run directories (architecture from their config.json) or
    # .msgpack params artifacts (architecture from THIS config).
    orthogonal_to: List[str] = dataclasses.field(default_factory=list)
    # Penalty weight lambda on sum_k |<psi_k|psi>|^2/(norms); must exceed
    # the target excitation gap for the minimum to be the excited state.
    orthogonality_penalty: float = 10.0
    # '' / 'auto': geometry-derived (square if size_x*size_y==num_sites,
    # else chain); 'triangular': rhombic-torus triangular lattice
    # (frustrated — pair with a complex-phase ansatz for AFM couplings).
    lattice_type: str = ''
                                 # (reference: J.txt in ckpt dir)
    # Chunk the connected-config local-energy fan-out over samples (0 = off);
    # needed when batch × n_bonds (× symmetry orbit) exceeds HBM.
    energy_chunk_samples: int = 0
    # Stochastic reconfiguration (new optimizer; absent from reference).
    sr_diag_shift: float = 1e-3
    # 'dense' (sample-space minSR, Jacobian all-gathered, Cholesky) |
    # 'dense_cg' (same assembled [M, M] system, solved by CG — sidesteps
    # the serial blocked Cholesky; accuracy set by sr_cg_tol) |
    # 'sample_cg' (same system, Jacobian kept sharded, CG — O(M_local·P)
    # memory for multi-chip scale) | 'cg' (parameter-space matrix-free).
    sr_solver: str = 'dense'
    sr_cg_tol: float = 1e-6
    sr_cg_maxiter: int = 100
    sr_delta_clip: float = 10.0   # trust-region cap on |natural gradient|
    # Compute per-sample gradient rows this many samples at a time
    # (lax.map over chunks; 0 = all at once).  Bounds the backward-pass
    # activation memory, which otherwise scales with the FULL sample count
    # (x the symmetry-orbit size for projected ansatzes).
    sr_jacobian_chunk: int = 0
    # Skip the update when solve residual > this × |grad| (0 disables).
    sr_reject_residual: float = 0.0
    # Matmul precision for the SR solve GEMMs (JJᵀ assembly, Jᵀy):
    # 'highest' = 6-pass f32 (safest), 'high' = 3-pass bf16 — ~2x faster
    # on the MXU; the [M, M] Cholesky itself always stays f32.
    sr_matmul_precision: str = 'highest'
    # Mesh: number of devices to shard Markov chains over (1 = single chip).
    num_devices: int = 1
    # Compile this many epochs into ONE device program (lax.scan) per
    # dispatch.  Amortizes per-dispatch host latency (~25-30 ms on
    # relay-attached transports) at the cost of metrics/checkpoint
    # granularity staying per-epoch but host visibility arriving every
    # k epochs.  1 = one program per epoch (reference-like behavior).
    epochs_per_call: int = 1
    # Polyak/EMA averaging of the wavefunction parameters: when > 0 the
    # training loop tracks ema <- d*ema + (1-d)*params every epoch in
    # TrainState.extra['ema_params'] (checkpointed; evaluate the averaged
    # weights with `cgs eval --ema`).  0 disables (no state slot).
    param_ema_decay: float = 0.0
    # Per-sample Jacobian rows via im2col batched GEMMs for the (symmetrized)
    # conv / ResNet ansatzes and the PixelCNN (optim/fast_jacobian.py); any
    # other ansatz, and a complex one's stacked rows, keep vmap(grad).  The
    # same numbers to f32 rounding.  Default off, as in the JAX package
    # (whose batched GEMMs measured ~4x slower than its vmap rows on a TPU
    # v5e); the H100's times both ways: PERF.md, chip_smoke.py phase 37.
    sr_fast_jacobian: bool = False
    # Evaluation as SEPARATE small compiled programs (sweeps / local value)
    # driven from Python instead of one monolithic scan — required on
    # constrained TPU transports for big symmetrized fan-outs (see
    # evaluate._evaluate_operator_split).  Single-device only.
    split_eval: bool = False
    # Use the fused Pallas sweep kernel when the ansatz supports it
    # (pure RBM): O(hidden) incremental updates instead of full forwards.
    use_fast_sampler: bool = True
    # MPS only: environment-cached ordered adjacent-exchange sweeps,
    # O(N·D²) per sweep instead of O(N²·D²) (sampler/fast_mps.py).
    # Opt-in: the local move set mixes differently from the global
    # down×up exchange of the reference schedule.
    mps_incremental_sweeps: bool = False
    # Multiple-try Metropolis: propose this many candidates per step and
    # evaluate them in one batched forward pass (0 = single-try).  Pays off
    # for expensive ansatzes where per-step latency dominates.
    mtm_candidates: int = 0
    # Parallel tempering (sampler/tempering.py): run this many replicas
    # per chain at exponents 1 .. pt_beta_min (geometric ladder) sampling
    # |psi|^(2*beta), with neighbour swaps after every sweep.  0/1 = off.
    # Replicas ride the batch axis (one fused forward per step); only the
    # beta=1 replica's samples feed the estimators.
    pt_replicas: int = 0
    pt_beta_min: float = 0.4
    # Checkpointing.
    checkpoint_frequency: int = 1
    max_checkpoints_to_keep: int = 5
    checkpoint_backend: str = 'msgpack'   # 'msgpack' | 'orbax'
    # Profiling: when set, a jax.profiler trace of the first post-compile
    # epoch is written here (TensorBoard-compatible).
    profile_dir: str = ''

    # ------------------------------------------------------------------

    def replace(self, **kwargs: Any) -> 'Config':
        return dataclasses.replace(self, **kwargs)

    def override_from_dict(self, values: dict) -> 'Config':
        """Returns a new Config with `values` applied (validates names)."""
        names = {f.name for f in dataclasses.fields(self)}
        unknown = set(values) - names
        if unknown:
            raise ValueError(f'Unknown config fields: {sorted(unknown)}')
        return dataclasses.replace(self, **values)

    def parse(self, override_string: str) -> 'Config':
        """Applies a comma-separated ``name=value`` override string."""
        return self.override_from_dict(parse_overrides(self, override_string))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> 'Config':
        with open(path) as f:
            values = json.load(f)
        # Tuples serialize as lists; coerce back per-field.
        for field in dataclasses.fields(cls):
            if field.name in values and isinstance(values[field.name], list):
                if 'Tuple' in str(field.type) or isinstance(
                        getattr(cls(), field.name), tuple):
                    values[field.name] = tuple(values[field.name])
        return cls(**values)


def _coerce(current: Any, raw: str) -> Any:
    """Coerces a raw override string to the type of the current value."""
    if isinstance(current, bool):
        if raw.lower() in ('true', '1', 'yes'):
            return True
        if raw.lower() in ('false', '0', 'no'):
            return False
        raise ValueError(f'Cannot parse boolean from {raw!r}')
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, (list, tuple)):
        parts = [p for p in raw.strip('[]()').split(';') if p]
        elem = current[0] if len(current) else ''
        typ = type(elem)
        out = [typ(p) if not isinstance(elem, bool) else _coerce(elem, p)
               for p in parts]
        return tuple(out) if isinstance(current, tuple) else out
    return raw


def parse_overrides(config: Config, override_string: str) -> dict:
    """Parses ``a=1,b=2.5,c=text,d=[1;2;3]`` into a typed dict.

    List values use ``;`` separators inside ``[...]`` so that the top level
    stays comma-separated (the reference used TF's hparams.parse grammar).
    """
    out: dict = {}
    if not override_string:
        return out
    for item in override_string.split(','):
        item = item.strip()
        if not item:
            continue
        if '=' not in item:
            raise ValueError(f'Malformed override (expected name=value): {item!r}')
        name, raw = item.split('=', 1)
        name = name.strip()
        if not hasattr(config, name):
            raise ValueError(f'Unknown config field: {name!r}')
        out[name] = _coerce(getattr(config, name), raw.strip())
    return out
