#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line, each failing the run (non-zero exit)
when a check does not hold:

1. device: the card's name and its nvidia-smi name and power limit;
2. build: nvcc builds the sweep kernels from cgs_vmc_tpu_torch/csrc;
   their branch-free log1p against the library's log1pf on every float in
   [0, 1] (bit for bit); ptxas's registers and spills of the instances the
   bench and slice shapes run;
3. K1 (streamed draws) against its plain torch version on the same draws,
   at the bench shape (N=36, H=64) and the slice shape (N=40, H=160),
   2048 chains, 2 sweeps, and at the slice shape for 10 sweeps (the main
   path's equilibration call): configs and accept counts identical in
   >= 99.9% of chains, logψ within 1e-4 on those chains; the same at the
   bench and slice shapes with every width (lanes a chain) forced; and at
   the edge shapes: n_sites 2 and 256, H 1, 33 and 512, 3 and 2049 chains,
   0 and G + 1 steps.  At every one of these, K1 also against its
   lane-order witness (`rbm_sweeps_lanes_plain` on the width the launch
   runs: Σ_h summed per lane and by the butterfly, θ carried through the
   call): every output bit for bit on every chain;
4. K2 (in-kernel Philox) against its plain version and its witness
   (`rbm_sweeps_prng_lanes_plain`), same criteria and shapes; and K2's
   equilibrium acceptance within 0.01 of K1's at the bench shape;
5. the slice's training: the port's `train` on configs/chain40_sr.json
   (EnergyGradient, adam, lr 1e-2) for 20 epochs on cuda;
6. the slice's evaluation: `evaluate_operator` on the trained params, once
   with the default sampler (K2) and once with the streamed kernel (K1);
   E/N finite and above the finite-size Bethe value −0.44366 minus 5 errors;
7. times of the kernels and their plain versions, and the mean epoch time;
   then each kernel alone (its C entry point, CUDA events) at the bench
   shape (10 sweeps) and the slice shape (1 and 10 sweeps), with the rule's
   width and the other width, beside its bound and its share of it;
8. artifacts: artifacts/heisenberg_6x6_deep48.msgpack through the port's
   own msgpack reader; logψ over the 512 committed samples within 1e-3 of
   tests/data/flagship_6x6_deep48_logpsi.npy, their importance-weighted
   E/N within 1e-3 of QMC −0.678872 (tests/test_flagship_pin.py), and the
   eight tests/test_artifacts.py fingerprints in their bands (std < 0.06),
   on the exact configurations that test draws (FINGERPRINT_CONFIGS);
9. evaluate_operator on deep48 from 512 chains started at the committed
   samples: 5 equilibration sweeps, 50 measurements 2 sweeps apart; E/N
   finite and within 1e-3 + 5σ of QMC;
10. SR training through `train`: (a) configs/square66_conv_sr.json (the
   symmetrized 5×32 conv_2d, dense minSR) for 10 epochs, (b)
   configs/chain40_sr.json (RBM H=160, dense SR, sampled by K2) for 20
   epochs; energies finite and the mean of the last 3 below the first,
   sr_residual_norm finite, acceptance in (0.05, 0.98), and K2 launched
   on path (b);
11. times: the flagship SR epoch (sr_epoch_wall_s) and its parts —
   sampling, local energies, Jacobian rows, the [M, M] assembly and
   Cholesky solve — and the chain40 SR epoch;
12. ITSWO, then LogOverlapITSWO, through `train` on configs/chain40_sr.json
   (adam 1e-3) for 20 epochs each: energies finite, the mean of the last 3
   below the first, acceptance in (0.05, 0.98), K2 launched 1 +
   num_batches_per_epoch times an epoch; the mean epoch time;
13. configs/square44_itswo.json (conv_2d 3×8, ITSWO, generic sampler)
   unmodified but for 40 epochs: energies finite and falling; epoch time;
14. distillation of the 4×4 ED ground state (FullVector of |V0|, 12,870
   states) into an RBM (H=64, K2) by SWO, LogOverlapSWO, DualSamplingSWO
   and BasisIterSWO, 60 epochs each through `distill`: each optimizer's
   fidelity (evaluate_vector + overlap_with_vector) at least the JAX
   package's on the CPU with the same config and seed, less 0.02
   (examples/swo_distill_bars.py measured those);
15. `distill` from phase 12's ITSWO run directory into an RBM H=160 by
   LogOverlapSWO (2048 chains, 5 epochs): mean_ratio finite, K2 launched, a
   checkpoint written; then `evaluate_operator` on the student, E/N finite
   and above the Bethe value minus 5 errors;
16. configs/j1j2_chain8_complex_sr.json unmodified (complex(fc × fc), dense
   SR on the stacked [2M, 2M] system, 150 epochs) through `train`, then
   `evaluate_operator`: the training energy falls (the mean of the last 10
   epochs below the mean of the first 10 by COMPLEX_DESCENT) and the
   evaluated energy is not below the ED energy (5 errors allowed); its
   relative error is printed beside the JAX package's on the CPU
   (examples/twisted_chain16_bars.py measured it).  The correctness gate of
   this path is the single-epoch hold of tests/test_torch_complex.py
   (rtol 1e-4 against the JAX package), not a single seed's energy;
17. configs/twisted_chain16_sr.json unmodified but for TWISTED_EPOCHS
   epochs (N=16, twist φ=0.3), the same two checks against the twisted ED
   energy; then the spin-stiffness ansatz of
   examples/spin_stiffness_chain16.py (complex(rbm × fc 48), 512 chains ×
   2) through `train` at φ = 0 and φ = 1.2 at a smoke depth: finite
   energies, printed;
18. the sampler cells at 6×6 (N=36), 2048 chains, each ansatz's generic
   sweeps against its incremental sampler as the registry resolves them:
   pbdg / pbdg_sherman_morrison, jastrow / jastrow_delta, mps (Config's
   default bond dimension 4, and 16) / mps_env; sweeps/s printed (the
   median of calls taken in turns); the
   cached logψ within 1e-4 of a fresh forward after every call, and the
   acceptance rates of fast and generic within 0.02 (jastrow, pbdg; the
   MPS sampler's adjacent exchanges are another move);
19. one short SR 'dense' `train` run on the N=16 chain for each of mps (on
   mps_env), pbdg, fully_connected_nnb, gnn, jastrow and 'prod' (jastrow ×
   conv_1d; the gnn on an adjacency file with a self column): energies
   finite, the mean of the last 3 below the first.

20. configs/square1010_deep_eval.json (`split_eval` left true) on
   artifacts/heisenberg_10x10_deep32_cont.msgpack, unmodified but for
   num_evaluation_samples = 4: E/N within max(5 errors, 1e-3) of the
   recorded −0.671378 (RESULTS.md);
21. configs/chain20_fc_energy.json for CHAIN20_EPOCHS epochs (energies fall)
   and configs/square1010_eval.json with num_devices = 1 at a cut depth (no
   committed artifact has its unsymmetrized 5×16 architecture, so 2 epochs
   are trained and evaluated): finite, not below the QMC energy;
22. configs/square66_transformer_sr.json: the committed artifact
   (artifacts/heisenberg_6x6_transformer.msgpack) evaluated on one batch
   after the config's own equilibration, then the config unmodified but
   for 3 epochs and sr_jacobian_chunk (a memory knob: the unchunked
   Jacobian does not fit the card) through `train`; energies and SR
   residuals finite, the parameters moved, epoch seconds and peak memory
   printed;
23. exact autoregressive draws at 6×6, 1024 chains: the MADE of
   artifacts/heisenberg_6x6_made.msgpack (1 hidden layer of 256) and a
   PixelCNN at Config's default conv sizes; the registry resolves
   'exact_autoregressive', acceptance is exactly 1, every draw is in the
   Sz=0 sector, samples/s as the median of AR_REPS synchronized calls with
   the launches of one call, and a few EnergyGradient epochs;
24. multiple-try Metropolis (4 and 8 candidates) and parallel tempering (4
   replicas) against the generic sampler, on the flagship conv at 6×6
   (configs/square66_conv_sr.json's ansatz, 1024 chains; device-bound) and
   on configs/square44_itswo.json's small conv at 4×4 (512 chains;
   launch-bound): sweeps/s as the median of calls taken in turns, the
   launches of one sweep, swap rates; chains in the sector and the cached
   logψ equal to a fresh forward;
25. configs/tfim_chain16_sr.json unmodified (400 epochs) through `train`,
   then `evaluate_operator`: E within 1e-3 (relative) of the ED energy
   −20.40459.

26.-30. measurement and dynamics on phase 12's chain40 ITSWO run (RBM
   H=160, 2048 chains, sampled by K2):
26. `eval --observable` szsz:1, transverse:1 (Marshall-corrected), sq:1,
   staggered_m2 and total_spin2 at OBS_SAMPLES samples: finite, and
   S(π) = N·m²_stag at 1e-5 (the same samples); then szsz, transverse and
   S² of the chain16 ED state (ed_vector, generic sampler) within 5 errors
   of `exact_expectation`;
27. the Lanczos step (`energy_shift='auto'`) on the chain40 run:
   E(α*) ≤ E0 + 2σ and a lower variance; `exact_lanczos` on the chain16 ED
   state: α* = 0 and E equal to ED at 1e-5; deep48 at a cut depth from the
   committed samples: finite, E0/N printed beside the record −0.678824;
28. Rényi-2 of the chain16 ED state's half chain within 5 errors of
   `exact_renyi2`, and of two chain40 regions (finite; both replicas on K2);
29. `evolve --mode imag` on the chain40 run (the energy of the last 5 steps
   below that of the first 5); tests/test_tvmc.py's full-basis quench at
   N=8 against expm(−iHt) (fidelity > 0.9999, energy conserved); `evolve
   --linear_response 1` on phase 16's complex run (a finite
   linear_response.jsonl, its peak printed);
30. `train --orthogonal_to` the chain40 run on configs/chain40_sr.json with
   ExcitedPenalty and ExcitedSR (EXCITED_EPOCHS each): finite energies and
   overlaps; then one resumed ExcitedPenalty epoch (the frozen chains come
   back from the checkpoint).

31.-34. the run plumbing on configs/chain40_sr.json's RBM (EnergyGradient
   with adam 1e-2 unless said otherwise; K2 launched in each):
31. PLUMBING_EPOCHS epochs with param_ema_decay = 0.9 and checkpoints every
   4: the EMA slot within rtol 1e-6 of the average recomputed on the host
   from every epoch's params (a second run without the slot, whose params
   must equal the first's bit for bit); a resume from epoch 8's checkpoint
   equal to the straight run bit for bit (params, slot, chains, generator);
   `eval --ema` E/N finite and above the Bethe bound;
32. phase 31's params through `save_params_only` / `restore_params_only`
   bit for bit; the deep48 artifact decoded and re-encoded byte for byte;
   a basis file through `save_basis_file` / `load_basis_file`;
33. `train` for 3 epochs with profile_dir: one trace file, of the second
   epoch, whose device events name K2's kernel
   (`rbm_sweep_kernel<..., PhiloxDraws>`) once for each of its launches;
   their times beside phase 7's CUDA-event times;
34. the sharded path over NCCL at world size 1 (`initialize_distributed
   ('nccl', 'file://...', 1, 0)`, so `num_devices=1` shards): chain40 for 3
   epochs under EnergyGradient (bit for bit equal to the run without a
   group) and dense SR (rtol 1e-5), `evaluate_operator` at 20 samples (rtol
   1e-6); the NCCL version and the collectives an epoch printed.  No run
   had two or more GPUs: a machine with one card cannot.

35.-36. the port's two other entry points:
35. `entry()` (cgs_vmc_tpu_torch/entry.py, the counterpart of
   __graft_entry__.entry): the 6×6 conv_2d 5×16 forward step (logψ, E_loc)
   on 64 boards, card against the same inputs on the CPU within 1e-4
   (relative and absolute); one forward's CUDA-event time;
36. the bench's own functions (cgs_vmc_tpu_torch/bench.py) at its shapes
   with cut repetitions: 2 K2 reps of 800 sweeps (N=36, H=64, 2048 chains)
   with the acceptance band, its one timed K1 call, one per-call and one
   2-epoch fused flagship SR epoch rep after the one-epoch warm-up, 3
   MADE calls of 2048 exact draws; the partial JSON report printed, and
   the TF32 flags as they were; then that K1 call (28,800 steps, picks of
   [28800, 2048, 2]) and one K2 call of 800 sweeps from the reps' chains,
   each against one call of its lane-order witness on the same inputs:
   configs, accept counts, θ and logψ bit for bit on all 2048 chains.

37. optim/fast_jacobian.py (sr_fast_jacobian): the flagship's Jacobian
   rows (configs/square66_conv_sr.json after one epoch, its 4096 samples)
   by the batched GEMMs and by vmap(grad), entry by entry within the JAX
   test's atol 3e-5·max|rows| + rtol 2e-4 on every row but those a relu
   kink parts (at most 0.5% of them, global L2 under 2e-3, each parted
   row the float64 forward's row in one of the two ways); each way's ms
   and peak memory, 5 reps in turns; one SR epoch with the flag on and
   off, 5 in turns; then phase 23's PixelCNN over 4096 exact draws, rows
   only (the rows at init, where zero biases put relu inputs exactly on
   the kink, counted; the hold on params moved off init).

38. the compiled epoch (cgs_vmc_tpu_torch/utils/cuda_graph.py): `train`
   on chain40 under EnergyGradient, SR, ITSWO and LogOverlapITSWO (EMA
   0.9, an LR stop at epoch 12, inside a replayed block) for GRAPH_EPOCHS
   epochs eagerly (`replay='eager'`) and as CUDA graphs at
   epochs_per_call 1 and 5: states (params, optimizer state, chains, EMA
   slot, every generator's state) and every metric bit for bit, K2 exactly
   5 launches an epoch either way; `distill` of the 4x4 ED state by the
   four supervised optimizers (one graph an epoch) the same way;
   configs/square44_itswo.json (GRAPH_EPOCHS epochs) and
   configs/square66_conv_sr.json (3 epochs) the same way with cuDNN's
   deterministic algorithms (its default weight gradients are not
   repeatable even eagerly); then each chain40 optimizer and both conv
   configs through an eager and a graph runner from one state: each
   epoch's ms both ways (medians of GRAPH_TURNS calls in turns, with the
   spread), the capture's seconds and the graph's nodes, one profiled
   epoch each way (device events, busy share), the peak memory allocated
   each way and the graph pool's reserve.

39. the periodic conv kernel (cgs_vmc_tpu_torch/csrc/periodic_conv2d.cu,
   models/periodic_conv2d.py) at the flagship sampler's shapes (16,384
   images of 6×6, k=3, 1→32 and 32→32), ReLU on and off: its wrapper
   against the plain route (`_wrap` + `F.conv2d` + bias + ReLU) on the same
   inputs in float64, within PCONV_TOL (relative and absolute); then its C
   entry point alone by CUDA events beside its bound (f32 FMA or HBM) and
   the plain route's time in f32 (library_ms).

40. the attention kernel (cgs_vmc_tpu_torch/csrc/spin_attention.cu,
   models/spin_attention.py) at the transformer cell's shapes (n = 36, 8
   heads of 8; a proposal's 4,096 images and a connected-board chunk's
   147,456): its wrapper against the plain einsums on the same inputs in
   float64 (the proposal) or float32 (the chunk), within ATTN_TOL (relative
   and absolute); its C entry point alone by CUDA events beside its bound
   (HBM), the plain einsums' time and F.scaled_dot_product_attention's
   (library_ms, a yardstick the port never calls); then ATTN_EPOCHS epochs
   of `train` on the cell's configuration (configs/square66_transformer_sr.json
   at 256 chains) with spans on: the kernel's launches and the plain calls
   an epoch (the fused linears' too, phase 41), and each epoch's span
   device ms.

41. the encoder's fused linear kernel (cgs_vmc_tpu_torch/csrc/
   encoder_linear.cu, models/encoder_linear.py), each of its four
   instances (qkv, attn_out, mlp_in, mlp_out of a block at width 64) at a
   proposal's 4,096 images and a connected-board chunk's 147,456 (36 rows
   an image): its wrapper against the plain chain in float32 (LayerNorm,
   GEMM, bias, GELU or residual add), within ELIN_TOL (relative and
   absolute); its C entry point alone by CUDA events beside its bound (the
   larger of operations at 67 TFLOP/s and bytes at 3.35 TB/s), the plain
   chain's time and, as a yardstick only, torch.matmul alone (library_ms).

Every `train` and `distill` call of phases 5-38 on the card replays CUDA
graphs after its first block, unless it asks for `replay='eager'` (phase
38's eager runs) or runs under a process group (phase 34's sharded runs).

The launch counters are zeroed just before phase 5 and read after phase 6,
and zeroed again before each of phases 10(b), 12 (per optimizer), 13, 14
(per optimizer) and 15 and read after it: both kernels must have run in
the slice-1 path, K2 in the SR, ITSWO, SWO and distill paths.  Phases
20-25 run no hand-written kernel (none of their modules has one in the JAX
package either) and must launch neither.  Phases 26-30 zero the counts
before each path that samples the chain40 RBM and require K2's launches
to equal the count the source predicts; phases 31-34 zero them before
each path and require K2's to be positive.  Phases 35 and 37 must launch
neither; phase 36 zeroes them before the bench's functions and requires
exactly their launches (K2 1 + 2, K1 2), read before its comparison with
the witness.  The last two lines are a JSON object describing each
kernel (launches from phases 5-6 and 36, K2's with those of phases 31-34
and phase 38's graph runs added; times and bound at the bench shape, 10
sweeps) and the JSON result line.  Phase 38 zeroes the counts before each
of its runs and requires each graph run's K2 launches to equal its eager
run's.  The periodic conv's counters (`periodic_conv.launches`,
`periodic_conv.plain`) are zeroed just before phase 10(a), the flagship's
SR run, and read after it: every no-grad conv call launches the kernel, so
the plain route is taken only by the SR rows' vmap(grad), 5 calls (one a
layer) an epoch; the kernels line gives the launches, with the ms, bound
and library_ms of phase 39's 32→32 layer.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cgs_vmc_tpu_torch.utils import profiling

CHAINS = 2048
# Share of chains on which a kernel must equal its plain version (which sums
# Σ_h by torch.sum, as the JAX kernel's oracle); its lane-order witness
# must equal it on every chain.
AGREE = 0.999
TOL = 1e-4                 # |Δlogψ| <= TOL·(1 + |logψ|), as the JAX tests
ACC_TOL = 0.01             # K2 vs K1 equilibrium acceptance
BETHE_E_PER_SITE = -0.44366  # finite-size Bethe estimate for N=40
EPOCHS = 20
SHAPES = {'bench': (36, 64), 'slice': (40, 160)}
# Kernel/plain comparisons: (shape, sweeps).  2 sweeps at both shapes, and
# the slice's 10-sweep equilibration call, the longest the main path makes.
COMPARISONS = (('bench', 2), ('slice', 2), ('slice', 10))
# The layout's edges: (n_sites, hidden, chains), each at 0 and G + 1 steps.
EDGE_SHAPES = tuple((n, h, c) for n in (2, 256) for h in (1, 33, 512)
                    for c in (3, 2049))
TIMING_SWEEPS = 10
# 38. The compiled epoch: chain40 under each optimizer (its rates, with an
# LR stop inside a replayed block), GRAPH_EPOCHS epochs each way; epoch
# times as medians of GRAPH_TURNS calls in turns.
GRAPH_EPOCHS = 20
GRAPH_TURNS = 5
GRAPH_CONV_EPOCHS = {'square44_itswo': GRAPH_EPOCHS, 'square66_conv_sr': 3}
GRAPH_CHAIN40 = {
    'EnergyGradient': dict(learning_rates=[1e-2, 5e-3],
                           learning_rate_stops=[12]),
    'SR': dict(optimizer='gradient', learning_rates=[0.05, 0.02],
               learning_rate_stops=[12]),
    'ITSWO': dict(learning_rates=[1e-3, 5e-4], learning_rate_stops=[12]),
    'LogOverlapITSWO': dict(learning_rates=[1e-3, 5e-4],
                            learning_rate_stops=[12]),
}
# Kernel-alone times: (shape, sweeps a call), CUDA events over KERNEL_REPS.
KERNEL_TIMINGS = (('bench', 10), ('slice', 1), ('slice', 10))
KERNEL_REPS = 50
# The bound, the least time the card could take: ~11 f32 operations a
# hidden unit a step (Δθ, θ+Δθ, |x|, ×−2, exp, log1p, +, −log 2,
# difference, sum) at the H100 SXM's 67 TFLOP/s f32, or the bytes in and
# out at 3.35 TB/s.
OPS_PER_UNIT = 11
F32_PEAK = 67e12
HBM_RATE = 3.35e12
SR_EPOCHS = {'square66_conv_sr': 6, 'chain40_sr': 20}
SR_TIMING_REPS = 2
# 12.-15. Imaginary-time SWO and distillation.
ITSWO_EPOCHS = 20
SQUARE44_EPOCHS = 25
# The 4x4 distillation: the JAX package's distill test's rates and batches
# (tests/test_training.py), at 4x4 with an H=64 RBM student.
DISTILL = dict(num_sites=16, size_x=4, size_y=4, wavefunction_type='rbm',
               num_fc_layers=0, fc_layer_size=64, batch_size=512,
               num_batches_per_epoch=10, num_monte_carlo_sweeps=1,
               heisenberg_jx=-1.0, optimizer='adam',
               learning_rates=[1e-2, 3e-3], learning_rate_stops=[40], seed=14)
DISTILL_EPOCHS = 60
# Fidelity the JAX package reaches with DISTILL, DISTILL_EPOCHS and the
# same seed on the CPU (its generic sampler), by examples/swo_distill_bars.py;
# the port must reach each less FIDELITY_MARGIN.  The raw-L2 fits move by
# several hundredths from seed to seed in either package, so the seed is the
# one of 1-15 whose JAX fidelities sit near the middle of that spread.
JAX_FIDELITY = {'BasisIterSWO': 0.924120, 'DualSamplingSWO': 0.859464,
                'LogOverlapSWO': 0.988948, 'SWO': 0.971562}
FIDELITY_MARGIN = 0.02
DISTILL_RUN_EPOCHS = 5
# 16.-17. The complex-phase path.  Each config must descend: the mean of its
# last 10 training energies lies below the mean of its first 10 by at least
# COMPLEX_DESCENT (on the CPU the port falls +2.96 -> -2.89 on the J1-J2
# config and -4.52 -> -4.95 in 150 epochs of the twisted one), and the
# evaluated energy must not lie below ED.  No single seed's energy is held to
# a margin: by examples/twisted_chain16_bars.py (CPU, last-10 training
# means) the J1-J2 recipe ends 2.1% above E0 with the config's seed 7 in the
# port and 0.62% in the JAX package, and seeds 8, 9, 10 give the port
# 0.41%, 0.53%, 0.44% and the JAX package 0.47%, 1.68%, 0.23%; the twisted
# recipe ends on a plateau 24% above ED in both (JAX 0.24235, the port
# 0.23841 on the CPU and 0.25128 on an H100 after 350 epochs).  A bar inside
# that spread tests the random stream, not the code; the code is held by the
# single-epoch comparisons of tests/test_torch_complex.py.  The JAX
# package's relative errors are printed beside the port's.
COMPLEX_DESCENT = {'j1j2_chain8_complex_sr': 4.0, 'twisted_chain16_sr': 0.2}
JAX_COMPLEX_REL_ERR = {'j1j2_chain8_complex_sr': 0.006201,
                       'twisted_chain16_sr': 0.242352}
TWISTED_EPOCHS = 150
STIFFNESS_PHIS = (0.0, 1.2)
STIFFNESS_EPOCHS = 30
STIFFNESS_TAIL = 10
# 18. Sampler cells: (ansatz, config overrides, the fast entry's name,
# whether the acceptance rates of fast and generic are comparable).
SAMPLER_CELLS = (
    ('pbdg', {}, 'pbdg_sherman_morrison', True),
    ('jastrow', {}, 'jastrow_delta', True),
    ('mps', {'bond_dimension': 4, 'mps_incremental_sweeps': True},
     'mps_env', False),
    ('mps', {'bond_dimension': 16, 'mps_incremental_sweeps': True},
     'mps_env', False),
)
SAMPLER_WARM_SWEEPS = 2
SAMPLER_SWEEPS = 3
SAMPLER_REPS = 5
SAMPLER_ACC_TOL = 0.02
# 19. The ansatz families under SR 'dense' on the N=16 chain.
FAMILY_EPOCHS = 25
FAMILY_BASE = dict(num_sites=16, batch_size=256, num_batches_per_epoch=2,
                   num_equilibration_sweeps=4, num_monte_carlo_sweeps=1,
                   heisenberg_jx=-1.0, wavefunction_optimizer_type='SR',
                   sr_solver='dense', sr_diag_shift=1e-2, sr_delta_clip=1.0,
                   optimizer='gradient', learning_rates=[0.05],
                   learning_rate_stops=[], num_epochs=FAMILY_EPOCHS, seed=19)
FAMILIES = (
    # The MPS falls slowest (~0.03 an epoch against ~0.1 of noise): more
    # epochs, so that the check is not a coin toss.
    ('mps', dict(wavefunction_type='mps', bond_dimension=8,
                 mps_incremental_sweeps=True, num_epochs=40), 'mps_env'),
    ('pbdg', dict(wavefunction_type='pbdg'), 'pbdg_sherman_morrison'),
    ('fully_connected_nnb', dict(wavefunction_type='fully_connected_nnb',
                                 num_fc_layers=1, fc_layer_size=32),
     'generic'),
    # Its adjacency list comes from a file whose rows are (site, left,
    # right): the list made from the bonds has no self column, and on a
    # bipartite lattice neighbours of neighbours never join the sublattices.
    ('gnn', dict(wavefunction_type='gnn', num_conv_layers=2,
                 num_conv_filters=8), 'generic'),
    ('jastrow', dict(wavefunction_type='jastrow'), 'jastrow_delta'),
    ('prod', dict(wavefunction_type='prod',
                  composite_wavefunction_types=['jastrow', 'conv_1d'],
                  num_conv_layers=2, num_conv_filters=8, kernel_size=3),
     'generic'),
)
# 20.-25. More committed configs, the autoregressive ansatzes, the sampler
# knobs and the transverse-field Ising model.
DEEP_EVAL_E_PER_SITE = -0.671378   # RESULTS.md, the 10x10 "+deep" row
DEEP_EVAL_SAMPLES = 4
CHAIN20_EPOCHS = 40
QMC_10X10_E_PER_SITE = -0.671549   # Sandvik QMC, 10x10
SQUARE1010_CUT = dict(num_devices=1, num_epochs=2, num_batches_per_epoch=5,
                      num_equilibration_sweeps=10, num_evaluation_samples=10)
TRANSFORMER_EPOCHS = 3
# The unchunked vmap(grad) over 4096 samples x 16 symmetry copies of the
# transformer does not fit 80 GB; the chunk changes memory, not the rows.
TRANSFORMER_JACOBIAN_CHUNK = 1024
# The run that wrote artifacts/heisenberg_6x6_made.msgpack
# (examples/heisenberg_6x6_made.py).
MADE_6X6 = dict(num_sites=36, size_x=6, size_y=6, wavefunction_type='made',
                num_fc_layers=1, fc_layer_size=256, batch_size=1024,
                num_batches_per_epoch=4, num_equilibration_sweeps=1,
                num_monte_carlo_sweeps=1, heisenberg_jx=-1.0,
                energy_chunk_samples=256,
                wavefunction_optimizer_type='EnergyGradient',
                optimizer='adam', learning_rates=[1e-3],
                learning_rate_stops=[], seed=17)
AR_REPS = 7
AR_EPOCHS = 5
MTM_CANDIDATES = (4, 8)
PT_REPLICAS = 4
SAMPLER_KNOB_REPS = 5
TFIM_E0 = -20.40459
TFIM_REL_ERR = 1e-3
JAX_TFIM_REL_ERR = 2.4e-5          # RESULTS.md row I1
QMC_E_PER_SITE = -0.678872   # Sandvik QMC, square-lattice Heisenberg 6x6
PIN_BAND = 1e-3
PIN_SAMPLES = 'tests/data/flagship_6x6_deep48_samples.npy'
PIN_LOGPSI = 'tests/data/flagship_6x6_deep48_logpsi.npy'
# 26.-30. Measurement and dynamics, on phase 12's chain40 ITSWO run (RBM
# H=160, 2048 chains, K2) unless said otherwise.
OBS_SAMPLES = 20                   # of chain40_sr.json's 100
OBSERVABLES = ('szsz:1', 'transverse:1', 'sq:1', 'staggered_m2',
               'total_spin2')
ED_SITES = 16                      # the chain16 ED state, ed_vector
ED_MC = dict(batch_size=1024, num_equilibration_sweeps=20,
             num_monte_carlo_sweeps=2, num_evaluation_samples=60)
LANCZOS_SAMPLES = 20
DEEP48_E_PER_SITE = -0.678824      # artifacts/heisenberg_6x6_deep48 record
# deep48 Lanczos at a cut depth: 16 chains (started at the committed
# samples) x 2 samples; the moments 16 samples at a time, the inner local
# energies 128 boards at a time (128 x 72 boards a forward).
DEEP48_LANCZOS = dict(batch_size=16, num_evaluation_samples=2,
                      num_equilibration_sweeps=2, num_monte_carlo_sweeps=1)
DEEP48_OUTER_CHUNK = 16
DEEP48_INNER_CHUNK = 128
RENYI_REGIONS = ((0, 3), (0, 19))
EVOLVE_STEPS = 20
EVOLVE_DT = 0.02
TVMC_SITES = 8                     # tests/test_tvmc.py:92's quench, N=8
TVMC_T, TVMC_STEPS = 0.2, 40
# The test's bars (fidelity, energy drift) hold at N=8 as at its N=6; the
# McLachlan residual's floor, which the 1e-6 shift leaves, grows with the
# basis: 1.5e-4 at N=8 on the CPU, so its bar here is 1e-3.
TVMC_R2 = 1e-3
RESPONSE_DT = 0.05
EXCITED_EPOCHS = 5
# tests/test_artifacts.py CASES: (artifact, conv layers, filters, lattice
# side, fingerprint mean E/N over the seeded batch, band).
FINGERPRINTS = (
    ('heisenberg_6x6_deep48', 7, 48, 6, -0.678510, 0.004),
    ('heisenberg_6x6_symconv48_v2', 5, 48, 6, -0.681685, 0.004),
    ('heisenberg_6x6_symconv_v2', 5, 32, 6, -0.679797, 0.004),
    ('heisenberg_10x10_symconv_v3', 5, 32, 10, -0.655397, 0.008),
    ('heisenberg_10x10_deep32_cont', 7, 32, 10, -0.660801, 0.008),
    ('heisenberg_12x12_symconv', 5, 32, 12, -0.663586, 0.010),
    ('heisenberg_12x12_deep32', 7, 32, 12, -0.668395, 0.010),
    ('heisenberg_12x12_deep32_anneal', 7, 32, 12, -0.668431, 0.010),
)
# The fingerprints' configurations, basis.random_configurations(
# jax.random.key(1234), n_sites, n) of the JAX package, one hex bitmask a
# configuration (bit i set: spin +1 at site i).  Another random batch does
# not land in the bands; tests/test_torch_conv.py holds this table to the
# JAX draw.
FINGERPRINT_CONFIGS = {
    36: ('657122d1f', '417bb41f1', 'a5adc451b', '09b29fac3', '7500dfc8b',
         '565d063ce', '5e3eed006', '4b3a24bea', '515b504fb', 'c6c559e4c',
         '7833d9427', '7343b345a'),
    100: ('48c15d16a56fec93f89d968d0', '07d8e364b8f92957096b92b6c',
          '45819f8b5b12598f1af9670dc', '2303f6a8623dd37ad56050ff8',
          '9eb5f9c93a3e4e50c647a0a52', 'f0d829b6390e45a1d3f1b9d94',
          '0aedc73ea24411364e5ea5ece', '001e5f8bf014e95ca2bbcb1f9'),
    144: ('7d9252f19667a5c9f265ff91ca156b21a041',
          '45fea9bd81859c19c1eb2643506593f17f15',
          '65806b28aaeeaa9d42ecc336712e96b71f38',
          '84b469f192a78b2d3d1aebc92ce415c167dc',
          '4f436e95c7fcb8cc7a5f1605018809fa5ed2',
          '79496cc6958c05d38d0e4c59b8fce1535e9b'),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f'chip_smoke FAILED: {what}')


def rbm_inputs(n_sites: int, hidden: int, seed: int, device,
               chains: int = CHAINS):
    """RBM weights and Sz=0 configs made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    w = 0.1 * rng.standard_normal((n_sites, hidden))
    b = 0.1 * rng.standard_normal(hidden)
    a = 0.1 * rng.standard_normal(n_sites)
    template = np.repeat([1.0, -1.0], n_sites // 2)
    configs = np.stack([rng.permutation(template) for _ in range(chains)])
    return [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (w, b, a, configs)]


def streamed_draws(n_sites: int, n_steps: int, seed: int, device,
                   chains: int = CHAINS):
    rng = np.random.default_rng(seed)
    half = n_sites // 2
    picks = rng.integers(0, half, size=(n_steps, chains, 2))
    log_u = np.log(rng.random((n_steps, chains)))
    return (torch.tensor(picks, dtype=torch.int32, device=device),
            torch.tensor(log_u, dtype=torch.float32, device=device))


def compare(label: str, out, ref) -> float:
    """Checks a kernel result against its plain version; returns the
    largest |Δlogψ| over the chains whose trajectories agree."""
    torch.cuda.synchronize()
    chains = ref.configs.shape[0]
    same = ((out.configs == ref.configs).all(dim=1)
            & (out.num_accepted == ref.num_accepted))
    n_differ = int((~same).sum())
    require(n_differ <= (1.0 - AGREE) * chains,
            f'{label}: {n_differ} of {chains} chains differ from the plain '
            'version')
    err = (out.log_amp - ref.log_amp)[same].abs()
    bound = TOL * (1.0 + ref.log_amp[same].abs())
    theta_err = float((out.theta - ref.theta)[same].abs().max())
    max_err = float(err.max())
    print(f'{label}: {n_differ} of {chains} chains differ; '
          f'max |dlogpsi| {max_err:.3e}, max |dtheta| {theta_err:.3e}',
          flush=True)
    require(bool((err <= bound).all()) and theta_err <= TOL,
            f'{label}: logpsi/theta disagree beyond {TOL}')
    require(bool(torch.isfinite(out.log_amp).all()),
            f'{label}: non-finite logpsi')
    require(bool((out.configs.sum(dim=1) == 0).all()),
            f'{label}: a chain left the Sz=0 sector')
    return max_err


def hold_witness(label: str, out, ref, margin) -> None:
    """Requires a kernel's result to equal its lane-order witness bit for
    bit in every output on every chain.  Only after a failure, prints how
    near the witness's decisions came to the accept threshold on the
    chains that part (`margin`, the witness's least |2Δlogψ − log u|)."""
    torch.cuda.synchronize()
    differ = ((out.configs != ref.configs).any(dim=1)
              | (out.theta != ref.theta).any(dim=1)
              | (out.log_amp != ref.log_amp)
              | (out.num_accepted != ref.num_accepted))
    n_differ = int(differ.sum())
    if n_differ:
        print(f'{label}: chains {differ.nonzero()[:16, 0].tolist()} part '
              f'from the witness; its least margins on them '
              f'{margin[differ][:16].tolist()}', flush=True)
    require(n_differ == 0, f'{label}: {n_differ} of {differ.shape[0]} '
            'chains differ from the lane-order witness')


def compare_both(where: str, w, b, a, configs, n_steps: int, seed: int,
                 lanes: int, kernels, errs: dict) -> None:
    """K1 (phase 3) and K2 (phase 4) on `lanes` lanes a chain (0: the
    rule) against their lane-order witnesses on that width, bit for bit on
    every chain, and against their plain versions on the same inputs and
    draws (>= AGREE of the chains, the link to the JAX kernel)."""
    n_sites = configs.shape[1]
    width = kernels.instance(n_sites, w.shape[1], lanes)[0]
    theta = configs @ w + b
    chains = configs.shape[0]
    picks, log_u = streamed_draws(n_sites, n_steps, seed, configs.device,
                                  chains)
    out = kernels._rbm_sweeps(w, b, a, configs, picks, log_u, lanes)
    margin = torch.full((chains,), torch.inf, device=configs.device)
    hold_witness(f'phase 3 K1 vs witness, {where}', out,
                 kernels.rbm_sweeps_lanes_plain(w, b, a, configs, theta,
                                                picks, log_u, width, margin),
                 margin)
    ref = kernels.rbm_sweeps_plain(w, b, a, configs, picks, log_u)
    errs['rbm_sweeps'] = max(errs['rbm_sweeps'], compare(
        f'phase 3 K1 vs plain, {where} (witness: all {chains} chains bit '
        'for bit)', out, ref))
    seed = torch.tensor([123457 + seed], dtype=torch.int64,
                        device=configs.device)
    out = kernels._rbm_sweeps_prng(w, b, a, configs, n_steps, seed, lanes)
    margin = torch.full((chains,), torch.inf, device=configs.device)
    hold_witness(f'phase 4 K2 vs witness, {where}', out,
                 kernels.rbm_sweeps_prng_lanes_plain(
                     w, b, a, configs, theta, n_steps, seed, width, margin),
                 margin)
    ref = kernels.rbm_sweeps_prng_plain(w, b, a, configs, n_steps, seed)
    errs['rbm_sweeps_prng'] = max(errs['rbm_sweeps_prng'], compare(
        f'phase 4 K2 vs plain, {where} (witness: all {chains} chains bit '
        'for bit)', out, ref))


def sweep_bound(kernel: str, chains: int, n_sites: int, hidden: int,
                n_steps: int):
    """(seconds, 'operations' or 'bytes'): the least time the card could
    take for a sweeps call, the larger of its f32 operations over the f32
    peak and the bytes it must move (each input read once, each output
    written once; K1 also reads its draws) over the memory rate."""
    ops = chains * n_steps * hidden * OPS_PER_UNIT
    nbytes = 4 * (2 * chains * n_sites + chains * hidden + n_sites * hidden
                  + n_sites + chains)
    if kernel == 'K1':
        nbytes += 12 * n_steps * chains
    t_ops, t_bytes = ops / F32_PEAK, nbytes / HBM_RATE
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def event_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (CUDA events,
    after one warm-up launch)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def raw_launcher(lib, kernel: str, x: dict, lanes: int):
    """A function launching `kernel`'s C entry point once on the inputs x,
    on `lanes` lanes a chain (0: the rule), by the library's uncounted raw
    launch."""
    n_chains, n_sites = x['configs'].shape
    hidden, n_steps = x['w'].shape[1], x['picks'].shape[0]
    head = [x[k] for k in ('configs', 'theta', 'w', 'a')]
    outs = [x['out'], x['accepted']]
    tail = [n_chains, n_sites, hidden, n_steps, lanes]
    if kernel == 'K1':
        fn = 'rbm_sweeps_streamed_f32'
        args = head + [x['picks'], x['log_u']] + outs
    else:
        fn = 'rbm_sweeps_philox_f32'
        args = head + [x['seed'], n_sites // 2, n_sites - n_sites // 2] + outs

    def launch():
        err = lib.raw(fn, *args, *tail)
        require(err == 0, f'{kernel} launch failed with CUDA error {err}')
    return launch


def phase_kernel_times(kernels, device, card: str) -> dict:
    """7. Each kernel alone, through its C entry point, timed by CUDA
    events: the rule's width and the other width the shape allows.
    Returns {(kernel, shape, sweeps): {variant: ms}} and prints the bound
    and share beside each time."""
    resources = kernels.kernel_resources()
    lib = kernels.library()
    table = {}
    for i, (shape, sweeps) in enumerate(KERNEL_TIMINGS):
        n_sites, hidden = SHAPES[shape]
        n_steps = sweeps * n_sites
        w, b, a, configs = rbm_inputs(n_sites, hidden, 50 + i, device)
        picks, log_u = streamed_draws(n_sites, n_steps, 60 + i, device)
        x = {'configs': configs, 'theta': configs @ w + b, 'w': w, 'a': a,
             'picks': picks, 'log_u': log_u,
             'seed': torch.tensor([7], dtype=torch.int64, device=device),
             'out': torch.empty_like(configs),
             'accepted': torch.empty(CHAINS, device=device)}
        rule = kernels.instance(n_sites, hidden)[0]
        widths = [g for g in kernels.LANES
                  if -(-hidden // g) <= kernels.MAX_UNITS_PER_LANE]
        for kernel in ('K1', 'K2'):
            bound, bound_by = sweep_bound(kernel, CHAINS, n_sites, hidden,
                                          n_steps)
            variants = [(f'rule G={rule}', 0)] + [
                (f'G={g}', g) for g in widths if g != rule]
            times = {}
            for label, lanes in variants:
                ms = event_ms(raw_launcher(lib, kernel, x, lanes),
                              KERNEL_REPS)
                times[label] = ms
                rec = resources.get((kernel, *kernels.instance(
                    n_sites, hidden, lanes)), {})
                res = (f', {rec.get("registers")} registers, spills '
                       f'{rec.get("spill_stores")}/'
                       f'{rec.get("spill_loads")} B')
                print(f'phase 7 kernel alone {kernel} {shape} N={n_sites} '
                      f'H={hidden} {CHAINS} chains {sweeps} sweeps, '
                      f'{label}: {ms:.4f} ms ({sweeps / ms * 1e3:.1f} '
                      f'sweeps/s); bound {bound * 1e3:.5f} ms '
                      f'({bound_by}), {bound * 1e3 / ms:.2%} of it{res} '
                      f'{card}', flush=True)
            table[(kernel, shape, sweeps)] = times
    return table


def time_call(fn, reps: int) -> float:
    """Mean seconds of fn() over reps calls, synchronized inside."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / reps


class EpochTimer:
    """MetricsLogger stand-in: keeps each epoch's metrics and wall time, and
    prints every `every`-th epoch's."""

    def __init__(self, label: str = 'train', every: int = 1):
        self.records = []
        self.label = label
        self.every = every
        torch.cuda.synchronize()
        self._last = time.perf_counter()

    def log(self, epoch, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        record = {k: float(v) for k, v in metrics.items()}
        record['epoch'] = epoch
        record['epoch_time_s'] = now - self._last
        self._last = now
        self.records.append(record)
        if epoch % self.every == 0:
            values = ' '.join(f'{k}={v:.6g}' for k, v in metrics_items(
                record))
            print(f'{self.label} epoch {epoch}: {values} '
                  f't={record["epoch_time_s"]:.4f}s', flush=True)

    def mean_epoch_ms(self) -> float:
        """Mean wall time of the epochs after the first, in ms."""
        return float(np.mean([r['epoch_time_s']
                              for r in self.records[1:]])) * 1e3


def metrics_items(record: dict):
    return [(k, v) for k, v in record.items()
            if k not in ('epoch', 'epoch_time_s')]


def fresh_run_dir(repo: str, name: str) -> str:
    """build/{name}, emptied of an earlier run's files."""
    path = os.path.join(repo, 'build', name)
    for old in (os.listdir(path) if os.path.isdir(path) else []):
        os.remove(os.path.join(path, old))
    return path


def timed(fn):
    """(fn(), seconds), synchronized on both sides."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def fingerprint_configs(n_sites: int) -> np.ndarray:
    """FINGERPRINT_CONFIGS[n_sites] as a [n, n_sites] ±1 float32 array."""
    return np.array([[1.0 if int(mask, 16) >> i & 1 else -1.0
                      for i in range(n_sites)]
                     for mask in FINGERPRINT_CONFIGS[n_sites]], np.float32)


def conv_config(layers: int, filters: int, side: int, **overrides):
    """The symmetrized conv_2d of the artifacts on the side × side torus."""
    from cgs_vmc_tpu_torch.config import Config
    return Config(num_sites=side * side, size_x=side, size_y=side,
                  wavefunction_type='conv_2d', num_conv_layers=layers,
                  num_conv_filters=filters, kernel_size=3, symmetrize=True,
                  heisenberg_jx=-1.0, **overrides)


def load_artifact(repo: str, name: str, config, device):
    """(wavefunction, params on `device`) of artifacts/{name}.msgpack."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.utils import checkpoint
    wf = models.build_wavefunction(config)
    return wf, checkpoint.restore_params_only(
        os.path.join(repo, 'artifacts', f'{name}.msgpack'),
        wf.init(torch.Generator(device=device)))


def square_hamiltonian(side: int, sample_chunk: int = 0):
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    return HeisenbergHamiltonian(lattice.square_lattice_bonds(side, side),
                                 -1.0, 1.0, sample_chunk=sample_chunk)


def phase_artifacts(repo: str, device) -> None:
    """8. The deep48 pin (drift, weighted E/N) and the fingerprints."""
    start = time.perf_counter()
    wf, params = load_artifact(repo, 'heisenberg_6x6_deep48',
                               conv_config(7, 48, 6), device)
    samples = torch.tensor(np.load(os.path.join(repo, PIN_SAMPLES)),
                           dtype=torch.float32, device=device)
    log_ref = np.load(os.path.join(repo, PIN_LOGPSI))
    with torch.no_grad():
        log_new = wf.apply(params, samples).log.double().cpu().numpy()
        e_loc = square_hamiltonian(6, sample_chunk=64).local_value(
            wf, params, samples).double().cpu().numpy()
    drift = float(np.max(np.abs(log_new - log_ref)))
    shift = log_new - log_ref
    weights = np.exp(2.0 * (shift - shift.max()))
    e_pin = float((weights / weights.sum() * e_loc).sum()) / 36
    print(f'phase 8 deep48 pin: {len(log_ref)} samples, max |dlogpsi| '
          f'{drift:.3e}, weighted E/N {e_pin:.6f} (QMC {QMC_E_PER_SITE}, '
          f'band {PIN_BAND})', flush=True)
    require(drift < PIN_BAND, f'deep48 logpsi drift {drift}')
    require(abs(e_pin - QMC_E_PER_SITE) < PIN_BAND,
            f'deep48 weighted E/N {e_pin} off QMC')
    for name, layers, filters, side, expected, band in FINGERPRINTS:
        wf, params = load_artifact(repo, name,
                                   conv_config(layers, filters, side), device)
        configs = torch.tensor(fingerprint_configs(side * side),
                               device=device)
        with torch.no_grad():
            e_loc = square_hamiltonian(side).local_value(
                wf, params, configs).double().cpu().numpy() / side ** 2
        mean, std = float(e_loc.mean()), float(e_loc.std())
        print(f'phase 8 fingerprint {name}: E/N {mean:.6f} (recorded '
              f'{expected}, band {band}), std {std:.4f}', flush=True)
        require(bool(np.isfinite(e_loc).all()), f'{name}: non-finite E_loc')
        require(abs(mean - expected) < band, f'{name}: fingerprint drifted')
        require(std < 0.06, f'{name}: local-energy std {std} blown up')
    print(f'phase 8 wall time {time.perf_counter() - start:.2f} s',
          flush=True)


def phase_eval(repo: str, device) -> None:
    """9. evaluate_operator on deep48, 512 chains started at the
    committed samples (drawn from |psi|^2), 50 measurements."""
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.utils import interop
    start = time.perf_counter()
    configs = np.load(os.path.join(repo, PIN_SAMPLES))
    config = conv_config(7, 48, 6, batch_size=len(configs),
                         num_equilibration_sweeps=5,
                         num_evaluation_samples=50,
                         num_monte_carlo_sweeps=2)
    wf, params = load_artifact(repo, 'heisenberg_6x6_deep48', config, device)
    state = interop.sampler_state_from_numpy(
        configs, np.zeros(len(configs)), np.ones(len(configs)), device,
        seed=9)
    result = evaluate_operator(wf, params,
                               square_hamiltonian(6, sample_chunk=128),
                               config, device, state=state)
    e, err = result.mean / 36, result.error / 36
    print(f'phase 9 deep48 evaluation: E/N = {e:.6f} +/- {err:.6f} '
          f'(QMC {QMC_E_PER_SITE}), acceptance '
          f'{result.acceptance_rate:.4f}, wall time '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    require(np.isfinite(e) and np.isfinite(err), 'non-finite deep48 E/N')
    require(abs(e - QMC_E_PER_SITE) < PIN_BAND + 5 * err,
            f'deep48 evaluation E/N {e} off QMC')


def phase_sr_train(repo: str, device, name: str, epochs: int):
    """10. `train` on configs/{name}.json, unmodified but for num_epochs
    and the checkpoint directory.  Returns (config, final state, timer)."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import train
    start = time.perf_counter()
    config = Config.load(os.path.join(repo, 'configs', f'{name}.json'))
    config = config.replace(num_epochs=epochs, checkpoint_dir=fresh_run_dir(
        repo, f'chip_smoke_{name}'))
    timer = EpochTimer()
    state = train(config, device, logger=timer)
    energies = [r['energy'] for r in timer.records]
    residuals = [r['sr_residual_norm'] for r in timer.records]
    acc = timer.records[-1]['acceptance_rate']
    print(f'phase 10 SR train {name}: {len(energies)} epochs, E first '
          f'{energies[0]:.6f}, mean of last 3 {np.mean(energies[-3:]):.6f}, '
          f'acceptance {acc:.4f}, wall time '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    require(len(energies) == epochs and all(np.isfinite(energies)),
            f'{name}: non-finite SR training energy')
    require(np.mean(energies[-3:]) < energies[0],
            f'{name}: SR training energy did not fall')
    require(all(np.isfinite(residuals)), f'{name}: non-finite SR residual')
    require(0.05 < acc < 0.98, f'{name}: implausible acceptance rate {acc}')
    return config, state, timer


def phase_sr_times(config, state) -> dict:
    """11. The SR epoch's wall time and its parts, each synchronized, mean
    of SR_TIMING_REPS runs after the training epochs."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.models.base import tree_leaves
    from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    wf = models.build_wavefunction(config)
    ham = build_hamiltonian(config)
    opt = StochasticReconfiguration(wf, ham, config)
    params = state.params
    times = {k: 0.0 for k in ('sr_epoch_wall_s', 'sampling_s',
                              'local_energy_s', 'jacobian_s', 'solve_s')}

    def energies(configs):
        with torch.no_grad():
            return ham.local_value(wf, params, configs,
                                   wf.apply(params, configs))

    for _ in range(SR_TIMING_REPS):
        _, t_epoch = timed(lambda: opt.epoch(state))
        (_, configs), t_sample = timed(
            lambda: opt.sample(params, state.sampler))
        e_loc, t_energy = timed(lambda: energies(configs))
        (jac, _), t_jac = timed(
            lambda: opt._centered_jacobian(configs, params))
        _, t_solve = timed(lambda: opt._solve_sample_space(
            jac, e_loc - torch.mean(e_loc)))
        del jac
        for key, t in zip(times, (t_epoch, t_sample, t_energy, t_jac,
                                  t_solve)):
            times[key] += t / SR_TIMING_REPS
    times['samples'] = int(configs.shape[0])
    times['params'] = sum(p.numel() for p in tree_leaves(params))
    return times


def phase_itswo(repo: str, device, kernels, card: str) -> str:
    """12. ITSWO and LogOverlapITSWO through `train` on chain40 (adam 1e-3,
    square44_itswo.json's first rate), the counts zeroed before each run.
    Returns the ITSWO run directory (phase 15's supervisor)."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import train
    run_dirs = {}
    for name in ('ITSWO', 'LogOverlapITSWO'):
        config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
        config = config.parse(
            f'wavefunction_optimizer_type={name},optimizer=adam,'
            'learning_rates=[1e-3],learning_rate_stops=[],'
            f'num_epochs={ITSWO_EPOCHS}')
        config = config.replace(checkpoint_dir=fresh_run_dir(
            repo, f'chip_smoke_{name}'))
        timer = EpochTimer(f'phase 12 {name}')
        profiling.reset_counters('k1.launches', 'k2.launches')
        train(config, device, logger=timer)
        launches = profiling.counter('k2.launches')
        energies = [r['energy'] for r in timer.records]
        acc = timer.records[-1]['acceptance_rate']
        expected = 1 + config.num_batches_per_epoch
        print(f'phase 12 {name} chain40 (RBM H=160, {config.batch_size} '
              f'chains x {config.num_batches_per_epoch} batches, beta '
              f'{config.time_evolution_beta}): {len(energies)} epochs, E '
              f'first {energies[0]:.6f}, mean of last 3 '
              f'{np.mean(energies[-3:]):.6f}, acceptance {acc:.4f}; K2 '
              f'launches {launches} ({launches / ITSWO_EPOCHS:g} an epoch, '
              f'expected {expected}); mean epoch {timer.mean_epoch_ms():.2f} '
              f'ms over epochs 2-{ITSWO_EPOCHS} {card}', flush=True)
        require(len(energies) == ITSWO_EPOCHS and all(np.isfinite(energies)),
                f'{name}: non-finite energy')
        require(np.mean(energies[-3:]) < energies[0],
                f'{name}: energy did not fall')
        require(0.05 < acc < 0.98, f'{name}: implausible acceptance {acc}')
        require(launches == expected * ITSWO_EPOCHS,
                f'{name}: K2 launched {launches} times, expected '
                f'{expected * ITSWO_EPOCHS}')
        run_dirs[name] = config.checkpoint_dir
    return run_dirs['ITSWO']


def phase_square44(repo: str, device, kernels, card: str) -> None:
    """13. configs/square44_itswo.json, unmodified but for the epochs."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import train
    config = Config.load(os.path.join(repo, 'configs', 'square44_itswo.json'))
    config = config.replace(num_epochs=SQUARE44_EPOCHS,
                            checkpoint_dir=fresh_run_dir(
                                repo, 'chip_smoke_square44_itswo'))
    timer = EpochTimer('phase 13 square44_itswo', every=10)
    profiling.reset_counters('k1.launches', 'k2.launches')
    train(config, device, logger=timer)
    energies = [r['energy'] for r in timer.records]
    print(f'phase 13 square44_itswo (conv_2d {config.num_conv_layers}x'
          f'{config.num_conv_filters}, {config.batch_size} chains x '
          f'{config.num_batches_per_epoch} batches, generic sampler): '
          f'{len(energies)} epochs, E first {energies[0]:.6f}, mean of last '
          f'3 {np.mean(energies[-3:]):.6f}, acceptance '
          f'{timer.records[-1]["acceptance_rate"]:.4f}, K2 launches '
          f'{profiling.counter("k2.launches")}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms over epochs 2-{SQUARE44_EPOCHS} '
          f'{card}', flush=True)
    require(len(energies) == SQUARE44_EPOCHS and all(np.isfinite(energies)),
            'square44_itswo: non-finite energy')
    require(np.mean(energies[-3:]) < energies[0],
            'square44_itswo: energy did not fall')


def phase_distill_exact(device, kernels, card: str) -> None:
    """14. The four supervised optimizers distill the 4x4 ED ground state
    into an RBM through `distill`; each reaches its JAX bar."""
    from cgs_vmc_tpu_torch import basis, lattice, models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import (evaluate_vector,
                                            overlap_with_vector)
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.optim import SUPERVISED_OPTIMIZERS
    from cgs_vmc_tpu_torch.train import distill
    from cgs_vmc_tpu_torch.utils import ed
    start = time.perf_counter()
    e0, v0 = ed.ground_state(16, lattice.square_lattice_bonds(4, 4),
                             j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    target = FullVector.for_sector(16, vector)
    target_params = {'ed_vector': torch.tensor(vector, device=device)}
    states = basis.enumerate_sz_basis(16)
    print(f'phase 14 target: 4x4 ED E0 = {e0:.6f}, {len(states)} states, '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    for name in sorted(SUPERVISED_OPTIMIZERS):
        config = Config(**DISTILL, wavefunction_optimizer_type=name,
                        num_epochs=DISTILL_EPOCHS)
        timer = EpochTimer(f'phase 14 {name}', every=20)
        profiling.reset_counters('k1.launches', 'k2.launches')
        state = distill(config, device, target_params=target_params,
                        target_wf=target, logger=timer)
        launches = profiling.counter('k2.launches')
        wf = models.build_wavefunction(config)
        fidelity = overlap_with_vector(
            evaluate_vector(wf, state.params, config, basis_array=states),
            vector)
        bar = JAX_FIDELITY[name] - FIDELITY_MARGIN
        last = ' '.join(f'{k}={v:.6g}'
                        for k, v in metrics_items(timer.records[-1]))
        expected = (0 if name == 'BasisIterSWO'
                    else DISTILL_EPOCHS * config.num_batches_per_epoch)
        print(f'phase 14 {name}: fidelity {fidelity:.6f} (JAX on the CPU '
              f'{JAX_FIDELITY[name]:.6f}, bar {bar:.6f}); last epoch {last}; '
              f'K2 launches {launches} (expected {expected}); mean epoch '
              f'{timer.mean_epoch_ms():.2f} ms {card}', flush=True)
        require(np.isfinite(fidelity) and fidelity >= bar,
                f'{name}: fidelity {fidelity} below its bar {bar}')
        require(launches == expected,
                f'{name}: K2 launched {launches} times, expected {expected}')


def phase_distill_run(repo: str, device, kernels, supervisor_dir: str,
                      card: str) -> None:
    """15. `distill` from phase 12's ITSWO run directory (the CLI's path),
    then `evaluate_operator` on the student."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.train import build_hamiltonian, distill
    from cgs_vmc_tpu_torch.utils import checkpoint
    config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
    config = config.parse(
        'wavefunction_optimizer_type=LogOverlapSWO,optimizer=adam,'
        'learning_rates=[1e-2],learning_rate_stops=[],'
        f'num_epochs={DISTILL_RUN_EPOCHS}')
    config = config.replace(
        supervisor_dir=supervisor_dir,
        checkpoint_dir=fresh_run_dir(repo, 'chip_smoke_distill'))
    timer = EpochTimer('phase 15 distill')
    profiling.reset_counters('k1.launches', 'k2.launches')
    state = distill(config, device, logger=timer)
    launches = profiling.counter('k2.launches')
    ratios = [r['mean_ratio'] for r in timer.records]
    latest = checkpoint.latest_checkpoint(config.checkpoint_dir)
    result = evaluate_operator(models.build_wavefunction(config),
                               state.params, build_hamiltonian(config),
                               config, device)
    n = config.num_sites
    e, err = result.mean / n, result.error / n
    print(f'phase 15 distill LogOverlapSWO from {supervisor_dir} (RBM H='
          f'{config.fc_layer_size}, {config.batch_size} chains, '
          f'{DISTILL_RUN_EPOCHS} epochs): mean_ratio {ratios}, K2 launches '
          f'{launches} ({launches / DISTILL_RUN_EPOCHS:g} an epoch), '
          f'checkpoint {latest}; student E/N = {e:.6f} +/- '
          f'{err:.6f}, acceptance {result.acceptance_rate:.4f}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms {card}', flush=True)
    require(all(np.isfinite(ratios)), 'distill: non-finite mean_ratio')
    expected = DISTILL_RUN_EPOCHS * config.num_batches_per_epoch
    require(launches == expected,
            f'distill launched K2 {launches} times, expected {expected}')
    require(latest is not None
            and checkpoint.checkpoint_epoch(latest) == DISTILL_RUN_EPOCHS,
            'distill wrote no final checkpoint')
    require(np.isfinite(e) and np.isfinite(err), 'non-finite student E/N')
    require(e >= BETHE_E_PER_SITE - 5 * err,
            f'student E/N {e} below the variational bound')


def exact_energy(hamiltonian, n_sites: int) -> float:
    """ED ground energy (Sz=0 sector) of the Hamiltonian a config builds:
    its bonds, couplings and twist phases."""
    from cgs_vmc_tpu_torch.utils import ed
    return ed.ground_state(
        n_sites, hamiltonian.bonds, j_x=hamiltonian.j_x, j_z=hamiltonian.j_z,
        couplings=hamiltonian.couplings,
        offdiag_couplings=hamiltonian.offdiag_couplings,
        twist_phases=hamiltonian.twist_phases)[0]


def phase_complex_config(repo: str, device, phase: int, name: str, card: str,
                         epochs: int = 0) -> str:
    """16.-17. configs/{name}.json unmodified (but for `epochs`, when
    given) through `train`, then `evaluate_operator`: the training energy
    descends and the evaluated one is not below ED.  Returns the run
    directory (phase 29 evolves phase 16's)."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.sampler import registry
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    start = time.perf_counter()
    config = Config.load(os.path.join(repo, 'configs', f'{name}.json'))
    config = config.replace(
        num_epochs=epochs or config.num_epochs,
        checkpoint_dir=fresh_run_dir(repo, f'chip_smoke_{name}'))
    timer = EpochTimer(f'phase {phase} {name}', every=50)
    state = train(config, device, logger=timer)
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    result = evaluate_operator(wf, state.params, hamiltonian, config, device)
    e0 = exact_energy(hamiltonian, config.num_sites)
    energies = [r['energy'] for r in timer.records]
    head, tail = (float(np.mean(e)) for e in (energies[:10], energies[-10:]))
    rel = (result.mean - e0) / abs(e0)
    samples = config.batch_size * config.num_batches_per_epoch
    print(f'phase {phase} {name} (complex('
          f'{" x ".join(config.composite_wavefunction_types)}), '
          f'{config.batch_size} chains x {config.num_batches_per_epoch} '
          f'batches, dense SR on [{2 * samples}, {2 * samples}], twist '
          f'{getattr(config, "twist_phi", 0.0)}, sampler '
          f'{registry.resolved_name(wf, config)}): {len(energies)} epochs, '
          f'mean of the first 10 {head:.6f}, of the last 10 {tail:.6f} '
          f'(descent bar {COMPLEX_DESCENT[name]}); evaluated '
          f'E = {result.mean:.6f} +/- {result.error:.6f}, ED {e0:.6f}, rel '
          f'err {rel:.5f} (the JAX package on the CPU: '
          f'{JAX_COMPLEX_REL_ERR[name]:.5f}), log_amp dtype '
          f'{state.sampler.log_amp.dtype}, acceptance '
          f'{result.acceptance_rate:.4f}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms {card}; wall time '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    require(len(energies) == config.num_epochs
            and all(np.isfinite(energies)), f'{name}: non-finite energy')
    require(state.sampler.log_amp.dtype == torch.complex64,
            f'{name}: the sampler state lost its complex log')
    require(np.isfinite(result.mean) and np.isfinite(result.error),
            f'{name}: non-finite evaluated energy')
    require(result.mean >= e0 - 5 * result.error,
            f'{name}: evaluated E {result.mean} below the ED energy {e0}')
    require(head - tail >= COMPLEX_DESCENT[name],
            f'{name}: the training energy fell {head - tail}, less than '
            f'{COMPLEX_DESCENT[name]}')
    return config.checkpoint_dir


def phase_stiffness(device, card: str) -> None:
    """17. The spin-stiffness ansatz at phi = 0 and 1.2 through `train`
    (cold starts, a smoke depth: the example's own is 800 + 320 warm
    epochs); the energy difference beside twisted ED's, not gated."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    found = {}
    for phi in STIFFNESS_PHIS:
        config = Config(
            num_sites=16, wavefunction_type='complex',
            composite_wavefunction_types=['rbm', 'fully_connected'],
            num_fc_layers=1, fc_layer_size=48, batch_size=512,
            num_batches_per_epoch=2, num_equilibration_sweeps=4,
            num_monte_carlo_sweeps=1, learning_rates=[0.05, 0.02],
            learning_rate_stops=[STIFFNESS_EPOCHS // 2],
            optimizer='gradient', heisenberg_jx=-1.0, sr_diag_shift=1e-3,
            sr_solver='dense', sr_delta_clip=1.0, twist_phi=phi,
            wavefunction_optimizer_type='SR', num_epochs=STIFFNESS_EPOCHS,
            seed=3)
        timer = EpochTimer(f'phase 17 stiffness phi={phi}',
                           every=STIFFNESS_EPOCHS)
        train(config, device, logger=timer)
        tail = np.array([r['energy']
                         for r in timer.records[-STIFFNESS_TAIL:]])
        found[phi] = (float(tail.mean()), float(
            tail.std() / np.sqrt(len(tail))),
            exact_energy(build_hamiltonian(config), 16),
            timer.mean_epoch_ms())
        require(bool(np.isfinite(tail).all()),
                f'stiffness phi={phi}: non-finite energy')
    (e_a, err_a, ed_a, ms_a), (e_b, err_b, ed_b, ms_b) = (
        found[phi] for phi in STIFFNESS_PHIS)
    print(f'phase 17 spin stiffness, complex(rbm x fc 48), N=16, 512 chains '
          f'x 2, {STIFFNESS_EPOCHS} epochs each (tail {STIFFNESS_TAIL}): '
          f'E(0) = {e_a:.5f} +/- {err_a:.5f} (ED {ed_a:.5f}), '
          f'E({STIFFNESS_PHIS[1]}) = {e_b:.5f} +/- {err_b:.5f} (ED '
          f'{ed_b:.5f}); dE = {e_b - e_a:+.5f} +/- '
          f'{np.hypot(err_a, err_b):.5f}, twisted ED dE = '
          f'{ed_b - ed_a:+.5f}; mean epoch {ms_a:.2f} / {ms_b:.2f} ms '
          f'{card}', flush=True)


def phase_sampler_cells(device, card: str) -> None:
    """18. Generic against incremental sweeps at 6x6, 2048 chains.  The two
    samplers of a cell take turns, SAMPLER_REPS timed calls each, and the
    median rate is the cell's: the calls are host-bound, and the host's
    speed drifts more between seconds than the samplers differ."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.sampler import metropolis, registry
    for wf_type, extra, fast_name, same_move in SAMPLER_CELLS:
        config = Config(num_sites=36, size_x=6, size_y=6,
                        wavefunction_type=wf_type, batch_size=CHAINS, **extra)
        generic = config.replace(use_fast_sampler=False,
                                 mps_incremental_sweeps=False)
        wf = models.build_wavefunction(config)
        params = wf.init(torch.Generator(device=device).manual_seed(18))
        sweeps, states, rates = {}, {}, {}
        for label, cfg in (('generic', generic), (fast_name, config)):
            require(registry.resolved_name(wf, cfg) == label,
                    f'{wf_type}: the registry resolved '
                    f'{registry.resolved_name(wf, cfg)}, not {label}')
            sweeps[label] = registry.resolve_sweeps_fn(wf, cfg)
            state = metropolis.init_sampler_for(18, wf, params, cfg, device)
            states[label] = metropolis.reset_stats(
                sweeps[label](params, state, SAMPLER_WARM_SWEEPS))
            rates[label] = []
        for _ in range(SAMPLER_REPS):
            for label in sweeps:
                states[label], seconds = timed(lambda: sweeps[label](
                    params, states[label], SAMPLER_SWEEPS))
                rates[label].append(SAMPLER_SWEEPS / seconds)
                state = states[label]
                with torch.no_grad():
                    fresh = wf.apply(params, state.configs)
                gap = float(((state.log_amp - fresh.log).abs()
                             / (1.0 + fresh.log.abs())).max())
                require(gap <= TOL and torch.equal(state.sign, fresh.sign),
                        f'{wf_type} {label}: cached logpsi off a fresh '
                        f'forward by {gap}')
                require(bool((state.configs.sum(dim=1) == 0).all()),
                        f'{wf_type} {label}: a chain left the Sz=0 sector')
        accs = {label: float(metropolis.acceptance_rate(state))
                for label, state in states.items()}
        rate = {label: float(np.median(r)) for label, r in rates.items()}
        detail = ', '.join(f'{k}={v}' for k, v in extra.items()
                           if k != 'mps_incremental_sweeps')
        print(f'phase 18 sampler cell {wf_type}{" " + detail if detail else ""}'
              f', N=36, {CHAINS} chains, median of {SAMPLER_REPS} calls of '
              f'{SAMPLER_SWEEPS} sweeps taken in turns: generic '
              f'{rate["generic"]:.2f} sweeps/s (acceptance '
              f'{accs["generic"]:.4f}; calls '
              f'{", ".join(f"{r:.2f}" for r in rates["generic"])}), '
              f'{fast_name} {rate[fast_name]:.2f} sweeps/s (acceptance '
              f'{accs[fast_name]:.4f}; calls '
              f'{", ".join(f"{r:.2f}" for r in rates[fast_name])}), ratio '
              f'{rate[fast_name] / rate["generic"]:.2f}x {card}', flush=True)
        for label, acc in accs.items():
            require(0.0 < acc < 1.0, f'{wf_type} {label}: acceptance {acc}')
        if same_move:
            require(abs(accs['generic'] - accs[fast_name]) < SAMPLER_ACC_TOL,
                    f'{wf_type}: acceptance of {fast_name} differs from the '
                    f'generic sampler\'s by more than {SAMPLER_ACC_TOL}')


def phase_families(repo: str, device, card: str) -> None:
    """19. One short SR run through `train` for each ansatz family."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.sampler import registry
    from cgs_vmc_tpu_torch.train import train
    n = FAMILY_BASE['num_sites']
    adjacency = os.path.join(repo, 'build', 'chip_smoke_adjacency.txt')
    os.makedirs(os.path.dirname(adjacency), exist_ok=True)
    np.savetxt(adjacency, [[s, (s - 1) % n, (s + 1) % n] for s in range(n)],
               fmt='%d')
    for label, overrides, sampler in FAMILIES:
        config = Config(**{**FAMILY_BASE, **overrides})
        if label == 'gnn':
            config = config.replace(adjacency_list_path=adjacency)
        resolved = registry.resolved_name(models.build_wavefunction(config),
                                          config)
        require(resolved == sampler,
                f'{label}: the registry resolved {resolved}, not {sampler}')
        timer = EpochTimer(f'phase 19 {label}', every=config.num_epochs)
        train(config, device, logger=timer)
        energies = [r['energy'] for r in timer.records]
        print(f'phase 19 {label} (N=16 chain, SR dense, {config.batch_size} '
              f'chains x {config.num_batches_per_epoch}, sampler {resolved}):'
              f' {len(energies)} epochs, E first {energies[0]:.6f}, mean of '
              f'last 3 {np.mean(energies[-3:]):.6f}, acceptance '
              f'{timer.records[-1]["acceptance_rate"]:.4f}; mean epoch '
              f'{timer.mean_epoch_ms():.2f} ms {card}', flush=True)
        require(len(energies) == config.num_epochs
                and all(np.isfinite(energies)),
                f'{label}: non-finite SR training energy')
        require(np.mean(energies[-3:]) < energies[0],
                f'{label}: SR training energy did not fall')


def count_launches(fn):
    """(fn(), device launches, device-busy seconds) of one profiled call:
    every kernel and copy the card ran while fn did."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, len(events), sum(e.time_range.elapsed_us()
                                 for e in events) * 1e-6


def device_busy(fn):
    """(fn(), device events, seconds the card was busy): the union of the
    intervals of every kernel, copy and memset the card ran while fn did
    (a graph replay's kernels are events too)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float('-inf')
    for start, stop in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return out, len(spans), busy * 1e-6


def spread(values, digits: int = 2) -> str:
    """'median (min-max)' of host-clock values."""
    return (f'{np.median(values):.{digits}f} ({min(values):.{digits}f}-'
            f'{max(values):.{digits}f})')


def phase_deep_eval(repo: str, device, card: str) -> None:
    """20. The 10x10 headline evaluation at a cut depth: the committed
    config (split_eval and all) on its committed artifact."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    config = Config.load(os.path.join(repo, 'configs',
                                      'square1010_deep_eval.json'))
    require(config.split_eval, 'square1010_deep_eval.json lost split_eval')
    config = config.replace(num_evaluation_samples=DEEP_EVAL_SAMPLES)
    wf, params = load_artifact(repo, 'heisenberg_10x10_deep32_cont', config,
                               device)
    result, seconds = timed(lambda: evaluate_operator(
        wf, params, build_hamiltonian(config), config, device))
    n = config.num_sites
    e, err = result.mean / n, result.error / n
    print(f'phase 20 square1010_deep_eval (conv_2d {config.num_conv_layers}x'
          f'{config.num_conv_filters}, symmetrized, {config.batch_size} '
          f'chains, {config.num_equilibration_sweeps} equilibration sweeps, '
          f'{DEEP_EVAL_SAMPLES} samples of the config\'s '
          f'400, split_eval {config.split_eval}): E/N = {e:.6f} +/- '
          f'{err:.6f} (recorded {DEEP_EVAL_E_PER_SITE}), acceptance '
          f'{result.acceptance_rate:.4f}, {seconds:.2f} s {card}', flush=True)
    require(np.isfinite(e) and np.isfinite(err), 'non-finite 10x10 E/N')
    require(abs(e - DEEP_EVAL_E_PER_SITE) <= max(5 * err, 1e-3),
            f'10x10 deep evaluation E/N {e} off the recorded value')


def phase_unrun_configs(repo: str, device, card: str) -> None:
    """21. The two committed configs that had never run in the port."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    config = Config.load(os.path.join(repo, 'configs',
                                      'chain20_fc_energy.json'))
    config = config.replace(num_epochs=CHAIN20_EPOCHS)
    timer = EpochTimer('phase 21 chain20_fc_energy', every=CHAIN20_EPOCHS)
    train(config, device, logger=timer)
    energies = [r['energy'] for r in timer.records]
    print(f'phase 21 chain20_fc_energy (fully_connected '
          f'{config.num_fc_layers}x{config.fc_layer_size}, EnergyGradient, '
          f'{config.batch_size} chains x {config.num_batches_per_epoch}): '
          f'{CHAIN20_EPOCHS} of 400 epochs, E first {energies[0]:.6f}, mean '
          f'of last 3 {np.mean(energies[-3:]):.6f}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms {card}', flush=True)
    require(all(np.isfinite(energies)), 'chain20_fc_energy: non-finite energy')
    require(np.mean(energies[-3:]) < energies[0],
            'chain20_fc_energy: energy did not fall')

    config = Config.load(os.path.join(repo, 'configs',
                                      'square1010_eval.json'))
    config = config.replace(**SQUARE1010_CUT)
    timer = EpochTimer('phase 21 square1010_eval')
    state = train(config, device, logger=timer)
    result, seconds = timed(lambda: evaluate_operator(
        models.build_wavefunction(config), state.params,
        build_hamiltonian(config), config, device))
    n = config.num_sites
    e, err = result.mean / n, result.error / n
    print(f'phase 21 square1010_eval (conv_2d {config.num_conv_layers}x'
          f'{config.num_conv_filters}, ITSWO, {config.batch_size} chains, '
          f'cut to {SQUARE1010_CUT}): training E/N '
          f'{[round(r["energy"] / n, 6) for r in timer.records]}, evaluated '
          f'E/N = {e:.6f} +/- {err:.6f} (QMC {QMC_10X10_E_PER_SITE}), '
          f'acceptance {result.acceptance_rate:.4f}; mean epoch '
          f'{timer.mean_epoch_ms():.2f} ms, evaluation {seconds:.2f} s '
          f'{card}', flush=True)
    require(np.isfinite(e) and np.isfinite(err),
            'square1010_eval: non-finite E/N')
    require(e >= QMC_10X10_E_PER_SITE - 5 * err,
            f'square1010_eval: E/N {e} below the QMC energy')


def phase_transformer(repo: str, device, card: str) -> None:
    """22. The transformer: its artifact on one batch, then the committed
    SR config for a few epochs."""
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.models.base import tree_leaves
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    config = Config.load(os.path.join(repo, 'configs',
                                      'square66_transformer_sr.json'))
    wf, params = load_artifact(repo, 'heisenberg_6x6_transformer', config,
                               device)
    n = config.num_sites
    result, seconds = timed(lambda: evaluate_operator(
        wf, params, build_hamiltonian(config),
        config.replace(num_evaluation_samples=2), device))
    e = result.mean / n
    print(f'phase 22 transformer artifact ({config.num_attention_layers} '
          f'layers, d={config.attention_dim}, {config.num_attention_heads} '
          f'heads, symmetrized, '
          f'{sum(p.numel() for p in tree_leaves(params))} params; '
          f'{config.batch_size} chains, {config.num_equilibration_sweeps} '
          f'equilibration sweeps, 2 batches): E/N = {e:.6f} +/- '
          f'{result.error / n:.6f} (QMC {QMC_E_PER_SITE}; an epoch-100 '
          f'snapshot), acceptance {result.acceptance_rate:.4f}, '
          f'{seconds:.2f} s {card}', flush=True)
    require(np.isfinite(e), 'transformer artifact: non-finite E/N')
    require(QMC_E_PER_SITE - 1e-3 - 5 * result.error / n <= e < -0.55,
            f'transformer artifact: E/N {e} is not a trained net\'s')

    config = config.replace(num_epochs=TRANSFORMER_EPOCHS,
                            sr_jacobian_chunk=TRANSFORMER_JACOBIAN_CHUNK,
                            checkpoint_dir=fresh_run_dir(
                                repo, 'chip_smoke_transformer'))
    timer = EpochTimer('phase 22 square66_transformer_sr')
    torch.cuda.reset_peak_memory_stats()
    state = train(config, device, logger=timer)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    energies = [r['energy'] for r in timer.records]
    print(f'phase 22 square66_transformer_sr (dense SR, '
          f'{config.batch_size} chains x {config.num_batches_per_epoch}): '
          f'Jacobian rows {TRANSFORMER_JACOBIAN_CHUNK} at a time, '
          f'{TRANSFORMER_EPOCHS} of 800 epochs, E/N '
          f'{[round(x / n, 6) for x in energies]}, acceptance '
          f'{timer.records[-1]["acceptance_rate"]:.4f}; epoch seconds '
          f'{[round(r["epoch_time_s"], 2) for r in timer.records]}, peak '
          f'memory {peak:.2f} GiB {card}', flush=True)
    require(all(np.isfinite(energies)), 'transformer: non-finite energy')
    require(all(np.isfinite(r['sr_residual_norm']) for r in timer.records),
            'transformer: non-finite SR residual')
    # No descent is asked of three epochs: the recipe starts where logpsi
    # is flat (acceptance 1, |grad| ~1e-4, in the JAX package too), and its
    # energy moves less than its sampling noise until the net takes off.
    before = wf.init(torch.Generator().manual_seed(config.seed))
    require(any(not torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(state.params), tree_leaves(before))),
        'transformer: three SR epochs left the parameters where they were')


def phase_autoregressive(repo: str, device, card: str) -> None:
    """23. Exact draws: the MADE artifact and a PixelCNN at 6x6."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.sampler import metropolis, registry
    from cgs_vmc_tpu_torch.train import train
    cells = (('made', Config(**MADE_6X6), 'heisenberg_6x6_made'),
             ('pixelcnn', Config(**dict(
                 MADE_6X6, wavefunction_type='pixelcnn')), None))
    for label, config, artifact in cells:
        wf = models.build_wavefunction(config)
        if artifact:
            _, params = load_artifact(repo, artifact, config, device)
        else:
            params = wf.init(torch.Generator(device=device).manual_seed(23))
        resolved = registry.resolved_name(wf, config)
        require(resolved == 'exact_autoregressive',
                f'{label}: the registry resolved {resolved}')
        sweeps = registry.resolve_sweeps_fn(wf, config)
        state = metropolis.init_sampler_for(23, wf, params, config, device)
        state = metropolis.reset_stats(sweeps(params, state, 1))
        rates = []
        for _ in range(AR_REPS):
            state, seconds = timed(lambda: sweeps(params, state, 1))
            rates.append(config.batch_size / seconds)
            require(bool((state.configs.sum(dim=1) == 0).all()),
                    f'{label}: a draw left the Sz=0 sector')
        state, launches, busy = count_launches(
            lambda: sweeps(params, state, 1))
        acc = float(metropolis.acceptance_rate(state))
        with torch.no_grad():
            fresh = wf.apply(params, state.configs)
        print(f'phase 23 {label}_exact_samples_per_sec (6x6, '
              f'{config.batch_size} chains, '
              f'{"artifact weights" if artifact else "random weights"}): '
              f'median of {AR_REPS} calls {np.median(rates):.1f} samples/s '
              f'(calls {", ".join(f"{r:.0f}" for r in rates)}); one draw '
              f'{launches} launches, device busy {busy * 1e3:.3f} ms; '
              f'acceptance {acc}, mean logpsi '
              f'{float(fresh.log.mean()):.4f} {card}', flush=True)
        require(acc == 1.0, f'{label}: acceptance {acc} is not 1')
        require(bool(torch.isfinite(fresh.log).all())
                and torch.equal(fresh.log, state.log_amp),
                f'{label}: the cached logpsi is not a fresh forward')

        timer = EpochTimer(f'phase 23 {label}', every=AR_EPOCHS)
        train(config.replace(num_epochs=AR_EPOCHS), device, logger=timer)
        energies = [r['energy'] for r in timer.records]
        print(f'phase 23 {label} EnergyGradient from a random start, '
              f'{AR_EPOCHS} epochs: E/N '
              f'{[round(x / config.num_sites, 5) for x in energies]}, '
              f'acceptance {timer.records[-1]["acceptance_rate"]}; mean '
              f'epoch {timer.mean_epoch_ms():.2f} ms {card}', flush=True)
        require(all(np.isfinite(energies)), f'{label}: non-finite energy')
        require(timer.records[-1]['acceptance_rate'] == 1.0,
                f'{label}: training acceptance is not 1')


def phase_sampler_knobs(repo: str, device, card: str) -> None:
    """24. Multiple-try Metropolis and tempering against the generic
    sampler, one sweep a call, the samplers taking turns: on the flagship
    conv (a step is device-bound) and on a small conv (launch-bound)."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.sampler import metropolis, registry, tempering
    bases = (('conv_2d 5x32 symmetrized, 6x6',
              conv_config(5, 32, 6, batch_size=1024)),
             ('conv_2d 3x8, 4x4', Config.load(os.path.join(
                 repo, 'configs', 'square44_itswo.json'))))
    for what, base in bases:
        cells = [('generic', base)] + [
            (f'mtm K={k}', base.replace(mtm_candidates=k))
            for k in MTM_CANDIDATES] + [
            (f'tempering R={PT_REPLICAS}',
             base.replace(pt_replicas=PT_REPLICAS))]
        wf = models.build_wavefunction(base)
        params = wf.init(torch.Generator(device=device).manual_seed(24))
        sweeps, states, rates = {}, {}, {}
        for label, cfg in cells:
            resolved = registry.resolved_name(wf, cfg)
            require(resolved == label.split()[0],
                    f'{label}: the registry resolved {resolved}')
            sweeps[label] = registry.resolve_sweeps_fn(wf, cfg)
            state = metropolis.init_sampler_for(24, wf, params, cfg, device)
            states[label] = metropolis.reset_stats(
                sweeps[label](params, state, 2))
            rates[label] = []
        for _ in range(SAMPLER_KNOB_REPS):
            for label in sweeps:
                states[label], seconds = timed(lambda: sweeps[label](
                    params, states[label], 1))
                rates[label].append(1.0 / seconds)
        for label in sweeps:
            # Two sweeps, so that a tempering call proposes both pairings.
            state, launches, busy = count_launches(lambda: sweeps[label](
                params, states[label], 2))
            with torch.no_grad():
                fresh = wf.apply(params, state.configs)
            gap = float(((state.log_amp - fresh.log).abs()
                         / (1.0 + fresh.log.abs())).max())
            swaps = ''
            if isinstance(state, tempering.PTSamplerState):
                swap_rates = [round(float(r), 3)
                              for r in tempering.swap_rate(state)]
                betas = [round(float(b), 3) for b in state.betas[0]]
                swaps = f', swap rates {swap_rates}, betas {betas}'
            ratio = np.median(rates[label]) / np.median(rates['generic'])
            print(f'phase 24 {label} ({what}, {base.batch_size} chains), '
                  f'median (min-max) of {SAMPLER_KNOB_REPS} calls of 1 sweep '
                  f'taken in turns: {spread(rates[label])} sweeps/s, '
                  f'{ratio:.2f}x generic; a sweep {launches / 2:.0f} '
                  f'launches, device busy {busy / 2 * 1e3:.2f} ms; '
                  f'acceptance '
                  f'{float(metropolis.acceptance_rate(state)):.4f}{swaps} '
                  f'{card}', flush=True)
            require(gap <= TOL, f'{label}: cached logpsi off a fresh '
                    f'forward by {gap}')
            require(bool((state.configs.sum(dim=1) == 0).all()),
                    f'{label}: a chain left the Sz=0 sector')
            require(0.0 < float(metropolis.acceptance_rate(state)) <= 1.0,
                    f'{label}: implausible acceptance')


def phase_tfim(repo: str, device, card: str) -> None:
    """25. configs/tfim_chain16_sr.json unmodified, then its evaluation
    against exact diagonalization."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.sampler import registry
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    from cgs_vmc_tpu_torch.utils import ed
    start = time.perf_counter()
    config = Config.load(os.path.join(repo, 'configs',
                                      'tfim_chain16_sr.json'))
    config = config.replace(checkpoint_dir=fresh_run_dir(
        repo, 'chip_smoke_tfim'))
    timer = EpochTimer('phase 25 tfim_chain16_sr', every=100)
    state = train(config, device, logger=timer)
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    result = evaluate_operator(wf, state.params, hamiltonian, config, device)
    e0, _ = ed.ising_ground_state(config.num_sites, hamiltonian.bonds,
                                  hamiltonian.h_x, hamiltonian.j_zz)
    rel = abs(result.mean - e0) / abs(e0)
    energies = [r['energy'] for r in timer.records]
    print(f'phase 25 tfim_chain16_sr (RBM H={config.fc_layer_size}, '
          f'{config.batch_size} chains x {config.num_batches_per_epoch}, '
          f'flip move, sampler {registry.resolved_name(wf, config)}, dense '
          f'SR): {len(energies)} epochs, E first {energies[0]:.6f}, mean of '
          f'last 10 {np.mean(energies[-10:]):.6f}; evaluated E = '
          f'{result.mean:.6f} +/- {result.error:.6f}, ED {e0:.6f}, rel err '
          f'{rel:.3e} (bar {TFIM_REL_ERR}; the JAX package '
          f'{JAX_TFIM_REL_ERR}), acceptance {result.acceptance_rate:.4f}; '
          f'mean epoch {timer.mean_epoch_ms():.2f} ms {card}; wall time '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    require(abs(e0 - TFIM_E0) < 1e-4, f'TFIM ED energy {e0} is not {TFIM_E0}')
    require(all(np.isfinite(energies)), 'tfim: non-finite energy')
    require(result.mean >= e0 - 5 * result.error,
            f'tfim: evaluated E {result.mean} below ED {e0}')
    require(rel <= TFIM_REL_ERR, f'tfim: rel err {rel} above {TFIM_REL_ERR}')


def run_cli(argv) -> str:
    """cli.main(argv) with its standard output captured and echoed; fails
    the run on a non-zero return."""
    import contextlib
    import io
    from cgs_vmc_tpu_torch import cli
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        rc = cli.main(list(argv))
    text = buffer.getvalue()
    print(text, end='', flush=True)
    require(rc == 0, f'cli {" ".join(argv)} returned {rc}')
    return text


def printed_value(text: str, label: str) -> float:
    """The number the CLI printed after `label` (before ' +/- ')."""
    return float(text.split(label, 1)[1].split(' +/- ')[0].split()[0])


def require_k2(kernels, expected: int, what: str) -> int:
    """K2's launches since the counts were zeroed, held to `expected`."""
    launches = profiling.counter('k2.launches')
    require(launches == expected,
            f'{what}: K2 launched {launches} times, expected {expected}')
    return launches


def ed_vector_state(n_sites: int, device, j_x: float = 1.0):
    """(E0, vector, ed_vector wavefunction, its params on `device`) of the
    periodic Heisenberg chain's ground state."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.utils import ed
    e0, v0 = ed.ground_state(n_sites, lattice.chain_bonds(n_sites), j_x=j_x)
    wf = FullVector.for_sector(n_sites, v0.astype(np.float32))
    params = tree_map(lambda x: x.to(device), wf.init(torch.Generator()))
    return e0, v0, wf, params


def run_params(run_dir: str, device):
    """(config, wavefunction, params on `device`) of a run directory."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.utils import checkpoint
    config = Config.load(os.path.join(run_dir, 'config.json'))
    return config, models.build_wavefunction(config), \
        checkpoint.restore_params_from_checkpoint(
            checkpoint.latest_checkpoint(run_dir), device)


def phase_observables(run_dir: str, device, kernels, card: str) -> None:
    """26. `eval --observable` on the chain40 run, then szsz, transverse
    and S² of the chain16 ED state against their exact sums."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator, exact_expectation
    from cgs_vmc_tpu_torch.ops import observables as obs
    values, seconds = {}, {}
    profiling.reset_counters('k1.launches', 'k2.launches')
    for observable in OBSERVABLES:
        text, seconds[observable] = timed(lambda: run_cli([
            'eval', '--checkpoint_dir', run_dir, '--observable', observable,
            '--device', 'cuda', '--override',
            f'num_evaluation_samples={OBS_SAMPLES}']))
        values[observable] = printed_value(text.splitlines()[0], ': ')
    config = Config.load(os.path.join(run_dir, 'config.json'))
    n = config.num_sites
    launches = require_k2(kernels,
                          len(OBSERVABLES) * (1 + OBS_SAMPLES), 'phase 26')
    ratio = values['transverse:1'] / (2.0 * values['szsz:1'])
    print(f'phase 26 observables of the chain40 run ({config.batch_size} '
          f'chains, {OBS_SAMPLES} of {config.num_evaluation_samples} samples, '
          f'jx {config.heisenberg_jx}: Marshall-corrected): {values}; '
          f'SU(2) ratio transverse/(2 szsz) {ratio:.4f}; S(pi) / (N m2_stag) '
          f'{values["sq:1"] / (n * values["staggered_m2"]):.8f}; K2 launches '
          f'{launches}; seconds '
          f'{ {k: round(v, 2) for k, v in seconds.items()} } {card}',
          flush=True)
    require(all(np.isfinite(v) for v in values.values()),
            'phase 26: a non-finite observable')
    # Same seed, same samples: S(pi) = N m2_stag configuration by
    # configuration.
    require(abs(values['sq:1'] - n * values['staggered_m2'])
            <= 1e-5 * abs(values['sq:1']), 'phase 26: S(pi) != N m2_stag')

    e0, _, wf, params = ed_vector_state(ED_SITES, device)
    config = Config(num_sites=ED_SITES, **ED_MC)
    pairs = lattice.displacement_pairs(ED_SITES, 1, 1, 1)
    for label, op in (('szsz:1', obs.SzSzCorrelation(pairs)),
                      ('transverse:1', obs.TransverseCorrelation(pairs)),
                      ('total_spin2', obs.TotalSpinSquared(ED_SITES))):
        exact = exact_expectation(wf, params, op, ED_SITES)
        result, t = timed(lambda: evaluate_operator(wf, params, op, config,
                                                    device, seed=26))
        print(f'phase 26 chain{ED_SITES} ED state (E0 {e0:.6f}, ed_vector, '
              f'generic sampler, {config.batch_size} chains x '
              f'{config.num_evaluation_samples}) {label}: MC '
              f'{result.mean:.6f} +/- {result.error:.6f}, exact '
              f'{exact:.6f}, {t:.2f} s {card}', flush=True)
        require(abs(result.mean - exact) <= 5 * max(result.error, 1e-4),
                f'phase 26: {label} off its exact value')


def phase_lanczos(repo: str, run_dir: str, device, kernels,
                  card: str) -> None:
    """27. The Lanczos step on the chain40 run, on the chain16 ED state
    (the fixed point) and on deep48 at a cut depth."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_tpu_torch.ops.lanczos import evaluate_lanczos, exact_lanczos
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    from cgs_vmc_tpu_torch.utils import interop
    config, wf, params = run_params(run_dir, device)
    config = config.replace(num_evaluation_samples=LANCZOS_SAMPLES)
    profiling.reset_counters('k1.launches', 'k2.launches')
    res, seconds = timed(lambda: evaluate_lanczos(
        wf, params, build_hamiltonian(config), config, device,
        energy_shift='auto'))
    launches = require_k2(kernels, 1 + LANCZOS_SAMPLES, 'phase 27')
    n = config.num_sites
    print(f'phase 27 Lanczos chain40 run ({config.batch_size} chains x '
          f'{LANCZOS_SAMPLES}, K = {n} bonds, {n * n} boards a sample, shift '
          f'{res.shift:.6f}): E0/N {res.e0 / n:.6f} +/- {res.e0_err / n:.6f}, '
          f'E(alpha*)/N {res.energy / n:.6f} +/- {res.energy_err / n:.6f}, '
          f'alpha* {res.alpha_physical:.6g}, variance {res.variance0:.6f} -> '
          f'{res.variance_alpha:.6f}, extrapolated/N '
          f'{res.extrapolated / n:.6f}; K2 launches {launches}; '
          f'{seconds:.2f} s {card}', flush=True)
    require(np.isfinite(res.energy) and np.isfinite(res.energy_err),
            'phase 27: non-finite Lanczos energy')
    require(res.energy <= res.e0 + 2 * res.energy_err,
            'phase 27: E(alpha*) above E0 + 2 sigma')
    require(res.variance_alpha < res.variance0,
            'phase 27: the Lanczos step did not lower the variance')

    e0, _, ed_wf, ed_params = ed_vector_state(ED_SITES, device, j_x=-1.0)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(ED_SITES), -1.0, 1.0)
    res, seconds = timed(lambda: exact_lanczos(ed_wf, ed_params, ham,
                                               ED_SITES))
    print(f'phase 27 Lanczos chain{ED_SITES} ED state (exact sums): alpha* '
          f'{res.alpha}, E {res.energy:.8f}, ED {e0:.8f}, {seconds:.2f} s '
          f'{card}', flush=True)
    require(res.alpha == 0.0, 'phase 27: the ED state is not a fixed point')
    require(abs(res.energy - e0) <= 1e-5 * abs(e0),
            'phase 27: the ED state\'s Lanczos energy is off ED')

    samples = np.load(os.path.join(repo, PIN_SAMPLES))[
        :DEEP48_LANCZOS['batch_size']]
    config = conv_config(7, 48, 6, **DEEP48_LANCZOS)
    deep_wf, deep_params = load_artifact(repo, 'heisenberg_6x6_deep48',
                                         config, device)
    state = interop.sampler_state_from_numpy(
        samples, np.zeros(len(samples)), np.ones(len(samples)), device,
        seed=27)
    res, seconds = timed(lambda: evaluate_lanczos(
        deep_wf, deep_params, square_hamiltonian(6, DEEP48_INNER_CHUNK),
        config, device, state=state, sample_chunk=DEEP48_OUTER_CHUNK,
        energy_shift='auto'))
    print(f'phase 27 Lanczos deep48 ({len(samples)} chains x '
          f'{config.num_evaluation_samples} samples, 72 x 72 boards a '
          f'sample, moments {DEEP48_OUTER_CHUNK} samples and local energies '
          f'{DEEP48_INNER_CHUNK} boards at a time): E0/N {res.e0 / 36:.6f}, '
          f'E(alpha*)/N {res.energy / 36:.6f} +/- {res.energy_err / 36:.6f} '
          f'(recorded {DEEP48_E_PER_SITE}), alpha* {res.alpha_physical:.6g}, '
          f'variance {res.variance0:.6f} -> {res.variance_alpha:.6f}; '
          f'{seconds:.2f} s {card}', flush=True)
    require(all(np.isfinite([res.e0, res.energy, res.variance0,
                             res.variance_alpha])),
            'phase 27: non-finite deep48 Lanczos values')


def phase_renyi(run_dir: str, device, kernels, card: str) -> None:
    """28. Rényi-2: the chain16 ED state's half chain against the exact
    value, then two regions of the chain40 run (K2 in both replicas)."""
    from cgs_vmc_tpu_torch import basis
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.ops.renyi import evaluate_renyi2, exact_renyi2
    _, v0, wf, params = ed_vector_state(ED_SITES, device)
    region = list(range(ED_SITES // 2))
    exact = exact_renyi2(v0, basis.enumerate_sz_basis(ED_SITES), region)
    (s2, err), seconds = timed(lambda: evaluate_renyi2(
        wf, params, region, Config(num_sites=ED_SITES, **ED_MC), device))
    print(f'phase 28 Renyi-2 chain{ED_SITES} ED state, sites 0..'
          f'{region[-1]}: MC {s2:.6f} +/- {err:.6f}, exact {exact:.6f}, '
          f'{seconds:.2f} s {card}', flush=True)
    require(abs(s2 - exact) <= 5 * err, 'phase 28: S2 off its exact value')

    config, wf, params = run_params(run_dir, device)
    config = config.replace(num_evaluation_samples=OBS_SAMPLES)
    for lo, hi in RENYI_REGIONS:
        profiling.reset_counters('k1.launches', 'k2.launches')
        (s2, err), seconds = timed(lambda: evaluate_renyi2(
            wf, params, list(range(lo, hi + 1)), config, device))
        launches = require_k2(kernels, 2 * (1 + OBS_SAMPLES), 'phase 28')
        print(f'phase 28 Renyi-2 chain40 run, sites {lo}..{hi} (2 replicas '
              f'x {config.batch_size} chains x {OBS_SAMPLES} samples): '
              f'S2 {s2:.6f} +/- {err:.6f}; K2 launches {launches}; '
              f'{seconds:.2f} s {card}', flush=True)
        require(np.isfinite(s2) and np.isfinite(err),
                'phase 28: non-finite S2')


def phase_time_evolution(run_dir: str, complex_dir: str, device, kernels,
                         card: str) -> None:
    """29. `evolve` in imaginary time on the chain40 run; the full-basis
    real-time quench against expm; `evolve --linear_response` on phase
    16's complex run."""
    import json
    import scipy.linalg
    from cgs_vmc_tpu_torch import basis, lattice
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.models.complex_phase import (
        ComplexPhaseWavefunction)
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.ops import logamp
    from cgs_vmc_tpu_torch.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_tpu_torch.optim.tvmc import tdvp_direction
    from cgs_vmc_tpu_torch.utils import ed
    profiling.reset_counters('k1.launches', 'k2.launches')
    _, seconds = timed(lambda: run_cli([
        'evolve', '--checkpoint_dir', run_dir, '--mode', 'imag', '--dt',
        str(EVOLVE_DT), '--steps', str(EVOLVE_STEPS), '--device', 'cuda']))
    launches = require_k2(kernels, 1 + EVOLVE_STEPS, 'phase 29')
    with open(os.path.join(run_dir, 'evolution.jsonl')) as f:
        records = [json.loads(line) for line in f]
    energies = [r['energy'] for r in records]
    head, tail = np.mean(energies[:5]), np.mean(energies[-5:])
    print(f'phase 29 evolve --mode imag chain40 run ({EVOLVE_STEPS} Heun '
          f'steps of dt {EVOLVE_DT}): E first 5 {head:.6f}, last 5 '
          f'{tail:.6f}, tdvp_r2 last {records[-1]["tdvp_r2"]:.6f}; K2 '
          f'launches {launches}; {seconds:.2f} s, '
          f'{seconds / EVOLVE_STEPS * 1e3:.1f} ms a step {card}', flush=True)
    require(len(records) == EVOLVE_STEPS and all(np.isfinite(energies)),
            'phase 29: non-finite evolution energy')
    require(tail < head, 'phase 29: imaginary time did not lower E')

    # tests/test_tvmc.py:92 on the card: the NN-chain ground state under the
    # J1-J2 (j2 = 0.5) Hamiltonian, a complete (modulus, phase)
    # parameterization, full-basis |psi|^2 weights.
    n = TVMC_SITES
    bonds, mask = lattice.j1j2_chain_bonds(n)
    couplings = (1.0 - mask) + 0.5 * mask
    dense = np.asarray(ed.heisenberg_matrix(n, bonds, couplings=couplings,
                                            sparse=False))
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    _, v_chain = ed.ground_state(n, lattice.chain_bonds(n))
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(n, v_chain.astype(np.float32)),
        FullVector.for_sector(n, np.ones_like(v_chain, np.float32)))
    params = tree_map(lambda x: x.to(device), wf.init(torch.Generator()))
    states = torch.as_tensor(basis.enumerate_sz_basis(n), device=device)

    def direction(p):
        with torch.no_grad():
            amp = wf.apply(p, states)
            weights = torch.softmax(2.0 * amp.log.real, dim=0)
            e_loc = ham.local_value(wf, p, states, amp)
        return tdvp_direction(wf, p, states, e_loc, mode='real',
                              diag_shift=1e-6, weights=weights)

    def quench():
        p, r2s, energies = params, [], []
        dt = TVMC_T / TVMC_STEPS
        for _ in range(TVMC_STEPS):
            k1, e, r2 = direction(p)
            k2, _, _ = direction(tree_map(lambda a, d: a + 0.5 * dt * d,
                                          p, k1))
            p = tree_map(lambda a, d: a + dt * d, p, k2)
            r2s.append(float(r2))
            energies.append(float(e.real))
        return p, r2s, energies

    (p, r2s, energies), seconds = timed(quench)
    with torch.no_grad():
        amp = wf.apply(p, states)
        psi = logamp.to_value(amp._replace(
            log=amp.log - amp.log.real.max())).cpu().numpy()
    psi = psi / np.linalg.norm(psi)
    exact = scipy.linalg.expm(-1j * dense * TVMC_T) @ v_chain
    fidelity = abs(np.vdot(psi, exact / np.linalg.norm(exact)))
    print(f'phase 29 full-basis quench N={n} (J1-J2 j2 0.5, {len(states)} '
          f'states, {TVMC_STEPS} Heun steps to t={TVMC_T}): fidelity with '
          f'expm {fidelity:.8f}, max tdvp_r2 {max(r2s):.3e}, |dE| '
          f'{abs(energies[-1] - energies[0]):.3e}; {seconds:.2f} s {card}',
          flush=True)
    require(max(r2s) < TVMC_R2, 'phase 29: tdvp r2 of a complete manifold')
    require(fidelity > 0.9999, f'phase 29: fidelity {fidelity} with expm')
    require(abs(energies[-1] - energies[0]) < 1e-3 * max(
        1.0, abs(energies[0])), 'phase 29: unitary flow moved <H>')

    text, seconds = timed(lambda: run_cli([
        'evolve', '--checkpoint_dir', complex_dir, '--linear_response', '1',
        '--dt', str(RESPONSE_DT), '--steps', str(EVOLVE_STEPS),
        '--device', 'cuda']))
    with open(os.path.join(complex_dir, 'linear_response.jsonl')) as f:
        lines = [json.loads(line) for line in f]
    peak = printed_value(text, 'peak at omega=')
    head = [round(c, 4) for c in lines[0]['correlator'][:6]]
    print(f'phase 29 evolve --linear_response 1 on {complex_dir} '
          f'({EVOLVE_STEPS} steps of dt {RESPONSE_DT}, both trajectories): '
          f'S(q=pi, omega) peak at {peak:.4f}; C(t) {head}...; '
          f'{seconds:.2f} s {card}', flush=True)
    require(len(lines[0]['times']) == EVOLVE_STEPS + 1
            and np.isfinite(lines[0]['correlator']).all()
            and np.isfinite(lines[1]['spectral_function']).all(),
            'phase 29: linear_response.jsonl is not finite or complete')


def phase_excited(repo: str, run_dir: str, device, kernels,
                  card: str) -> None:
    """30. `train --orthogonal_to` the chain40 run with ExcitedPenalty and
    ExcitedSR, then one resumed epoch of the first."""
    import json
    from cgs_vmc_tpu_torch.config import Config
    config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
    # K2 launches: the frozen chains equilibrate once (1); an epoch the
    # variational chains equilibrate (1) and both sets advance each batch
    # (ExcitedPenalty: 2 a batch) or the variational chains advance each
    # batch and the frozen ones once (ExcitedSR: batches + 1).
    batches = config.num_batches_per_epoch
    per_epoch = {'ExcitedPenalty': 1 + 2 * batches,
                 'ExcitedSR': 1 + batches + 1}
    dirs = {}
    for name in ('ExcitedPenalty', 'ExcitedSR'):
        out = fresh_run_dir(repo, f'chip_smoke_{name}')
        profiling.reset_counters('k1.launches', 'k2.launches')
        _, seconds = timed(lambda: run_cli([
            'train', '--config', os.path.join(repo, 'configs',
                                              'chain40_sr.json'),
            '--optimizer_type', name, '--orthogonal_to', run_dir,
            '--checkpoint_dir', out, '--num_epochs', str(EXCITED_EPOCHS),
            '--device', 'cuda']))
        launches = require_k2(kernels, 1 + EXCITED_EPOCHS * per_epoch[name],
                              f'phase 30 {name}')
        with open(os.path.join(out, 'metrics.jsonl')) as f:
            records = [json.loads(line) for line in f]
        energies = [r['energy'] for r in records]
        overlaps = [r['overlap'] for r in records]
        print(f'phase 30 {name} chain40 orthogonal to {run_dir} '
              f'({EXCITED_EPOCHS} epochs, penalty '
              f'{config.orthogonality_penalty}): E/N '
              f'{[round(e / config.num_sites, 5) for e in energies]}, '
              f'overlaps {[round(o, 5) for o in overlaps]}; K2 launches '
              f'{launches} (predicted 1 + {per_epoch[name]} an epoch); '
              f'{seconds:.2f} s {card}', flush=True)
        require(len(records) == EXCITED_EPOCHS
                and all(np.isfinite(energies + overlaps)),
                f'phase 30 {name}: non-finite energy or overlap')
        dirs[name] = out

    profiling.reset_counters('k1.launches', 'k2.launches')
    run_cli(['train', '--resume', '--checkpoint_dir', dirs['ExcitedPenalty'],
             '--num_epochs', str(EXCITED_EPOCHS + 1), '--device', 'cuda'])
    launches = require_k2(kernels, 1 + per_epoch['ExcitedPenalty'],
                          'phase 30 resume')
    with open(os.path.join(dirs['ExcitedPenalty'], 'metrics.jsonl')) as f:
        last = [json.loads(line) for line in f][-1]
    print(f'phase 30 ExcitedPenalty resumed for epoch {last["epoch"]}: E '
          f'{last["energy"]:.6f}, overlap {last["overlap"]:.5f}; K2 launches '
          f'{launches} {card}', flush=True)
    require(last['epoch'] == EXCITED_EPOCHS + 1
            and np.isfinite([last['energy'], last['overlap']]).all(),
            'phase 30: the resumed epoch is missing or not finite')


PLUMBING_EPOCHS = 12               # phase 31's EnergyGradient run
EMA_DECAY = 0.9
EMA_FREQUENCY = 4
EMA_RESUME_EPOCH = 8
PROFILE_EPOCHS = 3
NCCL_EPOCHS = 3
NCCL_EVAL_SAMPLES = 20
K2_SYMBOL = ('rbm_sweep_kernel', 'PhiloxDraws')   # K2's __global__ launch


def chain40_config(repo: str, **overrides):
    """configs/chain40_sr.json (RBM H=160, 2048 chains, K2) with
    overrides; EnergyGradient with adam 1e-2 unless they say otherwise."""
    from cgs_vmc_tpu_torch.config import Config
    config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
    config = config.parse(
        'wavefunction_optimizer_type=EnergyGradient,optimizer=adam,'
        'learning_rates=[1e-2],learning_rate_stops=[]')
    return config.replace(**overrides)


def flat_params(params) -> torch.Tensor:
    from cgs_vmc_tpu_torch.optim.sr import flatten_params
    return flatten_params(params)[0]


def phase_ema(repo: str, device, kernels, card: str):
    """31. EnergyGradient on chain40 for PLUMBING_EPOCHS epochs with
    param_ema_decay=EMA_DECAY, checkpoints every EMA_FREQUENCY: the slot
    against the average recomputed on the host from the run's params of
    every epoch (a second run without the slot, checkpointed every epoch,
    whose params must be those of the first bit for bit); a resume from
    epoch EMA_RESUME_EPOCH equal bit for bit; `cli eval --ema` above the
    Bethe bound.  Returns (K2 launches, the run directory)."""
    import shutil
    from cgs_vmc_tpu_torch.train import train
    from cgs_vmc_tpu_torch.utils import checkpoint
    run = fresh_run_dir(repo, 'chip_smoke_ema')
    config = chain40_config(repo, num_epochs=PLUMBING_EPOCHS,
                            param_ema_decay=EMA_DECAY,
                            checkpoint_frequency=EMA_FREQUENCY,
                            max_checkpoints_to_keep=10, checkpoint_dir=run)
    profiling.reset_counters('k1.launches', 'k2.launches')
    state = train(config, 'cuda', logger=EpochTimer('phase 31', every=4))
    launches = profiling.counter('k2.launches')
    every = fresh_run_dir(repo, 'chip_smoke_ema_every')
    plain = train(config.replace(param_ema_decay=0.0, checkpoint_frequency=1,
                                 max_checkpoints_to_keep=20,
                                 checkpoint_dir=every), 'cuda',
                  logger=EpochTimer('phase 31 (no slot)', every=12))
    require(torch.equal(flat_params(plain.params), flat_params(state.params)),
            'phase 31: the EMA slot changed the training trajectory')
    ema = None
    for epoch in range(PLUMBING_EPOCHS + 1):
        p = flat_params(checkpoint.restore_params_from_checkpoint(
            os.path.join(every, f'ckpt_epoch_{epoch}.pt'), 'cpu')).double()
        ema = p if ema is None else EMA_DECAY * ema + (1 - EMA_DECAY) * p
    slot = flat_params(state.extra['ema_params']).cpu().double()
    ema_err = float(torch.max(torch.abs(slot - ema)))
    require(torch.allclose(slot, ema, rtol=1e-6, atol=1e-8),
            f'phase 31: the EMA slot is off the host average ({ema_err})')

    resumed = fresh_run_dir(repo, 'chip_smoke_ema_resume')
    os.makedirs(resumed, exist_ok=True)
    for name in ('config.json', f'ckpt_epoch_{EMA_RESUME_EPOCH}.pt'):
        shutil.copy(os.path.join(run, name), os.path.join(resumed, name))
    again = train(config.replace(checkpoint_dir=resumed), 'cuda',
                  resume=True, logger=EpochTimer('phase 31 resumed', every=12))
    same = (torch.equal(flat_params(again.params), flat_params(state.params))
            and torch.equal(flat_params(again.extra['ema_params']),
                            flat_params(state.extra['ema_params']))
            and torch.equal(again.sampler.configs, state.sampler.configs)
            and torch.equal(again.sampler.generator.get_state(),
                            state.sampler.generator.get_state()))
    require(same, 'phase 31: the resume from epoch '
            f'{EMA_RESUME_EPOCH} is not bit for bit the straight run')
    profiling.reset_counters('k1.launches', 'k2.launches')
    text = run_cli(['eval', '--checkpoint_dir', run, '--ema', '--override',
                    f'num_evaluation_samples={OBS_SAMPLES}',
                    '--device', 'cuda'])
    launches += profiling.counter('k2.launches')
    n = config.num_sites
    e = printed_value(text, 'Energy:') / n
    err = float(text.split('Energy:', 1)[1].split(' +/- ')[1].split()[0]) / n
    print(f'phase 31 EMA chain40 ({PLUMBING_EPOCHS} epochs, decay '
          f'{EMA_DECAY}): slot within rtol 1e-6 of the host average of '
          f'{PLUMBING_EPOCHS + 1} epochs\' params (largest |difference| '
          f'{ema_err:.3g}); resume from '
          f'epoch {EMA_RESUME_EPOCH} bit for bit; eval --ema E/N {e:.6f} '
          f'+/- {err:.6f}; K2 launches {launches} {card}', flush=True)
    require(np.isfinite(e) and e >= BETHE_E_PER_SITE - 5 * err,
            f'phase 31: eval --ema E/N {e} not finite or below the bound')
    require(launches > 0, 'phase 31 did not launch K2')
    return launches, run


def phase_artifacts_both_ways(repo: str, run_dir: str, device,
                              card: str) -> None:
    """32. The port's params-only writer: phase 31's params written and
    read back bit for bit; the deep48 artifact decoded and re-encoded byte
    for byte (the JAX package reads what the writer writes: the CPU tests
    hold that, the card has no JAX); a basis file round trip."""
    import tempfile
    from cgs_vmc_tpu_torch import basis
    from cgs_vmc_tpu_torch.utils import checkpoint, msgpack_params
    _, wf, params = run_params(run_dir, device)
    with tempfile.TemporaryDirectory(dir=os.path.join(repo, 'build')) as tmp:
        path = checkpoint.save_params_only(tmp, params, 'chain40')
        back = checkpoint.restore_params_only(
            path, wf.init(torch.Generator(device=device)))
        require(torch.equal(flat_params(back), flat_params(params)),
                'phase 32: save_params_only / restore_params_only differ')
        states = basis.enumerate_sz_basis(16)
        basis.save_basis_file(os.path.join(tmp, 'basis.txt'), states)
        require(np.array_equal(basis.load_basis_file(
            os.path.join(tmp, 'basis.txt')), states),
            'phase 32: save_basis_file / load_basis_file differ')
        size = os.path.getsize(path)
    artifact = os.path.join(repo, 'artifacts', 'heisenberg_6x6_deep48.msgpack')
    with open(artifact, 'rb') as f:
        data = f.read()
    same = msgpack_params.dumps(msgpack_params.loads(data)) == data
    print(f'phase 32 artifacts: chain40 params written ({size} B) and read '
          f'back bit for bit; deep48 re-encoded byte for byte: {same} '
          f'({len(data)} B); basis file of {states.shape[0]} states round '
          f'trips {card}', flush=True)
    require(same, 'phase 32: the deep48 artifact does not re-encode to '
            'its bytes')


def phase_profile(repo: str, device, kernels, kernel_table,
                  card: str) -> int:
    """33. `train` chain40 for PROFILE_EPOCHS epochs with profile_dir: the
    trace of the second epoch exists and its device events name K2's
    kernel; their times beside phase 7's CUDA-event times.  Returns K2's
    launches."""
    import glob
    from cgs_vmc_tpu_torch.train import train
    run = fresh_run_dir(repo, 'chip_smoke_profile')
    trace_dir = os.path.join(run, 'trace')
    if os.path.isdir(trace_dir):
        for old in os.listdir(trace_dir):
            os.remove(os.path.join(trace_dir, old))
    config = chain40_config(repo, num_epochs=PROFILE_EPOCHS,
                            profile_dir=trace_dir)
    profiling.reset_counters('k1.launches', 'k2.launches')
    train(config, 'cuda', logger=EpochTimer('phase 33', every=PROFILE_EPOCHS))
    launches = profiling.counter('k2.launches')
    traces = glob.glob(os.path.join(trace_dir, '*.pt.trace.json'))
    require(len(traces) == 1, f'phase 33: {len(traces)} trace files')
    with open(traces[0]) as f:
        events = json.load(f)['traceEvents']
    device_events = [e for e in events
                     if str(e.get('cat', '')).lower() == 'kernel']
    k2 = sorted(float(e['dur']) / 1e3 for e in device_events
                if all(part in e.get('name', '') for part in K2_SYMBOL))
    names = {e['name'] for e in device_events
             if all(part in e.get('name', '') for part in K2_SYMBOL)}
    busy = sum(float(e.get('dur', 0)) for e in device_events) / 1e3
    rule = kernels.instance(config.num_sites, config.fc_layer_size)[0]
    alone = {sweeps: kernel_table[('K2', 'slice', sweeps)][f'rule G={rule}']
             for sweeps in (1, 10)}
    print(f'phase 33 profile of epoch 2 of {PROFILE_EPOCHS} ({traces[0]}, '
          f'{len(events)} events, {len(device_events)} kernels, '
          f'{busy:.3f} ms of kernels): K2 {sorted(names)}; its launches '
          f'{[round(t, 4) for t in k2]} ms ({config.num_equilibration_sweeps}'
          f' sweeps once, 1 sweep {config.num_batches_per_epoch} times); '
          f'phase 7 alone at the slice shape: 1 sweep {alone[1]:.4f} ms, 10 '
          f'sweeps {alone[10]:.4f} ms {card}', flush=True)
    require(len(k2) == 1 + config.num_batches_per_epoch,
            f'phase 33: the trace holds {len(k2)} K2 launches, expected '
            f'{1 + config.num_batches_per_epoch}')
    require(launches > 0, 'phase 33 did not launch K2')
    return launches


def phase_nccl(repo: str, device, kernels, card: str) -> int:
    """34. The sharded path over NCCL at world size 1: chain40 for
    NCCL_EPOCHS epochs under EnergyGradient and dense SR through `train`,
    and `evaluate_operator` at NCCL_EVAL_SAMPLES samples, first without a
    process group, then in one (num_devices=1 takes the sharded path):
    EnergyGradient bit for bit, SR at rtol 1e-5, the evaluation at rtol
    1e-6.  Returns K2's launches."""
    import tempfile
    import torch.distributed as dist
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.parallel import mesh
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    configs = {
        'EnergyGradient': chain40_config(repo, num_epochs=NCCL_EPOCHS),
        'SR': chain40_config(repo, num_epochs=NCCL_EPOCHS,
                             wavefunction_optimizer_type='SR',
                             optimizer='gradient', learning_rates=[0.05]),
    }
    eval_config = configs['EnergyGradient'].replace(
        num_evaluation_samples=NCCL_EVAL_SAMPLES)
    wf = models.build_wavefunction(eval_config)
    hamiltonian = build_hamiltonian(eval_config)

    def runs(label):
        """Both trainings and the evaluation: (results, the mean ms of
        epochs 2.. of each training, the collectives of each)."""
        out, epoch_ms, counts = {}, {}, {}
        for name, config in configs.items():
            profiling.reset_counters('collectives')
            timer = EpochTimer(f'phase 34 {label} {name}', every=NCCL_EPOCHS)
            out[name] = train(config, 'cuda', logger=timer)
            epoch_ms[name] = timer.mean_epoch_ms()
            counts[name] = profiling.counter('collectives')
        profiling.reset_counters('collectives')
        out['eval'] = evaluate_operator(wf, out['EnergyGradient'].params,
                                        hamiltonian, eval_config, 'cuda')
        counts['eval'] = profiling.counter('collectives')
        return out, epoch_ms, counts

    profiling.reset_counters('k1.launches', 'k2.launches')
    plain, plain_ms, _ = runs('no group')
    with tempfile.TemporaryDirectory(dir=os.path.join(repo, 'build')) as tmp:
        mesh.initialize_distributed('nccl', 'file://' + os.path.join(
            tmp, 'rendezvous'), 1, 0)
        try:
            require(mesh.chains_group(1) is dist.group.WORLD,
                    'phase 34: num_devices=1 under a group is not sharded')
            sharded, sharded_ms, counts = runs('NCCL world 1')
        finally:
            dist.destroy_process_group()
    launches = profiling.counter('k2.launches')
    eg_same = torch.equal(flat_params(sharded['EnergyGradient'].params),
                          flat_params(plain['EnergyGradient'].params))
    sr_a = flat_params(sharded['SR'].params)
    sr_b = flat_params(plain['SR'].params)
    sr_err = float(torch.max(torch.abs(sr_a - sr_b)
                             / (1e-12 + torch.abs(sr_b))))
    ev_a, ev_b = sharded['eval'], plain['eval']
    print(f'phase 34 NCCL {torch.cuda.nccl.version()} world size 1, chain40 '
          f'{NCCL_EPOCHS} epochs: EnergyGradient bit for bit {eg_same} '
          f'({sharded_ms["EnergyGradient"]:.2f} ms an epoch vs '
          f'{plain_ms["EnergyGradient"]:.2f} ms without a group, epochs 2-'
          f'{NCCL_EPOCHS}), SR largest relative difference {sr_err:.3g} '
          f'({sharded_ms["SR"]:.2f} ms vs {plain_ms["SR"]:.2f} ms); '
          f'eval E/N {ev_a.mean / 40:.6f} vs {ev_b.mean / 40:.6f}; '
          f'collectives an epoch: EnergyGradient '
          f'{counts["EnergyGradient"] / NCCL_EPOCHS:g}, SR '
          f'{counts["SR"] / NCCL_EPOCHS:g}, the evaluation {counts["eval"]} '
          f'in all; K2 launches {launches} {card}', flush=True)
    require(eg_same, 'phase 34: world-1 NCCL EnergyGradient is not bit for '
            'bit the plain run')
    require(torch.allclose(sr_a, sr_b, rtol=1e-5, atol=1e-7),
            f'phase 34: world-1 NCCL SR off the plain run ({sr_err})')
    require(np.allclose(ev_a.values, ev_b.values, rtol=1e-6)
            and abs(ev_a.mean - ev_b.mean) <= 1e-6 * abs(ev_b.mean),
            'phase 34: world-1 NCCL evaluation off the plain one')
    require(launches > 0, 'phase 34 did not launch K2')
    return launches


# 39. The periodic conv at the flagship sampler's call (1,024 chains × 16
# symmetry images of 6×6, k=3): (C_in, C_out) of its first and inner layers.
PCONV_IMAGES, PCONV_SIDE, PCONV_K = 16384, 6, 3
PCONV_CHANNELS = ((1, 32), (32, 32))
PCONV_TOL = 1e-5                   # rtol and atol against float64
PCONV_REPS = 50
# 40. The attention kernel at the transformer cell's calls: a proposal (256
# chains × 16 images) and a connected-board chunk (9,216 boards × 16).
ATTN_N, ATTN_HEADS, ATTN_HEAD_DIM = 36, 8, 8
ATTN_IMAGES = (('proposal', 4096), ('connected chunk', 147456))
ATTN_TOL = 1e-5                    # rtol and atol against the plain einsums
ATTN_REPS = 50
ATTN_CHAINS, ATTN_EPOCHS = 256, 3

# 41. The encoder's fused linear kernel alone, at the cell's row counts.
ELIN_IMAGES = (('proposal', 4096), ('connected chunk', 147456))
ELIN_TOKENS = 36
ELIN_TOL = 2e-5                    # rtol and atol against the f32 plain chain
ELIN_REPS = 20
ENTRY_TOL = 1e-4                   # rtol and atol, card against host
ENTRY_REPS = 20
BENCH_SWEEP_REPS = 2               # of the bench's SWEEP_REPS = 5
BENCH_K_FUSED = 2                  # of the bench's K_FUSED = 5
BENCH_SEED = 2 ** 31 + 12345        # bit 31 set: Philox keys on 32 bits


def phase_entry(device, kernels, card: str) -> None:
    """35. `entry()` (cgs_vmc_tpu_torch/entry.py) on the card: its forward
    step against the same inputs' forward on the CPU, within ENTRY_TOL
    (relative and absolute); one forward's CUDA-event time.  No
    hand-written kernel runs on this path."""
    from cgs_vmc_tpu_torch import entry
    profiling.reset_counters('k1.launches', 'k2.launches')
    fn, args = entry.entry(device)
    log_psi, e_loc = fn(*args)
    host_fn, host_args = entry.entry('cpu')
    host_log, host_e = host_fn(*host_args)
    errs = {}
    for label, got, ref in (('logpsi', log_psi, host_log),
                            ('E_loc', e_loc, host_e)):
        require(tuple(got.shape) == (entry.N_BOARDS,)
                and bool(torch.isfinite(got).all()),
                f'phase 35: {label} not finite of shape ({entry.N_BOARDS},)')
        err = (got.cpu() - ref).abs()
        errs[label] = float(err.max())
        require(bool((err <= ENTRY_TOL * (1.0 + ref.abs())).all()),
                f'phase 35: {label} on the card off the host by '
                f'{errs[label]:.3e}')
    ms = event_ms(lambda: fn(*args), ENTRY_REPS)
    print(f'phase 35 entry(): conv_2d 5x16 at 6x6 on {entry.N_BOARDS} '
          f'boards, card vs host max |dlogpsi| {errs["logpsi"]:.3e}, max '
          f'|dE_loc| {errs["E_loc"]:.3e} (tol {ENTRY_TOL}); one forward '
          f'step {ms:.4f} ms (CUDA events, mean of {ENTRY_REPS}) {card}',
          flush=True)
    require(profiling.counter('k1.launches') == 0
            and profiling.counter('k2.launches') == 0,
            'phase 35 launched an RBM sweep kernel')


def hold_call(what: str, kernels, out, witness, n_steps: int,
              card: str) -> None:
    """A whole call of a sweep kernel (`out`, n_steps steps) against one
    call of its lane-order witness on the same inputs (`witness(margin)`):
    every output bit for bit on every chain."""
    start = time.perf_counter()
    n_chains, n_sites = out.configs.shape
    margin = torch.full((n_chains,), torch.inf, device=out.configs.device)
    ref = witness(margin)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    hold_witness(f'phase 36 {what}', out, ref, margin)
    print(f'phase 36 {what} vs its lane-order witness at the bench shape, '
          f'one call of {n_steps // n_sites} sweeps ({n_steps} steps, G='
          f'{kernels.instance(n_sites, out.theta.shape[1])[0]}): all '
          f'{n_chains} chains equal bit for bit in configs, accept counts, '
          f'theta and logpsi; least witness margin '
          f'{float(margin.min()):.3g}; acceptance '
          f'{float(out.num_accepted.sum()) / (n_steps * n_chains):.5f}; '
          f'witness call {seconds:.2f} s {card}', flush=True)


def phase_bench(device, kernels, card: str) -> dict:
    """36. The bench's own functions (cgs_vmc_tpu_torch/bench.py) at its
    shapes with cut repetitions: BENCH_SWEEP_REPS K2 reps of 800 sweeps
    (acceptance band), its one timed K1 call, one per-call and one
    BENCH_K_FUSED-epoch fused flagship rep after the warm-up, the MADE
    draws; the partial report printed.  Then, launches not counted, that
    K1 call and one K2 call of 800 sweeps from the reps' chains, each held
    against one call of its lane-order witness, bit for bit on every chain
    (hold_call).  Returns the path's launches."""
    from cgs_vmc_tpu_torch import bench
    start = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    profiling.reset_counters('k1.launches', 'k2.launches')
    dispatch_before = bench._dispatch_latency_ms(device)
    sweeps = bench.SweepBench(device)
    sweep_t = [sweeps.rep() for _ in range(BENCH_SWEEP_REPS)]
    sweep_final = sweeps.finalize()
    flagship = bench.FlagshipEpochBench(device, k_fused=BENCH_K_FUSED)
    percall_t, fused_t = [flagship.percall_rep()], [flagship.fused_rep()]
    made = bench.bench_made_exact_sampling(device)
    bench_s = time.perf_counter() - start
    launches = {'rbm_sweeps': profiling.counter('k1.launches'),
                'rbm_sweeps_prng': profiling.counter('k2.launches')}
    timings = bench.Timings(sweep_t, percall_t, fused_t, 1, dispatch_before,
                            bench._dispatch_latency_ms(device))
    line = bench.report(timings, [
        sweep_final, flagship.finalize(percall_t[0], fused_t[0]), made])
    print(f'phase 36 bench at its shapes, cut to {BENCH_SWEEP_REPS} sweep '
          f'reps, 1 per-call and 1 {BENCH_K_FUSED}-epoch fused rep, '
          f'{bench.MADE_REPS} MADE calls: {json.dumps(line)}; launches '
          f'{launches}; {bench_s:.2f} s {card}', flush=True)
    extra = line['extra']
    require(line['metric'] == bench.METRIC and line['unit'] == 'sweeps/s',
            'phase 36: the bench line names another metric')
    require(all(np.isfinite(v) and v > 0 for v in (
        line['value'], extra['streamed_kernel_sweeps_per_sec'],
        extra['sr_epoch_wall_s'], extra['sr_epoch_wall_s_percall'],
        extra['made_exact_samples_per_sec'])),
            'phase 36: a bench number is not finite and positive')
    require(launches == {'rbm_sweeps': 2,
                         'rbm_sweeps_prng': 1 + BENCH_SWEEP_REPS},
            f'phase 36: launches {launches}, expected 2 K1 and '
            f'{1 + BENCH_SWEEP_REPS} K2')
    require(tf32 == (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32),
            'phase 36: the flagship epoch left the TF32 flags changed')

    w, b, a = sweeps.w, sweeps.b, sweeps.a
    lanes = kernels.instance(bench.N_SITES, bench.HIDDEN)[0]
    configs, picks, log_u, k1_out = sweeps.streamed_call
    hold_call('K1 (the bench\'s timed call)', kernels, k1_out,
              lambda margin: kernels.rbm_sweeps_lanes_plain(
                  w, b, a, configs, configs @ w + b, picks, log_u, lanes,
                  margin), picks.shape[0], card)
    del picks, log_u, sweeps.streamed_call
    seed = torch.tensor([BENCH_SEED], dtype=torch.int64, device=device)
    configs = sweeps.out.configs
    hold_call('K2', kernels,
              kernels.rbm_sweeps_prng(w, b, a, configs, sweeps.n_steps, seed),
              lambda margin: kernels.rbm_sweeps_prng_lanes_plain(
                  w, b, a, configs, configs @ w + b, sweeps.n_steps, seed,
                  lanes, margin), sweeps.n_steps, card)
    print(f'phase 36 wall time {time.perf_counter() - start:.2f} s {card}',
          flush=True)
    return launches


# 37. sr_fast_jacobian.  Rows are held to the JAX test's tolerance
# (tests/test_fast_jacobian.py:59) entry by entry.  A relu pre-activation
# within rounding of 0 can fall on the other side of the kink in the other
# f32 order, and then that sample's row parts (the JAX test's kink rule,
# :40-57): at most FAST_JAC_KINK_ROWS of the rows may, the global L2
# difference stays under 2e-3, and on the flagship each parted row must be
# the float64 forward's row in one of the two ways.
FAST_JAC_ATOL = 3e-5                # times max |rows|
FAST_JAC_RTOL = 2e-4
FAST_JAC_KINK_ROWS = 0.005
FAST_JAC_L2 = 2e-3
FAST_JAC_REPS = 5
PIXELCNN_JITTER = 0.05              # moves the PixelCNN's params off init


def raw_rows(wf, params, configs) -> torch.Tensor:
    """SR's vmap(grad) rows of ∂log|ψ| (optim/sr.py, uncentered)."""
    from cgs_vmc_tpu_torch.optim.sr import flatten_params, jacobian_rows
    flat, unflatten = flatten_params(params)
    return jacobian_rows(
        lambda p, c: wf.apply(unflatten(p), c[None, :]).log[0], flat,
        configs, 0)


def within(got, want, scale) -> torch.Tensor:
    """[rows] True where every entry is within the JAX test's tolerance."""
    return ((got - want).abs() <= FAST_JAC_ATOL * scale
            + FAST_JAC_RTOL * want.abs()).all(dim=1)


def rows_both_ways(label: str, wf, params, configs, card: str,
                   truth=None) -> None:
    """The fast rows against the vmap rows (see FAST_JAC_*; `truth(idx)`,
    where given, gives the float64 forward's rows of those samples), then
    each way's ms and peak memory, FAST_JAC_REPS reps in turns."""
    from cgs_vmc_tpu_torch.optim import fast_jacobian
    fast = fast_jacobian.rows_fn_for(wf)
    require(fast is not None, f'phase 37 {label}: no fast rows')
    ways = {'vmap': lambda: raw_rows(wf, params, configs),
            'fast': lambda: fast(params, configs, 0)}
    got, want = ways['fast'](), ways['vmap']()
    scale = float(want.abs().max())
    parted = (~within(got, want, scale)).nonzero()[:, 0]
    l2 = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    worst = float((got - want).abs().max()) / scale
    shape = tuple(want.shape)
    detail = ''
    if len(parted) and truth is not None:
        exact = truth(parted).to(got.dtype)
        fast_ok = within(got[parted], exact, scale)
        vmap_ok = within(want[parted], exact, scale)
        detail = (f'; of those the float64 rows are fast\'s in '
                  f'{int(fast_ok.sum())}, vmap\'s in {int(vmap_ok.sum())}')
        require(bool((fast_ok | vmap_ok).all()),
                f'phase 37 {label}: a parted row is neither way\'s float64 '
                'row')
    print(f'phase 37 {label} Jacobian rows {shape}: fast vs vmap within '
          f'atol {FAST_JAC_ATOL}*max|rows| ({scale:.4g}) + rtol '
          f'{FAST_JAC_RTOL} on all rows but {len(parted)} (relu kinks)'
          f'{detail}; max |diff| {worst:.3e} of max |rows|, global L2 '
          f'{l2:.3e}', flush=True)
    require(len(parted) <= FAST_JAC_KINK_ROWS * shape[0] and
            l2 < FAST_JAC_L2, f'phase 37 {label}: fast rows off the vmap '
            'rows beyond the tolerance')
    del got, want
    ms = {way: [] for way in ways}
    peak = {way: [] for way in ways}
    for _ in range(FAST_JAC_REPS):
        for way, fn in ways.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, seconds = timed(fn)
            del out
            ms[way].append(seconds * 1e3)
            peak[way].append((torch.cuda.max_memory_allocated() - base)
                             / 2 ** 30)
    print(f'phase 37 {label} Jacobian rows, ms median (min-max) of '
          f'{FAST_JAC_REPS} in turns: vmap {spread(ms["vmap"], 3)}, fast '
          f'{spread(ms["fast"], 3)}; peak memory over the inputs GiB: vmap '
          f'{spread(peak["vmap"], 3)}, fast {spread(peak["fast"], 3)} '
          f'{card}', flush=True)


def float64_rows(config, params, configs):
    """truth(idx) for rows_both_ways: the rows of configs[idx] through a
    float64 twin of the (symmetrized) conv (its compute dtype float64; the
    final site sum stays f32, as the ansatz's)."""
    from cgs_vmc_tpu_torch import models
    twin = models.build_wavefunction(config)
    twin._wf.compute_dtype = torch.float64
    params64 = {name: {k: v.double() for k, v in layer.items()}
                for name, layer in params.items()}
    return lambda idx: raw_rows(twin, params64, configs[idx].double())


def phase_fast_jacobian(repo: str, device, kernels, card: str) -> None:
    """37. optim/fast_jacobian.py on the card: the flagship's rows
    (configs/square66_conv_sr.json, its 4096 samples after one epoch) fast
    and by vmap(grad), held within the JAX test's tolerance, each way's ms
    and peak memory; one SR epoch with sr_fast_jacobian on and off; then
    phase 23's PixelCNN (rows only, 4096 exact draws).  No hand-written
    kernel runs on this path."""
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.base import tree_map
    from cgs_vmc_tpu_torch.optim import fast_jacobian
    from cgs_vmc_tpu_torch.optim.sr import StochasticReconfiguration
    from cgs_vmc_tpu_torch.train import build_hamiltonian
    start = time.perf_counter()
    profiling.reset_counters('k1.launches', 'k2.launches')
    config = Config.load(os.path.join(repo, 'configs',
                                      'square66_conv_sr.json'))
    wf = models.build_wavefunction(config)
    ham = build_hamiltonian(config)
    opts = {way: StochasticReconfiguration(
        wf, ham, config.replace(sr_fast_jacobian=way == 'fast'))
        for way in ('vmap', 'fast')}
    require(opts['fast'].fast_rows is not None,
            'phase 37: the flagship has no fast rows')
    state, _ = opts['vmap'].epoch(opts['vmap'].init_state(config.seed,
                                                          device))
    _, configs = opts['vmap'].sample(state.params, state.sampler)
    rows_both_ways(f'flagship (conv_2d 5x32, orbit {wf.n_ops})', wf,
                   state.params, configs, card,
                   float64_rows(config, state.params, configs))
    epoch_s = {way: [] for way in opts}
    energies = []
    for _ in range(FAST_JAC_REPS):
        for way, opt in opts.items():
            (_, metrics), seconds = timed(lambda: opt.epoch(state))
            epoch_s[way].append(seconds)
            energies.append(float(metrics['energy']))
    print(f'phase 37 flagship SR epoch ({configs.shape[0]} samples, dense '
          f'minSR) s median (min-max) of {FAST_JAC_REPS} in turns: '
          f'sr_fast_jacobian off {spread(epoch_s["vmap"], 4)}, on '
          f'{spread(epoch_s["fast"], 4)} {card}', flush=True)
    require(bool(np.isfinite(energies).all()),
            'phase 37: a non-finite SR epoch energy')

    config = Config(**dict(MADE_6X6, wavefunction_type='pixelcnn'))
    wf = models.build_wavefunction(config)
    generator = torch.Generator(device=device).manual_seed(37)
    params = wf.init(generator)
    configs = wf.sample(params, generator,
                        config.batch_size * config.num_batches_per_epoch)
    label = (f'pixelcnn ({config.num_conv_layers} layers x '
             f'{config.num_conv_filters}, k={config.kernel_size})')
    # At init (zero biases) every pre-activation that sees only the zero
    # padding and zeros is exactly 0: a relu kink, where cuDNN's conv need
    # not return an exact 0 as the im2col GEMM does, so whole rows take
    # another subgradient.  Counted here; the hold runs on params moved off
    # init.
    want = raw_rows(wf, params, configs)
    n_parted = int((~within(fast_jacobian.rows_fn_for(wf)(
        params, configs, 0), want, float(want.abs().max()))).sum())
    del want
    print(f'phase 37 {label} at init: {n_parted} of {configs.shape[0]} '
          'rows part (exact-zero relu kinks)', flush=True)
    params = tree_map(lambda x: x + PIXELCNN_JITTER * torch.randn(
        x.shape, generator=generator, device=device), params)
    rows_both_ways(f'{label}, params off init', wf, params, configs, card)
    require(profiling.counter('k1.launches') == 0
            and profiling.counter('k2.launches') == 0,
            'phase 37 launched an RBM sweep kernel')
    print(f'phase 37 wall time {time.perf_counter() - start:.2f} s {card}',
          flush=True)


def state_diff(a, b):
    """None when two train states are equal bit for bit (every tensor and
    every generator's state), else where they first part."""
    from cgs_vmc_tpu_torch.utils import tree
    (skel_a, leaves_a), (skel_b, leaves_b) = tree.flatten(a), tree.flatten(b)
    if len(leaves_a) != len(leaves_b):
        return 'the structure'
    for i, (x, y) in enumerate(zip(leaves_a, leaves_b)):
        if x.dtype != y.dtype or not torch.equal(x, y):
            return f'tensor {i} of {len(leaves_a)} {tuple(x.shape)}'
    for i, (x, y) in enumerate(zip(tree.generators(skel_a),
                                   tree.generators(skel_b))):
        if not torch.equal(x.get_state(), y.get_state()):
            return f'generator {i}'
    return None


def hold_runs(label: str, eager, graph) -> None:
    """Two (state, metric rows, K2 launches) runs equal bit for bit."""
    where = state_diff(eager[0], graph[0])
    require(where is None, f'{label}: the graph run parts from the eager '
            f'run at {where}')
    require(eager[1] == graph[1], f'{label}: the metrics part')
    require(eager[2] == graph[2], f'{label}: K2 launched {graph[2]} times '
            f'as graphs, {eager[2]} eagerly')


def run_both(run, config, replay: str, kernels, **kwargs):
    """(final state, metric rows, K2 launches) of run(config, 'cuda',
    replay=replay)."""
    timer = EpochTimer(f'phase 38 {replay}', every=10 ** 6)
    profiling.reset_counters('k1.launches', 'k2.launches')
    state = run(config, 'cuda', replay=replay, logger=timer, **kwargs)
    torch.cuda.synchronize()
    rows = [{k: v for k, v in r.items() if k != 'epoch_time_s'}
            for r in timer.records]
    return state, rows, profiling.counter('k2.launches')


def graph_cell(label: str, config, device, card: str, hold: bool) -> None:
    """One cell both ways, through the runners `train` uses: an eager
    runner and a graph runner from the same state, the warm-up, the capture
    (and first replay), GRAPH_TURNS epochs each way in turns (host clock,
    synchronized), one profiled epoch each way; with `hold`, the two states
    then equal bit for bit (a conv cell is timed with cuDNN's default
    algorithms, whose weight gradients two eager runs do not repeat bit for
    bit: its hold is the deterministic run of phase_epoch_graphs)."""
    from cgs_vmc_tpu_torch import train as train_lib
    _, opt, state = train_lib._init_ground_state(config, device)
    state = train_lib._maybe_add_ema_slot(state, config)
    eager = train_lib._runner(opt, config, None, device, 'eager')
    graph = train_lib._runner(opt, config, None, device, 'graph')
    states = {'eager': state,
              'graph': train_lib._maybe_add_ema_slot(
                  opt.init_state(config.seed, device, config.batch_size),
                  config)}
    runners = {'eager': eager, 'graph': graph}
    rows = {'eager': [], 'graph': []}
    times = {'eager': [], 'graph': []}

    def epoch(way):
        torch.cuda.synchronize()
        start = time.perf_counter()
        states[way], records = runners[way].run(states[way], 1)
        torch.cuda.synchronize()
        rows[way] += [{k: float(v) for k, v in r.items()} for r in records]
        return time.perf_counter() - start

    for way in ('eager', 'graph'):         # the warm-ups
        epoch(way)
    memory = {}
    for way in ('eager', 'graph'):         # the graph's: capture + replay
        torch.cuda.reset_peak_memory_stats()
        seconds = epoch(way)
        memory[way] = (torch.cuda.max_memory_allocated() / 2 ** 30,
                       torch.cuda.memory_reserved() / 2 ** 30)
    capture = seconds
    for _ in range(GRAPH_TURNS):
        for way in ('eager', 'graph'):
            times[way].append(epoch(way) * 1e3)
    # Busy share: the card's busy time in one profiled epoch over the
    # median unprofiled epoch (the profiler slows the host, not kernels).
    busy = {way: device_busy(lambda: epoch(way))[1:]
            for way in ('eager', 'graph')}
    share = {way: 100 * busy[way][1] * 1e3 / np.median(times[way])
             for way in busy}
    block = graph.blocks[1]
    where = state_diff(states['eager'], states['graph'])
    same = where is None and rows['eager'] == rows['graph']
    n_epochs = len(rows['eager'])
    print(f'phase 38 {label}: epoch ms eager {spread(times["eager"])}, '
          f'graph {spread(times["graph"])} (medians of {GRAPH_TURNS} in '
          f'turns); capture + first replay {capture:.3f} s (capture '
          f'{block.capture_s:.3f} s), {block.nodes} graph nodes; card busy '
          f'in a profiled epoch: eager {busy["eager"][1] * 1e3:.3f} ms '
          f'({busy["eager"][0]} device events, {share["eager"]:.1f}% of the '
          f'median epoch), graph {busy["graph"][1] * 1e3:.3f} ms '
          f'({busy["graph"][0]} events, {share["graph"]:.1f}%); peak '
          f'allocated / reserved after: eager {memory["eager"][0]:.3f} / '
          f'{memory["eager"][1]:.3f} GiB, graph (capture) '
          f'{memory["graph"][0]:.3f} / {memory["graph"][1]:.3f} GiB; '
          f'{n_epochs} epochs each way, bit for bit: {same}'
          f'{"" if hold else " (not held: cuDNN default algorithms)"} '
          f'{card}', flush=True)
    require(not hold or where is None, f'phase 38 {label}: the graph '
            f'state parts from the eager state at {where}')
    require(not hold or rows['eager'] == rows['graph'],
            f'phase 38 {label}: the metrics part')
    require(block.nodes > 0, f'phase 38 {label}: an empty graph')


def phase_epoch_graphs(repo: str, device, kernels, card: str) -> int:
    """38. The compiled epoch: `train` and `distill` replaying CUDA graphs
    against the same runs eager, bit for bit, then each cell's epoch both
    ways.  Returns K2's launches in the graph runs."""
    from cgs_vmc_tpu_torch import lattice
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models.full_vector import FullVector
    from cgs_vmc_tpu_torch.optim import SUPERVISED_OPTIMIZERS
    from cgs_vmc_tpu_torch.train import distill, train
    from cgs_vmc_tpu_torch.utils import ed
    start = time.perf_counter()
    graph_launches = 0
    for name, fields in GRAPH_CHAIN40.items():
        config = chain40_config(repo, wavefunction_optimizer_type=name,
                                num_epochs=GRAPH_EPOCHS, param_ema_decay=0.9,
                                **fields)
        eager = run_both(train, config, 'eager', kernels)
        for k in (1, 5):
            graph = run_both(train, config.replace(epochs_per_call=k),
                             'graph', kernels)
            hold_runs(f'phase 38 chain40 {name} k={k}', eager, graph)
            require(graph[2] == 5 * GRAPH_EPOCHS,
                    f'phase 38 chain40 {name}: K2 launched {graph[2]} '
                    f'times, expected {5 * GRAPH_EPOCHS}')
            graph_launches += graph[2]
        print(f'phase 38 chain40 {name} (EMA 0.9, LR stop at '
              f'{config.learning_rate_stops}): {GRAPH_EPOCHS} epochs eager '
              f'and as graphs at k = 1 and 5 bit for bit (states, '
              f'generator, metrics); K2 {eager[2]} launches each way '
              f'{card}', flush=True)

    _, v0 = ed.ground_state(16, lattice.square_lattice_bonds(4, 4),
                            j_x=-1.0)
    vector = np.abs(v0).astype(np.float32)
    target = dict(target_wf=FullVector.for_sector(16, vector),
                  target_params={'ed_vector': torch.tensor(vector,
                                                           device=device)})
    for name in sorted(SUPERVISED_OPTIMIZERS):
        config = Config(**DISTILL, wavefunction_optimizer_type=name,
                        num_epochs=GRAPH_EPOCHS)
        eager = run_both(distill, config, 'eager', kernels, **target)
        graph = run_both(distill, config, 'graph', kernels, **target)
        hold_runs(f'phase 38 distill {name}', eager, graph)
        graph_launches += graph[2]
        print(f'phase 38 distill {name} (4x4 ED state): {GRAPH_EPOCHS} '
              f'epochs eager and one graph an epoch bit for bit; K2 '
              f'{graph[2]} launches {card}', flush=True)

    # The conv configs, held with cuDNN's deterministic algorithms both
    # ways: by default its weight gradients sum with atomics, and two eager
    # runs part in the last bits (PERF.md §6).
    torch.backends.cudnn.deterministic = True
    for name, epochs in GRAPH_CONV_EPOCHS.items():
        config = Config.load(os.path.join(repo, 'configs', f'{name}.json'))
        config = config.replace(num_epochs=epochs)
        eager = run_both(train, config, 'eager', kernels)
        graph = run_both(train, config, 'graph', kernels)
        hold_runs(f'phase 38 {name}', eager, graph)
        print(f'phase 38 {name} (cuDNN deterministic): {epochs} epochs eager '
              f'and as graphs bit for bit {card}', flush=True)
    torch.backends.cudnn.deterministic = False

    for name in GRAPH_CHAIN40:
        graph_cell(f'chain40 {name}', chain40_config(
            repo, wavefunction_optimizer_type=name, param_ema_decay=0.9,
            **GRAPH_CHAIN40[name]), device, card, hold=True)
    for name in GRAPH_CONV_EPOCHS:
        graph_cell(name, Config.load(os.path.join(
            repo, 'configs', f'{name}.json')), device, card, hold=False)
    print(f'phase 38 wall time {time.perf_counter() - start:.2f} s {card}',
          flush=True)
    return graph_launches


def phase_periodic_conv(device, card: str) -> dict:
    """39. The periodic conv kernel at the flagship sampler's shapes: the
    wrapper against the plain route in float64 (ReLU on and off), then the
    C entry point alone, its bound, and the plain route in f32.  Returns the
    32→32 layer's {max_abs_err, ms, bound_ms, bound_by, library_ms}."""
    import torch.nn.functional as F
    from cgs_vmc_tpu_torch.models import nn, periodic_conv2d
    lo, hi = nn._pad_widths_2d(PCONV_K)

    def plain(x, w, b, relu):
        padded = nn._wrap(nn._wrap(x, 3, lo, hi), 2, lo, hi)
        out = F.conv2d(padded, w.permute(3, 2, 0, 1)) + b[:, None, None]
        return torch.relu(out) if relu else out

    generator = torch.Generator(device=device).manual_seed(39)
    lib = periodic_conv2d.library(PCONV_K, PCONV_SIDE, lo)
    record = {}
    for c_in, c_out in PCONV_CHANNELS:
        shape = (PCONV_IMAGES, c_in, PCONV_SIDE, PCONV_SIDE)
        x = torch.relu(torch.randn(shape, generator=generator,
                                   device=device))
        w = torch.randn((PCONV_K, PCONV_K, c_in, c_out), generator=generator,
                        device=device) / (PCONV_K * c_in ** 0.5)
        b = 0.1 * torch.randn(c_out, generator=generator, device=device)
        err = 0.0
        with torch.no_grad():
            for relu in (False, True):
                profiling.reset_counters('periodic_conv.launches')
                out = nn.conv2d_periodic_apply({'w': w, 'b': b}, x,
                                               relu=relu)
                require(profiling.counter('periodic_conv.launches') == 1,
                        f'phase 39 {c_in}->{c_out}: the kernel did not run')
                ref = plain(x.double(), w.double(), b.double(), relu)
                diff = (out.double() - ref).abs()
                err = max(err, float(diff.max()))
                require(bool((diff <= PCONV_TOL * (1 + ref.abs())).all()),
                        f'phase 39 {c_in}->{c_out} relu={relu}: off the '
                        f'plain route by {float(diff.max()):.3e}')
            out = torch.empty((PCONV_IMAGES, c_out, PCONV_SIDE, PCONV_SIDE),
                              device=device)

            def launch():
                code = lib.raw('periodic_conv2d_f32', x, w, b, out,
                               PCONV_IMAGES, c_in, c_out, PCONV_SIDE,
                               PCONV_SIDE, PCONV_K, 1)
                require(code == 0, f'phase 39 launch failed: {code}')
            ms = event_ms(launch, PCONV_REPS)
            library_ms = event_ms(lambda: plain(x, w, b, True), PCONV_REPS)
        sites = PCONV_IMAGES * PCONV_SIDE ** 2
        ops = 2 * PCONV_K ** 2 * c_in * c_out * sites
        nbytes = 4 * (sites * (c_in + c_out) + PCONV_K ** 2 * c_in * c_out
                      + c_out)
        t_ops, t_bytes = ops / F32_PEAK, nbytes / HBM_RATE
        bound, bound_by = ((t_ops, 'operations') if t_ops >= t_bytes
                           else (t_bytes, 'bytes'))
        print(f'phase 39 periodic conv {PCONV_IMAGES} images {c_in}->{c_out} '
              f'at {PCONV_SIDE}x{PCONV_SIDE}, k={PCONV_K}: max |d| vs the '
              f'float64 plain route {err:.3e} (tol {PCONV_TOL}); kernel '
              f'alone {ms:.4f} ms ({ops / ms * 1e-9:.2f} TFLOP/s), bound '
              f'{bound * 1e3:.4f} ms ({bound_by}), {bound * 1e3 / ms:.2%} of '
              f'it; plain route (2 cats + cuDNN + bias + ReLU) '
              f'{library_ms:.4f} ms, {library_ms / ms:.2f}x the kernel '
              f'{card}', flush=True)
        record = {'max_abs_err': err, 'ms': ms, 'bound_ms': bound * 1e3,
                  'bound_by': bound_by, 'library_ms': library_ms}
    return record


def phase_attention(repo: str, device, card: str) -> dict:
    """40. The attention kernel at the transformer cell's shapes, then its
    launches and the spans of a few epochs of the cell's configuration.
    Returns the proposal shape's {max_abs_err, ms, bound_ms, bound_by,
    plain_ms, library_ms} and the launches and plain calls an epoch."""
    import torch.nn.functional as F
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch.models import spin_attention
    from cgs_vmc_tpu_torch.train import train
    n, heads, dh = ATTN_N, ATTN_HEADS, ATTN_HEAD_DIM
    d = heads * dh
    lib = spin_attention.library(n, heads, dh)
    generator = torch.Generator(device=device).manual_seed(40)
    record = {}
    for label, images in ATTN_IMAGES:
        qkv = torch.randn((images, n, 3 * d), generator=generator,
                          device=device)
        profiling.reset_counters('attention.launches')
        out = spin_attention.spin_attention(qkv, heads)
        require(profiling.counter('attention.launches') == 1,
                f'phase 40 {label}: the kernel did not run')
        # float64 where it fits beside the rest: the chunk's float64 logits
        # would be 12 GB.
        ref_dtype = torch.float64 if images <= 4096 else torch.float32
        ref = spin_attention.plain(qkv.to(ref_dtype), heads)
        diff = (out.to(ref_dtype) - ref).abs()
        err = float(diff.max())
        require(bool((diff <= ATTN_TOL * (1 + ref.abs())).all()),
                f'phase 40 {label}: off the plain einsums by {err:.3e}')
        del ref, diff

        def launch():
            code = lib.raw('spin_attention_f32', qkv, out, images, n, heads,
                           dh)
            require(code == 0, f'phase 40 launch failed: {code}')
        ms = event_ms(launch, ATTN_REPS)
        plain_ms = event_ms(lambda: spin_attention.plain(qkv, heads),
                            ATTN_REPS)
        q, k, v = qkv.view(images, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        library_ms = event_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), ATTN_REPS)
        nbytes = 4 * images * n * 4 * d
        ops = 2 * 2 * images * n * n * d
        t_ops, t_bytes = ops / F32_PEAK, nbytes / HBM_RATE
        bound, bound_by = ((t_ops, 'operations') if t_ops >= t_bytes
                           else (t_bytes, 'bytes'))
        print(f'phase 40 attention {label}: {images} images, n={n}, '
              f'{heads} heads of {dh}: max |d| vs the {ref_dtype} plain '
              f'einsums {err:.3e} (tol {ATTN_TOL}); kernel alone {ms:.4f} ms '
              f'({nbytes / ms * 1e-9:.3f} TB/s, {ops / ms * 1e-9:.2f} '
              f'TFLOP/s), bound {bound * 1e3:.4f} ms ({bound_by}), '
              f'{bound * 1e3 / ms:.2%} of it; plain einsums {plain_ms:.4f} '
              f'ms, {plain_ms / ms:.2f}x the kernel; '
              f'F.scaled_dot_product_attention {library_ms:.4f} ms {card}',
              flush=True)
        if not record:
            record = {'max_abs_err': err, 'ms': ms,
                      'bound_ms': bound * 1e3, 'bound_by': bound_by,
                      'plain_ms': plain_ms, 'library_ms': library_ms}
        del qkv, out, q, k, v
    torch.cuda.empty_cache()

    config = Config.load(os.path.join(
        repo, 'configs', 'square66_transformer_sr.json')).replace(
            batch_size=ATTN_CHAINS, num_epochs=ATTN_EPOCHS,
            checkpoint_dir=fresh_run_dir(repo, 'chip_smoke_attention'))
    names = ('attention.launches', 'attention.plain',
             'encoder_linear.launches', 'encoder_linear.plain',
             'encoder.images', 'sr.row_blocks')
    profiling.reset_counters(*names)
    profiling.reset()
    profiling.spans(True)
    timer = EpochTimer('phase 40 square66_transformer_sr at '
                       f'{ATTN_CHAINS} chains')
    torch.cuda.reset_peak_memory_stats()
    train(config, device, logger=timer)
    profiling.spans(False)
    peak = torch.cuda.max_memory_allocated()
    counts = {name: profiling.counter(name) for name in names}
    for row in profiling.span_report()['epochs']:
        spans_ms = {k: round(v, 3) for k, v in row['device_ms'].items()}
        phases = {k: round(v, 3)
                  for k, v in profiling.phase_ms(row).items()}
        print(f'phase 40 epoch {row["epoch"]} spans (device ms): {spans_ms}; '
              f'phases {phases} {card}', flush=True)
    per_epoch = {name: count / ATTN_EPOCHS for name, count in counts.items()}
    print(f'phase 40 square66_transformer_sr at {ATTN_CHAINS} chains, '
          f'{ATTN_EPOCHS} epochs (the first eager, then replays): counters '
          f'{counts}, an epoch {per_epoch}; epoch seconds '
          f'{[round(r["epoch_time_s"], 3) for r in timer.records]}; peak '
          f'memory {peak} B {card}', flush=True)
    require(counts['attention.launches'] > 0 and
            counts['attention.launches'] % config.num_attention_layers == 0,
            'phase 40: the no-grad forwards did not launch the attention '
            'kernel once a layer')
    require(counts['attention.plain'] ==
            config.num_attention_layers * counts['sr.row_blocks'],
            'phase 40: a call other than the SR rows took the plain einsums')
    require(counts['encoder_linear.launches'] ==
            4 * counts['attention.launches'],
            'phase 40: the no-grad forwards did not launch the fused linear '
            'kernel four times a layer')
    require(counts['encoder_linear.plain'] ==
            4 * config.num_attention_layers * counts['sr.row_blocks'],
            'phase 40: a call other than the SR rows took the plain linears')
    record.update(launches=counts['attention.launches'],
                  launches_per_epoch=per_epoch['attention.launches'],
                  plain_calls=counts['attention.plain'],
                  linear_launches=counts['encoder_linear.launches'],
                  linear_launches_per_epoch=per_epoch[
                      'encoder_linear.launches'],
                  linear_plain_calls=counts['encoder_linear.plain'])
    return record


def phase_encoder_linear(device, card: str) -> dict:
    """41. The encoder's fused linear kernel, each instance at a
    proposal's and a connected-board chunk's rows: the wrapper against the
    plain chain in float32, then the C entry point alone, its bound, the
    plain chain and torch.matmul alone.  Returns {instance: {label: {ms,
    bound_ms, bound_by, plain_ms, library_ms, max_abs_err}}}."""
    from cgs_vmc_tpu_torch.models import encoder_linear
    lib = encoder_linear.library()
    generator = torch.Generator(device=device).manual_seed(41)

    def randn(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=generator,
                                           device=device)

    names = ('qkv', 'attn_out', 'mlp_in', 'mlp_out')
    record = {}
    for name, (k, n, ln, epilogue) in zip(names, encoder_linear.VARIANTS):
        gelu, res = epilogue == 'gelu', epilogue == 'residual'
        layer = {'w': randn(k, n, scale=k ** -0.5), 'b': randn(n, scale=0.1)}
        norm = ({'g': randn(k, scale=0.1, shift=1.0),
                 'b': randn(k, scale=0.1)} if ln else None)
        record[name] = {}
        for label, images in ELIN_IMAGES:
            rows = images * ELIN_TOKENS
            x = randn(images, ELIN_TOKENS, k, shift=0.3)
            residual = randn(images, ELIN_TOKENS, n) if res else None
            with torch.no_grad():
                profiling.reset_counters('encoder_linear.launches')
                out = encoder_linear.linear(layer, x, norm, gelu, residual)
                require(profiling.counter('encoder_linear.launches') == 1,
                        f'phase 41 {name} {label}: the kernel did not run')
                ref = encoder_linear.plain(layer, x, norm, gelu, residual)
                diff = (out - ref).abs()
                err = float(diff.max())
                require(bool((diff <= ELIN_TOL * (1 + ref.abs())).all()),
                        f'phase 41 {name} {label}: off the plain chain by '
                        f'{err:.3e}')
                del ref, diff
                g, beta = ((None, None) if norm is None
                           else (norm['g'], norm['b']))

                def launch():
                    code = lib.raw('encoder_linear_f32', x, layer['w'],
                                   layer['b'], g, beta, residual, out, rows,
                                   k, n, int(ln),
                                   encoder_linear.EPILOGUES[epilogue])
                    require(code == 0, f'phase 41 launch failed: {code}')
                ms = event_ms(launch, ELIN_REPS)
                plain_ms = event_ms(lambda: encoder_linear.plain(
                    layer, x, norm, gelu, residual), ELIN_REPS)
                x2 = x.view(rows, k)
                library_ms = event_ms(lambda: torch.matmul(x2, layer['w']),
                                      ELIN_REPS)
            ops = 2 * rows * k * n
            nbytes = 4 * (rows * (k + n + (n if res else 0)) + k * n + n
                          + (2 * k if ln else 0))
            t_ops, t_bytes = ops / F32_PEAK, nbytes / HBM_RATE
            bound, bound_by = ((t_ops, 'operations') if t_ops >= t_bytes
                               else (t_bytes, 'bytes'))
            print(f'phase 41 encoder linear {name} ({k}->{n}, layernorm '
                  f'{ln}, epilogue {epilogue}) {label}: {images} images, '
                  f'{rows} rows: max |d| vs the float32 plain chain '
                  f'{err:.3e} (tol {ELIN_TOL}); kernel alone {ms:.4f} ms '
                  f'({ops / ms * 1e-9:.2f} TFLOP/s, {nbytes / ms * 1e-9:.3f} '
                  f'TB/s), bound {bound * 1e3:.4f} ms ({bound_by}), '
                  f'{bound * 1e3 / ms:.2%} of it; plain chain {plain_ms:.4f} '
                  f'ms, {plain_ms / ms:.2f}x the kernel; torch.matmul alone '
                  f'{library_ms:.4f} ms {card}', flush=True)
            record[name][label] = {'max_abs_err': err, 'ms': ms,
                                   'bound_ms': bound * 1e3,
                                   'bound_by': bound_by,
                                   'plain_ms': plain_ms,
                                   'library_ms': library_ms}
            del x, residual, out, x2
            torch.cuda.empty_cache()
    return record


def phase_build(kernels) -> None:
    """2. nvcc builds the kernels; ptxas's registers and spills of the
    instances the bench and slice shapes run, at every width."""
    start = time.perf_counter()
    kernels.build()
    print(f'phase 2 build: kernels loaded in '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    mismatches = kernels.log1p_mismatches(torch.device('cuda'))
    print(f'phase 2 branch-free log1p vs log1pf over every float in [0, 1]: '
          f'{mismatches} differ', flush=True)
    require(mismatches == 0, 'the kernels\' log1p is not log1pf')
    resources = kernels.kernel_resources()
    for shape, (n_sites, hidden) in SHAPES.items():
        for g in kernels.LANES:
            if -(-hidden // g) > kernels.MAX_UNITS_PER_LANE:
                continue
            inst = kernels.instance(n_sites, hidden, g)
            for kernel in ('K1', 'K2'):
                rec = resources[(kernel, *inst)]
                print(f'phase 2 ptxas {kernel} {shape} (G, words, slots) '
                      f'{inst}: {rec.get("registers")} registers, spill '
                      f'stores/loads {rec.get("spill_stores")}/'
                      f'{rec.get("spill_loads")} B', flush=True)


def phase_compare(kernels, device) -> dict:
    """3.-4. Both kernels against their plain versions: the main shapes
    with the rule's width, the other width at 2 sweeps, the edge shapes;
    then K2's equilibrium acceptance against K1's.  Returns the largest
    |Δlogψ| of each kernel."""
    errs = {'rbm_sweeps': 0.0, 'rbm_sweeps_prng': 0.0}
    for i, (shape, sweeps) in enumerate(COMPARISONS):
        n_sites, hidden = SHAPES[shape]
        w, b, a, configs = rbm_inputs(n_sites, hidden, 10 + i, device)
        compare_both(f'{shape} N={n_sites} H={hidden}, {sweeps} sweeps, '
                     f'rule G={kernels.instance(n_sites, hidden)[0]}', w, b, a,
                     configs, sweeps * n_sites, 20 + i, 0, kernels, errs)
    for i, (shape, (n_sites, hidden)) in enumerate(SHAPES.items()):
        w, b, a, configs = rbm_inputs(n_sites, hidden, 30 + i, device)
        for g in kernels.LANES:
            if -(-hidden // g) > kernels.MAX_UNITS_PER_LANE:
                print(f'phase 3-4 {shape} G={g}: refused ({-(-hidden // g)}'
                      f' units a lane > {kernels.MAX_UNITS_PER_LANE})',
                      flush=True)
                continue
            compare_both(f'{shape} N={n_sites} H={hidden}, 2 sweeps, '
                         f'forced G={g}', w, b, a, configs, 2 * n_sites,
                         40 + i, g, kernels, errs)
    for j, (n_sites, hidden, chains) in enumerate(EDGE_SHAPES):
        rule = kernels.instance(n_sites, hidden)[0]
        w, b, a, configs = rbm_inputs(n_sites, hidden, 70 + j, device,
                                      chains)
        for n_steps in (0, rule + 1):
            compare_both(f'edge N={n_sites} H={hidden} {chains} chains, '
                         f'{n_steps} steps, rule G={rule}', w, b, a, configs,
                         n_steps, 100 + j, 0, kernels, errs)

    n_sites, hidden = SHAPES['bench']
    w, b, a, configs = rbm_inputs(n_sites, hidden, 30, device)
    generator = torch.Generator(device=device).manual_seed(31)
    rates = {}
    for kernel in ('K1', 'K2'):
        state = configs
        for phase in ('equilibrate', 'measure'):
            n_steps = 20 * n_sites
            if kernel == 'K1':
                picks = kernels.sample_picks(generator, n_steps, n_sites,
                                             CHAINS)
                log_u = torch.log(torch.rand((n_steps, CHAINS),
                                             generator=generator,
                                             device=device))
                out = kernels.rbm_sweeps(w, b, a, state, picks, log_u)
            else:
                seed = torch.randint(0, 2 ** 32, (1,), generator=generator,
                                     device=device, dtype=torch.int64)
                out = kernels.rbm_sweeps_prng(w, b, a, state, n_steps, seed)
            state = out.configs
        rates[kernel] = float(out.num_accepted.sum()) / (n_steps * CHAINS)
    print(f'phase 4 equilibrium acceptance at bench shape: K1 '
          f'{rates["K1"]:.5f}, K2 {rates["K2"]:.5f}', flush=True)
    require(abs(rates['K1'] - rates['K2']) < ACC_TOL,
            'K2 acceptance differs from K1 by more than 0.01')
    require(bool((state.sum(dim=1) == 0).all()), 'K2 left the Sz=0 sector')
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script runs on a '
              'GPU only', file=sys.stderr)
        return 1
    start_all = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from cgs_vmc_tpu_torch.config import Config
    from cgs_vmc_tpu_torch import models
    from cgs_vmc_tpu_torch.evaluate import evaluate_operator
    from cgs_vmc_tpu_torch.sampler import fast_rbm, kernels
    from cgs_vmc_tpu_torch.train import build_hamiltonian, train
    from cgs_vmc_tpu_torch.utils.device import resolve_device

    # 1. Device.
    device = resolve_device('cuda')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = f'[{smi}]'
    print(f'phase 1 device: {name}; nvidia-smi: {smi}; torch '
          f'{torch.__version__}, CUDA {torch.version.cuda}; TF32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, TF32 cuDNN '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)

    # 2. Build.
    phase_build(kernels)

    # 3./4. Kernels against their plain versions.
    errs = phase_compare(kernels, device)

    # 5. Slice: training, launch counters zeroed just before.
    config = Config.load(os.path.join(repo, 'configs', 'chain40_sr.json'))
    config = config.parse(
        'wavefunction_optimizer_type=EnergyGradient,optimizer=adam,'
        f'learning_rates=[1e-2],learning_rate_stops=[],num_epochs={EPOCHS}')
    config = config.replace(
        checkpoint_dir=fresh_run_dir(repo, 'chip_smoke_run'))
    profiling.reset_counters('k1.launches', 'k2.launches')
    timer = EpochTimer()
    state = train(config, 'cuda', logger=timer)
    energies = [r['energy'] for r in timer.records]
    acc = timer.records[-1]['acceptance_rate']
    print(f'phase 5 train: {len(energies)} epochs, E first '
          f'{energies[0]:.6f}, mean of last 5 {np.mean(energies[-5:]):.6f}, '
          f'acceptance {acc:.4f}, K2 launches '
          f'{profiling.counter("k2.launches")} '
          f'({profiling.counter("k2.launches") / EPOCHS:g} an epoch, G='
          f'{kernels.instance(config.num_sites, config.fc_layer_size)[0]})',
          flush=True)
    require(len(energies) == EPOCHS and all(np.isfinite(energies)),
            'non-finite training energy')
    require(np.mean(energies[-5:]) < energies[0],
            'training energy did not fall over 20 epochs')
    require(0.05 < acc < 0.98, f'implausible acceptance rate {acc}')
    require(profiling.counter('k2.launches') > 0,
            'training did not launch the K2 kernel')

    # 6. Slice: evaluation, with K2 (the default) and with K1.
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    n = config.num_sites
    results = {
        'K2': evaluate_operator(wf, state.params, hamiltonian, config,
                                'cuda'),
        'K1': evaluate_operator(
            wf, state.params, hamiltonian, config, 'cuda',
            sweeps_fn=lambda p, s, k: fast_rbm.run_sweeps(
                wf, p, s, k, use_kernel_prng=False)),
    }
    launches = {'rbm_sweeps': profiling.counter('k1.launches'),
                'rbm_sweeps_prng': profiling.counter('k2.launches')}
    for label, res in results.items():
        e, err = res.mean / n, res.error / n
        print(f'phase 6 eval ({label} sampler): E/N = {e:.6f} +/- '
              f'{err:.6f}, acceptance {res.acceptance_rate:.4f}', flush=True)
        require(np.isfinite(e) and np.isfinite(err), 'non-finite E/N')
        require(e >= BETHE_E_PER_SITE - 5 * err,
                f'E/N {e} below the variational bound')
    gap = abs(results['K1'].mean - results['K2'].mean) / n
    sigma = np.hypot(results['K1'].error, results['K2'].error) / n
    print(f'phase 6 K1 vs K2 evaluation: |dE/N| {gap:.6f}, '
          f'{gap / sigma:.2f} sigma', flush=True)
    require(gap <= 5 * sigma, 'K1 and K2 evaluations disagree')
    print(f'main path launches: {launches}', flush=True)
    require(all(v > 0 for v in launches.values()),
            'a kernel of the main path was never launched')

    # 7. Times at the bench shape (same calls for kernel and plain).
    n_sites, hidden = SHAPES['bench']
    w, b, a, configs = rbm_inputs(n_sites, hidden, 40, device)
    n_steps = TIMING_SWEEPS * n_sites
    picks, log_u = streamed_draws(n_sites, n_steps, 41, device)
    seed = torch.tensor([99], dtype=torch.int64, device=device)
    times = {
        'rbm_sweeps': (
            time_call(lambda: kernels.rbm_sweeps(w, b, a, configs, picks,
                                                 log_u), 20),
            time_call(lambda: kernels.rbm_sweeps_plain(w, b, a, configs,
                                                       picks, log_u), 2)),
        'rbm_sweeps_prng': (
            time_call(lambda: kernels.rbm_sweeps_prng(w, b, a, configs,
                                                      n_steps, seed), 20),
            time_call(lambda: kernels.rbm_sweeps_prng_plain(
                w, b, a, configs, n_steps, seed), 2)),
    }
    for label, (t_kernel, t_plain) in times.items():
        print(f'phase 7 {label} at N={n_sites} H={hidden} {CHAINS} chains, '
              f'{TIMING_SWEEPS} sweeps a call: kernel {t_kernel * 1e3:.4f} ms'
              f' ({TIMING_SWEEPS / t_kernel:.1f} sweeps/s), plain '
              f'{t_plain * 1e3:.2f} ms ({TIMING_SWEEPS / t_plain:.2f} '
              f'sweeps/s) {card}', flush=True)
    print(f'phase 7 slice epoch (N=40, H=160, {config.batch_size} chains, '
          f'EnergyGradient): mean {timer.mean_epoch_ms():.2f} ms over '
          f'epochs 2-{EPOCHS} {card}', flush=True)
    kernel_table = phase_kernel_times(kernels, device, card)

    # 8.-9. Artifacts and their evaluation.
    phase_artifacts(repo, device)
    phase_eval(repo, device)

    # 10. SR training: the flagship (periodic conv counts zeroed), then
    # chain40 on K2 (counts zeroed).
    profiling.reset_counters('periodic_conv.launches', 'periodic_conv.plain')
    flagship = phase_sr_train(repo, device, 'square66_conv_sr',
                              SR_EPOCHS['square66_conv_sr'])
    pconv_epochs = SR_EPOCHS['square66_conv_sr']
    pconv_launches = profiling.counter('periodic_conv.launches')
    pconv_plain = profiling.counter('periodic_conv.plain')
    print(f'phase 10 flagship periodic conv: {pconv_launches} kernel '
          f'launches ({pconv_launches / pconv_epochs:g} an epoch), '
          f'{pconv_plain} plain-route calls ({pconv_plain / pconv_epochs:g} '
          f'an epoch, the SR rows)', flush=True)
    require(pconv_launches > 0 and pconv_launches % 5 == 0,
            'the flagship\'s no-grad forwards did not launch the periodic '
            'conv kernel once a layer')
    require(pconv_plain == 5 * pconv_epochs,
            'a conv call of the flagship other than the SR rows took the '
            'plain route')
    profiling.reset_counters('k1.launches', 'k2.launches')
    chain = phase_sr_train(repo, device, 'chain40_sr',
                           SR_EPOCHS['chain40_sr'])
    sr_launches = profiling.counter('k2.launches')
    print(f'phase 10 SR path launches: K2 {sr_launches} '
          f'({sr_launches / SR_EPOCHS["chain40_sr"]:g} an epoch), K1 '
          f'{profiling.counter("k1.launches")}', flush=True)
    require(sr_launches > 0, 'SR training did not launch the K2 kernel')

    # 11. Times.
    start = time.perf_counter()
    parts = phase_sr_times(flagship[0], flagship[1])
    print(f'phase 11 flagship SR epoch (conv_2d 5x32, C4v x spin flip, '
          f'{parts["samples"]} samples, {parts["params"]} params, dense '
          f'minSR): sr_epoch_wall_s {parts["sr_epoch_wall_s"]:.4f}; '
          f'sampling {parts["sampling_s"]:.4f} s, local energy '
          f'{parts["local_energy_s"]:.4f} s, Jacobian rows '
          f'{parts["jacobian_s"]:.4f} s, assembly + Cholesky solve '
          f'{parts["solve_s"]:.4f} s; TF32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, TF32 cuDNN '
          f'{torch.backends.cudnn.allow_tf32} {card}', flush=True)
    print(f'phase 11 chain40 SR epoch (RBM H=160, '
          f'{chain[0].batch_size * chain[0].num_batches_per_epoch} samples, '
          f'dense SR, K2 sampler): mean {chain[2].mean_epoch_ms():.2f} ms '
          f'over epochs 2-{SR_EPOCHS["chain40_sr"]} {card}; phase 11 wall '
          f'time {time.perf_counter() - start:.2f} s', flush=True)

    # 12.-15. Imaginary-time SWO, the RESULTS.md row-3 config, distillation.
    supervisor_dir = phase_itswo(repo, device, kernels, card)
    phase_square44(repo, device, kernels, card)
    phase_distill_exact(device, kernels, card)
    phase_distill_run(repo, device, kernels, supervisor_dir, card)

    # 16.-17. The complex-phase path: J1-J2 (Majumdar-Ghosh), the twisted
    # chain, the spin-stiffness pair.
    complex_dir = phase_complex_config(repo, device, 16,
                                       'j1j2_chain8_complex_sr', card)
    phase_complex_config(repo, device, 17, 'twisted_chain16_sr', card,
                         TWISTED_EPOCHS)
    phase_stiffness(device, card)

    # 18.-19. The incremental samplers and the ansatz families.
    phase_sampler_cells(device, card)
    phase_families(repo, device, card)

    # 20.-25. More committed configs, exact draws, the sampler knobs, the
    # TFIM; none of them runs a hand-written kernel.
    profiling.reset_counters('k1.launches', 'k2.launches')
    phase_deep_eval(repo, device, card)
    phase_unrun_configs(repo, device, card)
    phase_transformer(repo, device, card)
    phase_autoregressive(repo, device, card)
    phase_sampler_knobs(repo, device, card)
    phase_tfim(repo, device, card)
    require(profiling.counter('k1.launches') == 0
            and profiling.counter('k2.launches') == 0,
            'phases 20-25 launched an RBM sweep kernel')

    # 26.-30. Measurement and dynamics: observables, the Lanczos step,
    # Renyi-2, t-VMC and linear response, excited states; K2 samples
    # phase 12's chain40 run in each (its counts zeroed inside).
    start = time.perf_counter()
    phase_observables(supervisor_dir, device, kernels, card)
    phase_lanczos(repo, supervisor_dir, device, kernels, card)
    phase_renyi(supervisor_dir, device, kernels, card)
    phase_time_evolution(supervisor_dir, complex_dir, device, kernels, card)
    phase_excited(repo, supervisor_dir, device, kernels, card)
    print(f'phases 26-30 wall time {time.perf_counter() - start:.2f} s '
          f'{card}', flush=True)

    # 31.-34. The run plumbing on chain40 (K2 in each): EMA weights,
    # params-only artifacts both ways, a profiler trace, the sharded path
    # over NCCL at world size 1.
    start = time.perf_counter()
    late, ema_dir = phase_ema(repo, device, kernels, card)
    phase_artifacts_both_ways(repo, ema_dir, device, card)
    late += phase_profile(repo, device, kernels, kernel_table, card)
    late += phase_nccl(repo, device, kernels, card)
    launches['rbm_sweeps_prng'] += late
    print(f'phases 31-34 wall time {time.perf_counter() - start:.2f} s; '
          f'K2 launches {late} {card}', flush=True)

    # 35.-36. The two other entry points: entry() and the bench's
    # functions at the bench's shapes (K1 and K2 counted in phase 36).
    phase_entry(device, kernels, card)
    for label, count in phase_bench(device, kernels, card).items():
        launches[label] += count

    # 37. The fast Jacobian rows, both ways (no hand-written kernel).
    phase_fast_jacobian(repo, device, kernels, card)

    # 38. The compiled epoch: graphs against eager (K2 counted in each).
    launches['rbm_sweeps_prng'] += phase_epoch_graphs(repo, device, kernels,
                                                      card)

    # 39. The periodic conv kernel alone at the flagship's shapes.
    pconv = phase_periodic_conv(device, card)

    # 40. The attention kernel alone at the transformer cell's shapes, and
    # its launches an epoch of the cell's configuration.
    attn = phase_attention(repo, device, card)

    # 41. The encoder's fused linear kernel alone at the transformer cell's
    # row counts (its launches an epoch counted in phase 40).
    elin = phase_encoder_linear(device, card)

    source = 'cgs_vmc_tpu_torch/csrc/rbm_sweep.cu'
    replaces = {'rbm_sweeps': 'cgs_vmc_tpu/sampler/kernels.py:77',
                'rbm_sweeps_prng': 'cgs_vmc_tpu/sampler/kernels.py:324'}
    # launches: phases 5-6 and 36, and for K2 phases 31-34 too.
    # ms, plain_ms and bound_ms: one wrapper call of TIMING_SWEEPS sweeps
    # at the bench shape; no single PyTorch call computes a Metropolis
    # sweep, so library_ms is null.
    n_sites, hidden = SHAPES['bench']
    bounds = {label: sweep_bound(kernel, CHAINS, n_sites, hidden,
                                 TIMING_SWEEPS * n_sites)
              for label, kernel in (('rbm_sweeps', 'K1'),
                                    ('rbm_sweeps_prng', 'K2'))}
    report = {'kernels': [
        {'name': label, 'route': 'cuda', 'source': source,
         'replaces': replaces[label], 'launches': launches[label],
         'max_abs_err': errs[label], 'ms': times[label][0] * 1e3,
         'plain_ms': times[label][1] * 1e3,
         'bound_ms': bounds[label][0] * 1e3, 'bound_by': bounds[label][1],
         'library_ms': None,
         'lanes_per_chain': kernels.instance(n_sites, hidden)[0]}
        for label in ('rbm_sweeps', 'rbm_sweeps_prng')]}
    # The periodic conv replaces no TPU kernel (the JAX package's conv is
    # lax.conv); its plain route is the library route (cuDNN), so plain_ms
    # is library_ms.  launches: phase 10(a), the flagship's SR run.
    report['kernels'].append(
        {'name': 'periodic_conv2d', 'route': 'cuda',
         'source': 'cgs_vmc_tpu_torch/csrc/periodic_conv2d.cu',
         'replaces': None, 'launches': pconv_launches,
         'launches_per_epoch': pconv_launches / pconv_epochs,
         'plain_calls': pconv_plain, 'max_abs_err': pconv['max_abs_err'],
         'ms': pconv['ms'], 'plain_ms': pconv['library_ms'],
         'bound_ms': pconv['bound_ms'], 'bound_by': pconv['bound_by'],
         'library_ms': pconv['library_ms']})
    # The attention kernel replaces no TPU kernel either (the JAX package's
    # attention is XLA einsums); library_ms is F.scaled_dot_product_attention
    # on the same q, k, v views.  launches: phase 40's epochs.
    report['kernels'].append(
        {'name': 'spin_attention', 'route': 'cuda',
         'source': 'cgs_vmc_tpu_torch/csrc/spin_attention.cu',
         'replaces': None, 'launches': attn['launches'],
         'launches_per_epoch': attn['launches_per_epoch'],
         'plain_calls': attn['plain_calls'],
         'max_abs_err': attn['max_abs_err'], 'ms': attn['ms'],
         'plain_ms': attn['plain_ms'], 'bound_ms': attn['bound_ms'],
         'bound_by': attn['bound_by'], 'library_ms': attn['library_ms']})
    # The fused linear replaces no TPU kernel either (the JAX package's
    # linears are XLA dots); library_ms is torch.matmul alone, a yardstick.
    # The numbers of the proposal's qkv; phase 41 prints every instance.
    # launches: phase 40's epochs.
    qkv = elin['qkv']['proposal']
    report['kernels'].append(
        {'name': 'encoder_linear', 'route': 'cuda',
         'source': 'cgs_vmc_tpu_torch/csrc/encoder_linear.cu',
         'replaces': None, 'launches': attn['linear_launches'],
         'launches_per_epoch': attn['linear_launches_per_epoch'],
         'plain_calls': attn['linear_plain_calls'],
         'max_abs_err': max(r['max_abs_err'] for v in elin.values()
                            for r in v.values()),
         'ms': qkv['ms'], 'plain_ms': qkv['plain_ms'],
         'bound_ms': qkv['bound_ms'], 'bound_by': qkv['bound_by'],
         'library_ms': qkv['library_ms']})
    print(f'chip_smoke: every phase passed in '
          f'{time.perf_counter() - start_all:.1f} s, the build included',
          flush=True)
    print(smi)
    print(json.dumps(report))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
