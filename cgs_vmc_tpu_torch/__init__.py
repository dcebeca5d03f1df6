"""cgs-vmc-tpu, PyTorch/CUDA port.

A second package beside ``cgs_vmc_tpu`` (the JAX reference).  Module paths
mirror the JAX package: ``cgs_vmc_tpu/sampler/kernels.py`` has its
counterpart at ``cgs_vmc_tpu_torch/sampler/kernels.py``.  The port imports
``torch`` and never ``jax``, and it imports nothing of ``cgs_vmc_tpu``: it
runs with the JAX package absent.  What it needs of the JAX package's
jax-free modules it carries as its own copies (``config``, ``lattice``,
``utils/metrics``, the CLI's flag helpers), so the same ``configs/*.json``
drive both packages; the tests hold the copies to the originals.

Covered so far (ROADMAP.md): every ansatz of ``models/`` (the RBM and
fully connected nets, the conv and residual stacks with the symmetry
projection, Jastrow, MPS, the determinant and graph ansatzes, the
transformer, the Vision Transformer (port only), the autoregressive MADE
and PixelCNN, and the sum / diff /
prod / complex composites), every sampler of ``sampler/`` (generic
Metropolis, the incremental and exact-draw fast paths, multiple-try
Metropolis, parallel tempering), the Heisenberg (twisted boundaries
included) and transverse-field Ising Hamiltonians, and the EnergyGradient,
SR and SWO optimizers — ``python -m cgs_vmc_tpu_torch.cli
train|distill|eval|dump --device cuda`` — with the two fused RBM sweep
kernels written in CUDA for Hopper (``csrc/rbm_sweep.cu``); the
measurement and dynamics layer; and the run plumbing: chain-sharded
multi-GPU runs over ``torch.distributed`` (``parallel/``, launched by
``torchrun``), EMA weights, ``profile_dir``, ``epochs_per_call``, a
params-only ``.msgpack`` writer and the JAX package's run directories.
Every entry point takes an explicit device.
"""

__version__ = '0.1.0'
