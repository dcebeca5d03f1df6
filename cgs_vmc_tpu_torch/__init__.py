"""cgs-vmc-tpu, PyTorch/CUDA port.

A second package beside ``cgs_vmc_tpu`` (the JAX reference).  Module paths
mirror the JAX package: ``cgs_vmc_tpu/sampler/kernels.py`` has its
counterpart at ``cgs_vmc_tpu_torch/sampler/kernels.py``.  The port imports
``torch`` and never ``jax``; it reuses, by import, the JAX package's three
jax-free modules (``cgs_vmc_tpu.config``, ``cgs_vmc_tpu.lattice`` and
``cgs_vmc_tpu.utils.metrics``), so the same ``configs/*.json`` drive both.

Covered so far (ROADMAP.md, slice 1): the pure-RBM Heisenberg main path —
``python -m cgs_vmc_tpu_torch.cli train|eval --device cuda`` — with the two
fused Metropolis sweep kernels written in CUDA for Hopper
(``csrc/rbm_sweep.cu``).  Every entry point takes an explicit device.
"""

__version__ = '0.1.0'
