"""The plain reference the benchmark holds the port to.

Plain PyTorch in float32, written from the published equations of each
ansatz, of the Heisenberg local energy and of the two optimizer steps.  It
imports nothing of the port or of the JAX package, and takes from the port
only what it judges: parameters and boards are read by their published key
names (the JAX layouts: a Dense kernel ``[in, out]``, a 2-D conv kernel
``[k, k, in, out]``).

Every function takes its precision from `precision`: float32 with TF32 off
(what the configurations state) or, for the control, TF32 on.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS and cuDNN TF32 set to `tf32` inside the block, restored
    after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
