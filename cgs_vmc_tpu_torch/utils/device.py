"""Device resolution for the port's entry points.

`Config` carries no device, so every entry point (train, evaluate_operator,
the sampler init, the CLI) takes one explicitly and resolves it here.
There is no silent fallback: asking for CUDA on a machine without it is an
error, never a CPU run.

Precision: handing out a CUDA device turns TF32 off process-wide, for
cuBLAS matmuls and for cuDNN convolutions (which PyTorch runs in TF32 by
default), so float32 work on the card is the f32 computation the JAX
reference and the artifacts' fingerprints assume.  The one scoped
exception is the SR assembly's ``sr_matmul_precision`` (optim/sr.py),
which may allow TF32 for its GEMMs and restores this setting after them.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Returns `device` as a torch.device; raises if it cannot be used."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                f'device {str(device)!r} requested but CUDA is not '
                'available; pass --device cpu to run on the CPU')
        # Full float32 products, as in the JAX reference: TF32 keeps about
        # three decimal digits, which breaks the 1e-4 agreement the port
        # is held to (theta caches, local energies, gradients).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != 'cpu':
        raise ValueError(f'unsupported device {str(device)!r} '
                         "(known: 'cpu', 'cuda[:N]')")
    return device
