"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each library is a shared object with a plain C interface, compiled for
Hopper (``sm_90a``) into ``build/torch_kernels/`` at the checkout's root and
keyed by a hash of its sources and flags, so the first use after a change
rebuilds it and every later use loads the cached file.  Nothing is built at
import time: the build runs inside the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / 'build' / 'torch_kernels'
CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'

# No --use_fast_math: __expf/__logf would break agreement with the plain
# torch versions.  -Xptxas -v reports registers, shared memory and spills.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xptxas', '-v', '-shared',
              '-Xcompiler', '-fPIC')


def nvcc_path() -> str:
    for candidate in (os.path.join(os.environ.get('CUDA_HOME',
                                                  '/usr/local/cuda'),
                                   'bin', 'nvcc'),
                      shutil.which('nvcc')):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, '
                       '/usr/local/cuda/bin and PATH): the CUDA kernels '
                       'are built from source at first use')


def build_library(name: str, sources: Sequence[Path]) -> Path:
    """Compiles `sources` into a shared library unless a build of the same
    sources and flags exists; returns its path."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    out = BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    start = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), *map(str, sources)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed building {name}:\n{proc.stderr}')
    os.replace(tmp, out)
    for line in proc.stderr.splitlines():
        if 'registers' in line or 'spill' in line:
            print(f'ptxas {name}: {line.strip()}', flush=True)
    print(f'built {out.name} with nvcc in '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    return out


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name, sources)))
