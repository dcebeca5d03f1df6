"""Builds the port's CUDA sources with nvcc (callers load them with ctypes).

Each library is a shared object with a plain C interface, compiled for
Hopper (``sm_90a``) into ``build/torch_kernels/`` at the checkout's root and
keyed by a hash of its sources and flags, so the first use after a change
rebuilds it and every later use loads the cached file.  Nothing is built at
import time: the build runs inside the first launch.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
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


def parse_ptxas(log: str) -> dict:
    """{kernel symbol: {'registers', 'spill_stores', 'spill_loads'}} from
    the report of ``nvcc -Xptxas -v``."""
    report, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = report.setdefault(entry.group(1), {})
            continue
        if current is None:
            continue
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
        if spill:
            current['spill_stores'] = int(spill.group(1))
            current['spill_loads'] = int(spill.group(2))
        used = re.search(r'Used (\d+) registers', line)
        if used:
            current['registers'] = int(used.group(1))
    return report


def ptxas_report(library: Path) -> dict:
    """The parsed ptxas report written beside a library built here."""
    return json.loads(library.with_suffix('.ptxas.json').read_text())


def build_library(name: str, sources: Sequence[Path],
                  defines: Sequence[str] = ()) -> Path:
    """Compiles `sources` into a shared library unless a build of the same
    sources and flags exists; returns its path.  `defines` are extra
    ``-D`` flags (``NAME=value``), for a library built once for each shape
    it serves.  ptxas's report of every kernel's registers and spills is
    kept beside it (`ptxas_report`) and summarised on stdout."""
    flags = (*NVCC_FLAGS, *(f'-D{d}' for d in defines))
    digest = hashlib.sha256(' '.join(flags).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    out = BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'
    if out.exists() and out.with_suffix('.ptxas.json').exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    start = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *flags, '-o', str(tmp), *map(str, sources)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed building {name}:\n{proc.stderr}')
    report = parse_ptxas(proc.stderr)
    out.with_suffix('.ptxas.json').write_text(json.dumps(report, indent=1))
    os.replace(tmp, out)
    registers = [k.get('registers', 0) for k in report.values()]
    spilling = sum(1 for k in report.values()
                   if k.get('spill_stores', 0) or k.get('spill_loads', 0))
    print(f'built {out.name} with nvcc in '
          f'{time.perf_counter() - start:.2f} s: {len(report)} kernels, '
          f'{min(registers, default=0)}-{max(registers, default=0)} '
          f'registers a thread, {spilling} spilling', flush=True)
    return out
