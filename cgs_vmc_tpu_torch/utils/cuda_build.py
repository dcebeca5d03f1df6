"""Builds, loads and launches the port's hand-written CUDA kernels, and
says which calls a kernel with no backward may take.

Each library is a shared object with a plain C interface, compiled from one
source of ``csrc/`` for Hopper (``sm_90a``) into ``build/torch_kernels/`` at
the checkout's root and keyed by a hash of its sources and flags, so the
first use after a change rebuilds it and every later use loads the cached
file.  Nothing is built at import time: the build runs inside the first
launch (`load`).

Every C function of a library takes device pointers, C ints and, last for a
kernel launch, the stream; it returns a ``cudaError_t``, which
``<source stem>_error_string`` names.  `Library.launch` is the one place
that marshals the arguments (a tensor as its data pointer, an int as a C
int, the current stream as a pointer), raises on an error and counts the
launch (``utils/profiling.py``); no C signature is declared by hand, so
the argument list at a function's call site is the only statement of its
C signature, and ctypes does not check it: the tests of each entry run it
through `Library.launch` (or `Library.call`) against its plain version.

`forward_only` is the rule of the kernels that have no backward (the
periodic conv, the attention core): which calls they may take.
`graph_nodes` asks libcuda for a captured graph's node count.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from cgs_vmc_tpu_torch.utils import profiling

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


class Library:
    """A loaded library of one ``csrc/`` source (`load`)."""

    def __init__(self, path: Path, prefix: str):
        self.path = path
        self._lib = ctypes.CDLL(str(path))
        self._error_string = getattr(self._lib, f'{prefix}_error_string')
        self._error_string.argtypes = [ctypes.c_int]
        self._error_string.restype = ctypes.c_char_p

    def call(self, fn: str, *args) -> int:
        """C function `fn` on `args` (a tensor passed as its data pointer,
        an int as a C int, a ctypes object as it is): its return code,
        unchecked."""
        return getattr(self._lib, fn)(*map(_c_arg, args))

    def check(self, err: int, what: str, context: str = '') -> None:
        """Raises RuntimeError, naming the CUDA error, if `err` is not 0."""
        if err:
            raise RuntimeError(f'{what} failed: CUDA error {err} '
                               f'({self._error_string(err).decode()})'
                               f'{context}')

    def raw(self, fn: str, *args) -> int:
        """Launches kernel entry `fn` on `args` and the current stream:
        its return code, unchecked and uncounted (chip_smoke.py times a
        kernel alone by it)."""
        return self.call(fn, *args, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))

    def launch(self, fn: str, *args, counter: Optional[str] = None) -> None:
        """Launches kernel entry `fn` on `args` and the current stream of
        the card of its first argument, a tensor, without synchronising;
        raises on a launch error (naming the arguments' shapes and values),
        else adds one to `counter`."""
        with torch.cuda.device(args[0].device):
            err = self.raw(fn, *args)
        if err:
            self.check(err, f'{fn} launch', ' at ' + ', '.join(
                str(tuple(a.shape)) if isinstance(a, torch.Tensor)
                else str(a) for a in args))
        if counter:
            profiling.count(counter)


def _c_arg(value):
    # A Python int goes to ctypes as it is: ctypes passes it as a C int.
    if type(value) is int:
        return value
    if isinstance(value, torch.Tensor):
        return ctypes.c_void_p(value.data_ptr())
    return value


@functools.cache
def load(name: str, source: str, defines: Tuple[str, ...] = ()) -> Library:
    """Library `name` built (at first use, `build_library`) from
    ``csrc/<source>`` with the ``-D`` flags `defines`, loaded once a
    process."""
    return Library(build_library(name, [CSRC_DIR / source], defines),
                   Path(source).stem)


def forward_only(*tensors: torch.Tensor) -> Optional[str]:
    """None when a kernel with no backward may take a call on `tensors`,
    else the first reason it may not: 'dtype' (not all float32, e.g. a bf16
    compute_dtype), 'torch.func' (inside a torch.func transform, such as
    SR's vmap(grad) rows), 'grad' (grad mode on and one of them requires
    grad) or 'device' (the first is not a CUDA tensor)."""
    if any(t.dtype != torch.float32 for t in tensors):
        return 'dtype'
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return 'torch.func'
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return 'grad'
    if tensors[0].device.type != 'cuda':
        return 'device'
    return None


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a captured graph (kept with keep_graph=True), by
    cuGraphGetNodes of libcuda."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL('libcuda.so.1').cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err:
        raise RuntimeError(f'cuGraphGetNodes failed with CUresult {err}')
    return count.value
