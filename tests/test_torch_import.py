"""Import hygiene: every module of the port imports with jax, flax, optax
and the JAX package itself (cgs_vmc_tpu) unavailable: the machine with the
card has none of them, and the port carries its own copies of what it
needs."""

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / 'cgs_vmc_tpu_torch'
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'cgs_vmc_tpu')


def _port_modules():
    return sorted(
        '.'.join(path.relative_to(REPO).with_suffix('').parts)
        .removesuffix('.__init__')
        for path in PACKAGE.rglob('*.py'))


def test_port_modules_import_without_jax():
    modules = _port_modules()
    for name in ('cgs_vmc_tpu_torch.sampler.kernels',
                 'cgs_vmc_tpu_torch.config', 'cgs_vmc_tpu_torch.lattice',
                 'cgs_vmc_tpu_torch.utils.metrics',
                 'cgs_vmc_tpu_torch.optim.swo',
                 'cgs_vmc_tpu_torch.models.full_vector',
                 'cgs_vmc_tpu_torch.utils.ed',
                 'cgs_vmc_tpu_torch.models.complex_phase',
                 'cgs_vmc_tpu_torch.models.jastrow',
                 'cgs_vmc_tpu_torch.models.mps',
                 'cgs_vmc_tpu_torch.models.determinant',
                 'cgs_vmc_tpu_torch.models.graph_conv',
                 'cgs_vmc_tpu_torch.sampler.fast_jastrow',
                 'cgs_vmc_tpu_torch.sampler.fast_pbdg',
                 'cgs_vmc_tpu_torch.sampler.fast_mps',
                 'cgs_vmc_tpu_torch.models.attention',
                 'cgs_vmc_tpu_torch.models.autoregressive',
                 'cgs_vmc_tpu_torch.models.pixelcnn',
                 'cgs_vmc_tpu_torch.sampler.fast_ar',
                 'cgs_vmc_tpu_torch.sampler.mtm',
                 'cgs_vmc_tpu_torch.sampler.tempering',
                 'cgs_vmc_tpu_torch.ops.ising',
                 'cgs_vmc_tpu_torch.ops.observables',
                 'cgs_vmc_tpu_torch.ops.renyi',
                 'cgs_vmc_tpu_torch.ops.lanczos',
                 'cgs_vmc_tpu_torch.ops.dynamics',
                 'cgs_vmc_tpu_torch.optim.tvmc',
                 'cgs_vmc_tpu_torch.optim.excited',
                 'cgs_vmc_tpu_torch.parallel.mesh',
                 'cgs_vmc_tpu_torch.parallel.dryrun',
                 'cgs_vmc_tpu_torch.utils.profiling',
                 'cgs_vmc_tpu_torch.entry',
                 'cgs_vmc_tpu_torch.bench',
                 'cgs_vmc_tpu_torch.optim.fast_jacobian',
                 'cgs_vmc_tpu_torch.utils.cuda_graph',
                 'cgs_vmc_tpu_torch.utils.tree'):
        assert name in modules
    script = '\n'.join(
        ["import sys",
         f"for name in {BANNED!r}:",
         "    sys.modules[name] = None"]
        + [f'import {m}' for m in modules]
        + [f"banned = [m for m in sys.modules if m.split('.')[0] in "
           f"{BANNED!r} and sys.modules[m] is not None]",
           "assert not banned, banned",
           "print('ok', len(sys.modules))"])
    proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('ok')


@pytest.mark.parametrize('path', ['chip_smoke.py'] + [
    str(p.relative_to(REPO)) for p in sorted(PACKAGE.rglob('*.py'))])
def test_port_sources_name_no_jax(path):
    """No jax/flax/optax or cgs_vmc_tpu import statement anywhere in the
    port's sources or in chip_smoke.py."""
    for line in (REPO / path).read_text().splitlines():
        words = line.split()
        if words[:1] in (['import'], ['from']) and len(words) > 1:
            assert words[1].split('.')[0] not in BANNED, \
                f'{path}: {line.strip()}'
