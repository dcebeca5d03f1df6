"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level names are compared
whole: ``cgs_vmc_tpu_torch`` is not ``cgs_vmc_tpu``."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness import spec

FILES = sorted(spec.HERE.rglob('*.py'))
REFERENCE = sorted((spec.HERE / 'reference').rglob('*.py'))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_the_scan_compares_whole_names(tmp_path):
    probe = tmp_path / 'probe.py'
    probe.write_text('import cgs_vmc_tpu_torch.train\nfrom jax import numpy\n')
    assert top_level_imports(probe) == {'cgs_vmc_tpu_torch', 'jax'}


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(
    spec.HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {'jax', 'jaxlib', 'flax',
                                          'cgs_vmc_tpu'}


@pytest.mark.parametrize('path', REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert 'cgs_vmc_tpu_torch' not in top_level_imports(path)


def test_reference_loads_without_the_program():
    code = ('import sys; import benchmark.reference.steps; '
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("cgs_vmc_tpu_torch", "cgs_vmc_tpu", "jax")))')
    out = subprocess.run([sys.executable, '-c', code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == '[]'
