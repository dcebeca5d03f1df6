"""K2's share of its roofline in the traced training epochs (_k2.py)."""

from pathlib import Path

from benchmark.harness import spec

_k2 = spec.load_module(Path(__file__).with_name('_k2.py'))


def read(run):
    return _k2.share(run, 'train')
