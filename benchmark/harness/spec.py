"""Finds everything a cell needs by the names in BENCHMARK.json.

  benchmark/configs/<config>.json      the configuration as it is run
  benchmark/traffic/<traffic>.json     the traffic mix; names its driver
  benchmark/drivers/<driver>.py        runs the window and the check
  benchmark/limits/<workload>.json     the limit of each number compared
  benchmark/metrics/<metric>.py        one reader a metric: read(run)
  benchmark/flops/<name>.py            operation counts

A later cell, mix or metric is new files and new entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parents[1]       # benchmark/
ROOT = HERE.parent                                # the checkout


def load_module(path: Path) -> ModuleType:
    """Imports a file by path (names may hold dots: ``mfu.train.py``)."""
    name = 'benchmark_file_' + '_'.join(
        path.parts[-2:]).replace('.', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    root: Path                        # the checkout holding the files
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config_file: Dict[str, Any]       # the whole file: source, config, ...
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[dict]            # the metrics this cell reports
    per_layer: List[dict]

    @property
    def config(self) -> Dict[str, Any]:
        """The configuration's fields, as in the repo's config files."""
        return self.config_file['config']


def _reports(metric: dict, cell: str) -> bool:
    return 'workloads' not in metric or cell in metric['workloads']


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / 'BENCHMARK.json'
    if not path.exists():
        raise FileNotFoundError(f'{path} is missing')
    return json.loads(path.read_text())


def cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    """The workload `name` with its files resolved under `root`."""
    work = {w['name']: w for w in bench['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r}; known: {sorted(work)}')
    w = work[name]
    configs = {c['name']: c for c in bench['configs']}
    entry = configs[w['config']]
    here = root / 'benchmark'
    return Cell(
        root=root, name=name, chips=w['chips'], config_name=w['config'],
        traffic_name=w['traffic'],
        config_file=json.loads((root / entry['file']).read_text()),
        traffic=json.loads(
            (here / 'traffic' / f"{w['traffic']}.json").read_text()),
        limits=json.loads((here / 'limits' / f'{name}.json').read_text()),
        end_to_end=[m for m in bench['end_to_end'] if _reports(m, name)],
        per_layer=[m for m in bench['per_layer'] if _reports(m, name)])


def driver(c: Cell) -> ModuleType:
    return load_module(c.root / 'benchmark' / 'drivers'
                       / f"{c.traffic['driver']}.py")


def metric_reader(c: Cell, name: str) -> ModuleType:
    return load_module(c.root / 'benchmark' / 'metrics' / f'{name}.py')


def flops(c: Cell, name: str) -> ModuleType:
    return load_module(c.root / 'benchmark' / 'flops' / f'{name}.py')
