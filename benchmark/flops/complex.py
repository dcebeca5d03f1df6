"""Operation counts of the complex composite, ψ = exp(log|ψ| + i·φ): the
modulus and the phase networks (composite_wavefunction_types, each
counted by its family's file here) on every board.  Its log ψ is
complex, so SR stacks two rows a board (sr.py)."""

from pathlib import Path

from benchmark.harness import spec

COMPLEX_LOG = True


def _parts(cfg: dict):
    return [(spec.load_module(Path(__file__).with_name(f'{family}.py')),
             {**cfg, 'wavefunction_type': family})
            for family in cfg['composite_wavefunction_types']]


def params(cfg: dict) -> int:
    return sum(model.params(part) for model, part in _parts(cfg))


def forward(cfg: dict) -> float:
    return sum(model.forward(part) for model, part in _parts(cfg))


def proposal(cfg: dict) -> float:
    """No incremental update: a proposal is one full forward of both."""
    return forward(cfg)
