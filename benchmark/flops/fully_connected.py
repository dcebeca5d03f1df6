"""Operation counts of the fully connected network: N sites, L =
num_fc_layers hidden layers of H = fc_layer_size units, then one output
(the nonlinearities are not counted)."""


def _widths(cfg: dict):
    return ([cfg['num_sites']] + [cfg['fc_layer_size']] * cfg['num_fc_layers']
            + [1])


def params(cfg: dict) -> int:
    w = _widths(cfg)
    return sum(a * b + b for a, b in zip(w, w[1:]))


def forward(cfg: dict) -> float:
    """One board's log ψ: 2·in·out a Dense layer."""
    w = _widths(cfg)
    return sum(2.0 * a * b for a, b in zip(w, w[1:]))


def proposal(cfg: dict) -> float:
    """No incremental update: a proposal is one full forward."""
    return forward(cfg)
