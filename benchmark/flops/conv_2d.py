"""Operation counts of the periodic 2-D conv stack, symmetrized over C4v
(and the spin flip): one board is |G| images of size_x × size_y, each
through num_conv_layers k × k convolutions of num_conv_filters channels."""


def _layers(cfg: dict):
    k, c = cfg['kernel_size'], cfg['num_conv_filters']
    return [(k, 1 if i == 0 else c, c) for i in range(cfg['num_conv_layers'])]


def images(cfg: dict) -> int:
    if not cfg['symmetrize']:
        return 1
    ops = 8 if cfg['size_x'] == cfg['size_y'] else 4
    return ops * (2 if cfg['symmetrize_spin_flip'] else 1)


def params(cfg: dict) -> int:
    return sum(k * k * cin * cout + cout for k, cin, cout in _layers(cfg))


def forward(cfg: dict) -> float:
    """One board's log ψ: 2·k²·C_in·C_out multiply-adds a site a layer,
    over every image of the orbit."""
    sites = cfg['size_x'] * cfg['size_y']
    return images(cfg) * sum(2.0 * k * k * cin * cout * sites
                             for k, cin, cout in _layers(cfg))


def proposal(cfg: dict) -> float:
    """No incremental update: a proposal is one full forward."""
    return forward(cfg)
