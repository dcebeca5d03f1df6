"""Operation counts of the RBM, log ψ = s·a + c + Σ_h log cosh((sW + b)_h),
with N sites and H hidden units (``fc_layer_size``), no feature layers."""


def params(cfg: dict) -> int:
    n, h = cfg['num_sites'], cfg['fc_layer_size']
    return n * h + h + n + 1


def forward(cfg: dict) -> float:
    """One board's log ψ: the products s·W and s·a (the elementwise
    log cosh is not counted)."""
    n, h = cfg['num_sites'], cfg['fc_layer_size']
    return 2.0 * n * h + 2.0 * n


def proposal(cfg: dict) -> float:
    """One exchange proposal of the fused sweep kernel: 11 f32 operations
    a hidden unit (the two columns of W added to θ, the two log cosh
    differences, the sum), as the port's kernel table counts K2."""
    return 11.0 * cfg['fc_layer_size']


def k2_ops(cfg: dict, sweeps: int) -> float:
    """The fused kernel's operations over `sweeps` sweeps of every chain
    (a sweep is N proposals a chain)."""
    return proposal(cfg) * sweeps * cfg['num_sites'] * cfg['batch_size']
