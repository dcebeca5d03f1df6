"""Operation counts of the Vision-Transformer wavefunction: one board is n
= (size_x/2)(size_y/2) tokens of 2×2 spins through L blocks of width d.  A
block takes 2·n·d² in the value projection, 2·n²·d in the factored
attention's mixing (Σ_j α^μ_ij v_j, every head), 2·n·d² in its output
projection and 2·2·n·d·2d in the MLP of hidden width 2d: 12·n·d² + 2·n²·d.
The embedding, the LayerNorms, the GELU, the pool and the log-cosh head
are not counted.  Its log ψ is complex, so SR stacks two rows a board
(sr.py)."""

COMPLEX_LOG = True


def _tokens(cfg: dict) -> int:
    return (cfg['size_x'] // 2) * (cfg['size_y'] // 2)


def params(cfg: dict) -> int:
    """The embedding (4d + d); each block's two LayerNorms (4d), value and
    output projections (2(d² + d)), mixing tables (heads × n) and MLP
    (2d² + 2d + 2d² + d); LN_f (2d); the head's two Dense layers and two
    LayerNorms (2(d² + d) + 4d)."""
    d, n = cfg['attention_dim'], _tokens(cfg)
    block = (4 * d + 2 * (d * d + d) + cfg['num_attention_heads'] * n
             + 4 * d * d + 3 * d)
    head = 2 * d + 2 * (d * d + d) + 4 * d
    return 5 * d + cfg['num_attention_layers'] * block + head


def image(cfg: dict) -> float:
    """One board's blocks: L × (12·n·d² + 2·n²·d)."""
    d, n = cfg['attention_dim'], _tokens(cfg)
    return cfg['num_attention_layers'] * (12.0 * n * d * d + 2.0 * n * n * d)


def forward(cfg: dict) -> float:
    """One board's log ψ (no symmetry projection: one image)."""
    return image(cfg)


def proposal(cfg: dict) -> float:
    """No incremental update: a proposal is one full forward."""
    return forward(cfg)
