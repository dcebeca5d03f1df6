"""Operation counts of the self-attention wavefunction (the pre-LN encoder
over site tokens), symmetrized over C4v and the spin flip: one board is
|G| images of N tokens, each through L blocks of width d with 4d in the
MLP.  A token-layer takes 2·12d² operations in its four GEMMs (the qkv
projection 3d², the attention's output d², the MLP 8d²) and 4·N·d in the
attention's two products (QKᵀ and the weighted sum of V); the
LayerNorms, the softmax, the GELU, the embedding, the pool and the head
are not counted."""


def images(cfg: dict) -> int:
    if not cfg['symmetrize']:
        return 1
    ops = 8 if cfg['size_x'] == cfg['size_y'] else 4
    return ops * (2 if cfg['symmetrize_spin_flip'] else 1)


def params(cfg: dict) -> int:
    """The embeddings (d + N·d), each block's two LayerNorms (4d), qkv
    (3d² + 3d), output (d² + d), MLP (8d² + 5d), the final LayerNorm (2d)
    and the head (d + 1)."""
    n, d = cfg['num_sites'], cfg['attention_dim']
    block = 4 * d + 3 * d * d + 3 * d + d * d + d + 8 * d * d + 5 * d
    return d + n * d + cfg['num_attention_layers'] * block + 2 * d + d + 1


def image(cfg: dict) -> float:
    """One image's encoder: N tokens × L layers × (24d² + 4Nd)."""
    n, d = cfg['num_sites'], cfg['attention_dim']
    return (n * cfg['num_attention_layers']
            * (24.0 * d * d + 4.0 * n * d))


def forward(cfg: dict) -> float:
    """One board's log ψ: every image of the orbit through the encoder."""
    return images(cfg) * image(cfg)


def proposal(cfg: dict) -> float:
    """No incremental update: a proposal is one full forward."""
    return forward(cfg)
