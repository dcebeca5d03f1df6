"""The Vision-Transformer wavefunction on the square torus, from its
equations (the family of arXiv:2211.05504 at the widths of
arXiv:2310.05715).

The L_x × L_y board (site x·L_y + y) is cut into 2×2 patches; patch (p, q)
is one token of the 4 spins (2p + a, 2q + b) in the order (a, b) = (0, 0),
(0, 1), (1, 0), (1, 1), and tokens run over p, then q.  A token is embedded
as x = s·E + e (4 → d).  Each of L pre-LayerNorm blocks adds

  W · concat_μ( Σ_j α^μ_ij · (LN₁(x) V + b_V)_j^μ ) + b_W,
      α^μ_ij = a^μ[(p_j − p_i) mod L_x/2, (q_j − q_i) mod L_y/2],

the factored attention of d/H-wide heads μ (no queries, keys or softmax),
and then W₂ · GELU_tanh(LN₂(x) W₁ + b₁) + b₂ (hidden 2d).  With z =
LN_f(Σ_i x_i),

  log ψ = Σ_k log cosh(LN_a(z W_a + b_a)_k + i·LN_b(z W_b + b_b)_k),

complex, from real parameters.  LayerNorm is g·(x − μ)/√(σ² + 1e-5) + b,
σ² biased.  The log cosh is taken of the complex number itself, one unit
at a time, so the phase is the sum of the units' principal arguments; only
differences of log ψ and the phase wrapped to (−π, π] are compared.

Departures from the papers: none in the network.  The papers report final
energies after projecting the trained state onto the lattice's symmetries;
that projection is not a training step, and neither the program nor this
reference applies it.  Departure from float32: the d units' log cosh are
summed in double and the phase is wrapped to [−π, π) before the complex64
result, as the program does; a phase of ~100 rad summed in float32 keeps
~3e-5 rad of rounding, which every local energy multiplies.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

COMPLEX_LOG = True


def _ln(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f'{key}.g'], p[f'{key}.b'],
                        eps=1e-5)


def _dense(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f'{key}.w'] + p[f'{key}.b']


def _tokens(s: torch.Tensor, lx: int, ly: int) -> torch.Tensor:
    """[batch, (lx/2)(ly/2), 4]: the boards' 2×2 patches."""
    x = s.reshape(-1, lx // 2, 2, ly // 2, 2)          # b, p, a, q, c
    return x.permute(0, 1, 3, 2, 4).reshape(-1, lx * ly // 4, 4)


def _mixing(table: torch.Tensor) -> torch.Tensor:
    """[heads, n, n] α from the [heads, lx/2, ly/2] table: α[μ, i, j] the
    table at patch j's position less patch i's, on the patch torus."""
    heads, px, py = table.shape
    p = torch.arange(px).repeat_interleave(py)
    q = torch.arange(py).repeat(px)
    dp = (p[None, :] - p[:, None]) % px
    dq = (q[None, :] - q[:, None]) % py
    return table[:, dp.to(table.device), dq.to(table.device)]


def build(cfg: dict) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    lx, ly = cfg['size_x'], cfg['size_y']
    d, heads = cfg['attention_dim'], cfg['num_attention_heads']
    layers = cfg['num_attention_layers']
    if cfg['symmetrize']:
        raise ValueError('the reference ViT is not symmetrized')

    def log_psi(p: Params, s: torch.Tensor) -> torch.Tensor:
        x = _dense(p, 'embed', _tokens(s, lx, ly))
        batch, n, _ = x.shape
        for i in range(layers):
            blk = f'block_{i}'
            v = _dense(p, f'{blk}.value', _ln(p, f'{blk}.ln1', x))
            v = v.reshape(batch, n, heads, d // heads)
            att = torch.einsum('mij,bjmc->bimc', _mixing(p[f'{blk}.mix']), v)
            x = x + _dense(p, f'{blk}.out', att.reshape(batch, n, d))
            hidden = _dense(p, f'{blk}.mlp_in', _ln(p, f'{blk}.ln2', x))
            x = x + _dense(p, f'{blk}.mlp_out',
                           F.gelu(hidden, approximate='tanh'))
        z = _ln(p, 'ln_f', x.sum(dim=1))
        u = _ln(p, 'ln_re', _dense(p, 'head_re', z))
        w = _ln(p, 'ln_im', _dense(p, 'head_im', z))
        units = torch.log(torch.cosh(torch.complex(u, w)))
        total = units.to(torch.complex128).sum(dim=-1)
        phase = torch.remainder(total.imag + math.pi, 2 * math.pi) - math.pi
        return torch.complex(total.real, phase).to(torch.complex64)
    return log_psi
