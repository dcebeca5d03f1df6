"""The self-attention wavefunction on the square lattice, from its
equations: each site a token, s_i·e + p_i (a spin embedding e and a learned
position embedding p_i); L pre-LayerNorm encoder blocks

  h ← h + W_o · MHA(LN_1(h)),   MHA = softmax(Q Kᵀ / √d_h) V per head,
  h ← h + W_2 · GELU_tanh(W_1 · LN_2(h)),

with [Q K V] = W_qkv · x split as [n, 3, heads, d_h]; then a final
LayerNorm, the mean over the tokens and a linear head whose output is
log ψ of one image ('exp' output).  LayerNorm is g·(x − μ)/√(σ² + 1e-5)
+ b with the biased variance.  ψ is the mean of the amplitudes over the
orbit of the board under C4v (the rotations and reflections of the square
torus) and the global spin flip: log ψ = logsumexp over the 16 images −
log 16.

The final LayerNorm's bias b_f and the head's bias c add the same b_f·w +
c to every image's log amplitude, so they are added after the orbit's
logsumexp (an identity): their derivatives are then exact for every board
(w and 1), where inside the logsumexp the rounding of the orbit's weights
makes their centered Jacobian columns noise, which minSR's near-singular
solve amplifies into steps that no sum of the program has.

Departures from the published family of transformer wavefunctions for
2-D spin models (e.g. the ViT ansatz, arXiv:2211.05504): the tokens are
single sites, not patches; the attention is plain softmax attention, not
factored; the amplitude is real and positive; the point-group projection
is applied to the output.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _c4v(x: torch.Tensor) -> torch.Tensor:
    """[batch, 8, L, L]: x under the four rotations and four reflections
    of the square."""
    t = x.transpose(1, 2)
    images = [torch.rot90(x, r, dims=(1, 2)) for r in range(4)]
    images += [torch.rot90(t, r, dims=(1, 2)) for r in range(4)]
    return torch.stack(images, dim=1)


def _layernorm(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    """g·(x − μ)/√(σ² + 1e-5) + b over the last axis, σ² biased."""
    return F.layer_norm(x, x.shape[-1:], p[f'{key}.g'], p[f'{key}.b'],
                        eps=1e-5)


def _dense(p: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f'{key}.w'] + p[f'{key}.b']


def build(cfg: dict) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    lx, ly = cfg['size_x'], cfg['size_y']
    d, heads = cfg['attention_dim'], cfg['num_attention_heads']
    layers = cfg['num_attention_layers']
    if cfg['output_activation'] != 'exp':
        raise ValueError("the reference transformer has the 'exp' output "
                         'only')
    if cfg['symmetrize'] and lx != ly:
        raise ValueError('the reference symmetrizes square tori only')
    dh = d // heads

    def image_log(p: Params, s: torch.Tensor) -> torch.Tensor:
        """[images] log ψ of each image [images, n], less b_f·w + c."""
        batch, n = s.shape
        h = s[..., None] * p['spin_embed'] + p['pos_embed']
        for i in range(layers):
            blk = f'block_{i}'
            qkv = _dense(p, f'{blk}.qkv', _layernorm(p, f'{blk}.ln1', h))
            q, k, v = qkv.reshape(batch, n, 3, heads, dh).unbind(dim=2)
            logits = torch.einsum('bqhd,bkhd->bhqk', q, k) / math.sqrt(dh)
            att = torch.einsum('bhqk,bkhd->bqhd', logits.softmax(dim=-1), v)
            h = h + _dense(p, f'{blk}.attn_out', att.reshape(batch, n, d))
            m = _dense(p, f'{blk}.mlp_in', _layernorm(p, f'{blk}.ln2', h))
            h = h + _dense(p, f'{blk}.mlp_out', F.gelu(m, approximate='tanh'))
        normed = F.layer_norm(h, (d,), p['ln_f.g'], None, eps=1e-5)
        return normed.mean(dim=1) @ p['head.w'][:, 0]

    def log_psi(p: Params, s: torch.Tensor) -> torch.Tensor:
        x = s.reshape(-1, lx, ly)
        orbit = _c4v(x) if cfg['symmetrize'] else x[:, None]
        if cfg['symmetrize'] and cfg['symmetrize_spin_flip']:
            orbit = torch.cat([orbit, -orbit], dim=1)
        n_ops = orbit.shape[1]
        logs = image_log(p, orbit.reshape(-1, lx * ly)).reshape(-1, n_ops)
        biases = p['ln_f.b'] @ p['head.w'][:, 0] + p['head.b'][0]
        return biases + torch.logsumexp(logs, dim=1) - math.log(n_ops)
    return log_psi
