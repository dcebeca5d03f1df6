"""The Vision-Transformer wavefunction on the square torus (the family of
Viteritti, Rende and Becca, arXiv:2211.05504; the widths of Rende et al.,
arXiv:2310.05715).  The JAX package has no such ansatz.

The L_x × L_y torus (site = x·size_y + y, both sizes even) is cut into
2×2 patches: patch (p, q) holds the sites (2p + a, 2q + b), a, b ∈ {0, 1},
in the order a·2 + b, and is one token of 4 spins; tokens are in the order
p·(size_y/2) + q.  Each token is embedded (4 → d, with a bias, no position
embedding) and passes through L pre-LayerNorm blocks:

  x ← x + W · concat_μ(Σ_j α^μ_ij (V·LN₁(x) + b_V)_j^μ) + b_W,
  x ← x + W₂ · GELU_tanh(W₁·LN₂(x) + b₁) + b₂      (hidden width 2d),

where the factored attention's mixing α^μ_ij = a^μ[(p_j − p_i) mod
size_x/2, (q_j − q_i) mod size_y/2] depends only on the displacement of
the two patches (one learned table a head, no queries, keys or softmax),
so the network is translation-invariant across patches by construction.
Then z = LN_f(Σ_i x_i) and

  log ψ = Σ_k log cosh(LN_a(W_a z + b_a)_k + i·LN_b(W_b z + b_b)_k),

k = 1..d: a complex log ψ from real parameters, with sign +1, its phase
wrapped to [-π, π).  The head is computed in real arithmetic (`log_cosh`),
so that autograd never sees a complex cotangent (as
models/complex_phase.py promises): the SR rows of log|ψ| and of the phase
are each the gradient of a real output.

LayerNorm is the transformer's (biased variance, eps 1e-5 inside the
root).  The block's four linears (LN₁ + V, W + the residual, LN₂ + W₁ +
GELU, W₂ + the residual) go through `encoder_linear.linear`, so they share
its route and counters with models/attention.py: at a width the
hand-written kernel is not built for (72, for instance) each call keeps the
plain composition, counted ``encoder_linear.plain`` on a card.  The mixing
is a batched product of the [heads, n, n] table with V.

Parameters: ``embed``, ``block_i/{ln1, value, mix, out, ln2, mlp_in,
mlp_out}`` (``mix`` is [heads, size_x/2, size_y/2]), ``ln_f``, ``head_re``,
``ln_re``, ``head_im``, ``ln_im``; Dense kernels are [in, out].

Tracing (utils/profiling.py): each block's two residual branches are the
device spans ``attention`` and ``mlp``, and every forward adds its boards
to the counter ``vit.boards`` (once for each sample of a vmapped call).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from cgs_vmc_tpu_torch.models import encoder_linear, nn
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops.logamp import LogAmp
from cgs_vmc_tpu_torch.utils import profiling

PATCH = 2        # patches are PATCH × PATCH sites
MLP_RATIO = 2    # the MLP's hidden width over d


def patch_sites(size_x: int, size_y: int) -> np.ndarray:
    """[tokens, PATCH²] site indices of each patch (see the module doc)."""
    px, py = size_x // PATCH, size_y // PATCH
    return np.array([[(PATCH * p + a) * size_y + PATCH * q + b
                      for a in range(PATCH) for b in range(PATCH)]
                     for p in range(px) for q in range(py)], dtype=np.int64)


def displacements(size_x: int, size_y: int) -> np.ndarray:
    """[tokens, tokens]: the flat index, into a [size_x/2, size_y/2]
    table, of the displacement from patch i to patch j on the patch
    torus."""
    px, py = size_x // PATCH, size_y // PATCH
    p, q = np.divmod(np.arange(px * py), py)
    return (((p[None, :] - p[:, None]) % px) * py
            + (q[None, :] - q[:, None]) % py)


def log_cosh(u: torch.Tensor, v: torch.Tensor):
    """(log|cosh(u + iv)|, arg cosh(u + iv)) in real arithmetic:
    |cosh(u + iv)|² = ½(cosh 2u + cos 2v) = ¼e^{2|u|}(1 + e^{-4|u|} +
    2 cos 2v·e^{-2|u|}), and cosh(u + iv) = cosh u·cos v + i·sinh u·sin v,
    whose argument is that of cos v + i·tanh u·sin v (cosh u > 0).
    Neither overflows for any u."""
    au = torch.abs(u)
    e = torch.exp(-2.0 * au)
    modulus = (au - math.log(2.0)
               + 0.5 * torch.log1p(e * e + 2.0 * torch.cos(2.0 * v) * e))
    phase = torch.atan2(torch.tanh(u) * torch.sin(v), torch.cos(v))
    return modulus, phase


@register('vit')
class VisionTransformer(Wavefunction):
    """2×2 patch tokens, factored attention, a complex log-cosh head."""

    def __init__(self, size_x: int, size_y: int, num_layers: int = 2,
                 model_dim: int = 32, num_heads: int = 4,
                 name: str = 'vit'):
        if size_x % PATCH or size_y % PATCH:
            raise ValueError(f'the {size_x}x{size_y} torus does not cut '
                             f'into {PATCH}x{PATCH} patches')
        if model_dim % num_heads:
            raise ValueError(f'model_dim {model_dim} must be divisible by '
                             f'num_heads {num_heads}')
        self.name = name
        self.size_x = size_x
        self.size_y = size_y
        self.num_sites = size_x * size_y
        self.num_layers = num_layers
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.patches = patch_sites(size_x, size_y)
        self.offsets = displacements(size_x, size_y)
        self._tables: Dict[torch.device, tuple] = {}

    def _device_tables(self, device: torch.device):
        """(patch sites, displacements) on `device`, copied there once."""
        if device not in self._tables:
            self._tables[device] = (
                torch.as_tensor(self.patches, device=device),
                torch.as_tensor(self.offsets, device=device))
        return self._tables[device]

    def init(self, generator: torch.Generator) -> Params:
        d, n = self.model_dim, len(self.patches)
        # Residual-branch output projections shrink with depth so the
        # initial residual stream stays O(1) (1/sqrt(2L)), as in
        # models/attention.py; each mixing row sums n terms.
        resid_scale = (2.0 * self.num_layers) ** -0.5
        params: Params = {'embed': nn.linear_init(generator, PATCH ** 2, d)}
        for i in range(self.num_layers):
            mix = torch.randn((self.num_heads, self.size_x // PATCH,
                               self.size_y // PATCH), generator=generator,
                              dtype=torch.float32, device=generator.device)
            params[f'block_{i}'] = {
                'ln1': encoder_linear.layernorm_init(d, generator),
                'value': nn.linear_init(generator, d, d),
                'mix': mix / math.sqrt(n),
                'out': nn.linear_init(generator, d, d, scale=resid_scale),
                'ln2': encoder_linear.layernorm_init(d, generator),
                'mlp_in': nn.linear_init(generator, d, MLP_RATIO * d),
                'mlp_out': nn.linear_init(generator, MLP_RATIO * d, d,
                                          scale=resid_scale),
            }
        params['ln_f'] = encoder_linear.layernorm_init(d, generator)
        for part in ('re', 'im'):
            params[f'head_{part}'] = nn.linear_init(generator, d, d)
            params[f'ln_{part}'] = encoder_linear.layernorm_init(d, generator)
        return params

    def _attention(self, block: Params, h: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
        """h + out(the heads' mixing of value(LayerNorm(h)))."""
        v = encoder_linear.linear(block['value'], h, norm=block['ln1'])
        alpha = block['mix'].reshape(self.num_heads, -1)[:, offsets]
        heads = v.reshape(*v.shape[:-1], self.num_heads, -1)
        mixed = torch.einsum('hij,...jhc->...ihc', alpha, heads)
        return encoder_linear.linear(block['out'], mixed.reshape(v.shape),
                                     residual=h)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        x = configs.to(torch.float32)
        profiling.count_samples('vit.boards', x.numel() // self.num_sites)
        patches, offsets = self._device_tables(x.device)
        h = nn.linear_apply(params['embed'], x[..., patches])
        for i in range(self.num_layers):
            block = params[f'block_{i}']
            with profiling.span('attention', x.device):
                h = self._attention(block, h, offsets)
            with profiling.span('mlp', x.device):
                m = encoder_linear.linear(block['mlp_in'], h,
                                          norm=block['ln2'], gelu=True)
                h = encoder_linear.linear(block['mlp_out'], m, residual=h)
                del m
        z = encoder_linear.layernorm(params['ln_f'], torch.sum(h, dim=-2))
        u, v = (encoder_linear.layernorm(
            params[f'ln_{part}'], nn.linear_apply(params[f'head_{part}'], z))
            for part in ('re', 'im'))
        modulus, phase = log_cosh(u, v)
        # The d units are summed in double and the phase is wrapped to
        # [-π, π) before the float32 result: summed in float32, a phase of
        # ~100 rad keeps ~3e-5 rad of rounding, which every local energy
        # multiplies by its connected boards' weight.
        log_abs = modulus.double().sum(dim=-1)
        turn = torch.remainder(phase.double().sum(dim=-1) + math.pi,
                               2.0 * math.pi) - math.pi
        return LogAmp(torch.ones_like(modulus[..., 0]),
                      torch.complex(log_abs.float(), turn.float()))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'VisionTransformer':
        kwargs = dict(size_x=config.size_x, size_y=config.size_y,
                      num_layers=config.num_attention_layers,
                      model_dim=config.attention_dim,
                      num_heads=config.num_attention_heads)
        if config.num_sites != config.size_x * config.size_y:
            raise ValueError(f'num_sites {config.num_sites} is not the '
                             f'{config.size_x}x{config.size_y} torus')
        if config.output_activation != 'exp':
            raise ValueError("the ViT's head is its log ψ: output_activation"
                             f" must be 'exp', got {config.output_activation!r}")
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
