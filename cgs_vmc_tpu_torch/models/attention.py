"""Self-attention (transformer) wavefunction ansatz (port of
cgs_vmc_tpu/models/attention.py).

Each lattice site is a token — spin value times a learned embedding vector
plus a learned positional embedding — processed by pre-LayerNorm
transformer blocks (multi-head self-attention + GELU MLP), mean-pooled and
projected to a scalar that is logψ directly.  It is a plain Metropolis
ansatz: nothing in it is autoregressive, and it composes with the symmetry
projection and the composite wrappers like every other ansatz.

Parameters keep the JAX key names (``spin_embed``, ``pos_embed``, ``ln_f``,
``block_i/{ln1, qkv, attn_out, ln2, mlp_in, mlp_out}``, ``head``) and
layouts, so the committed ``.msgpack`` artifact loads leaf for leaf.  The
GELU is the tanh approximation (the JAX default) and the LayerNorm uses the
biased variance with eps inside the root.

The block's four linear layers, with the LayerNorm before qkv and mlp_in,
the bias, the GELU after mlp_in and the two residual adds, live in
models/encoder_linear.py: a call that needs no gradient, on a float32
CUDA tensor at width 64, runs the hand-written kernel
``csrc/encoder_linear.cu`` (one launch a linear, with the normalised rows
and the pre-activations never in device memory); every other call keeps
the plain composition (`encoder_linear.route` has the rule).  The final
LayerNorm, the mean pool, the head and the embedding stay plain.

The attention core between the qkv and attn_out projections,
``softmax(QKᵀ/√d_h)V`` per head, lives in models/spin_attention.py: a call
that needs no gradient, on a float32 CUDA tensor of at most 64 tokens and a
head width of 4, 8 or 16, runs the hand-written kernel
``csrc/spin_attention.cu`` (one launch, no logits tensor and no permute
copy); every other call (SR's ``torch.func.vmap(grad)`` rows, the CPU,
another dtype) runs its plain einsums (`spin_attention.route` has the
rule).  The JAX package leaves the same einsums to XLA.

Tracing (utils/profiling.py): each block's two residual branches are the
device spans ``attention`` and ``mlp``, and every forward adds the images
it takes to the counter ``encoder.images`` (once for each sample of a
vmapped call: the SR rows' forward counts its M boards' images).  The
counters ``attention.launches`` and ``attention.plain`` count a layer's
kernel launches and its CUDA calls that kept the plain einsums;
``encoder_linear.launches`` and ``encoder_linear.plain`` do the same for
the block's linears.
"""

from __future__ import annotations

import torch

from cgs_vmc_tpu_torch.models import encoder_linear, nn, spin_attention
from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops import logamp
from cgs_vmc_tpu_torch.ops.logamp import LogAmp
from cgs_vmc_tpu_torch.utils import profiling


@register('transformer')
class SpinTransformer(Wavefunction):
    """Pre-LN transformer encoder over site tokens; mean-pool -> logψ."""

    def __init__(self, num_sites: int, num_layers: int = 2,
                 model_dim: int = 32, num_heads: int = 4,
                 output_activation: str = 'exp',
                 name: str = 'spin_transformer'):
        if model_dim % num_heads:
            raise ValueError(f'model_dim {model_dim} must be divisible by '
                             f'num_heads {num_heads}')
        self.name = name
        self.num_sites = num_sites
        self.num_layers = num_layers
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.output_activation = output_activation

    def init(self, generator: torch.Generator) -> Params:
        d = self.model_dim

        def normal(shape, std):
            return std * torch.randn(shape, generator=generator,
                                     dtype=torch.float32,
                                     device=generator.device)

        params: Params = {
            'spin_embed': normal((d,), 0.5),
            'pos_embed': normal((self.num_sites, d), 0.02),
            'ln_f': encoder_linear.layernorm_init(d, generator),
        }
        # Residual-branch output projections shrink with depth so the
        # initial residual stream stays O(1) (1/sqrt(2L)).
        resid_scale = (2.0 * self.num_layers) ** -0.5
        for i in range(self.num_layers):
            params[f'block_{i}'] = {
                'ln1': encoder_linear.layernorm_init(d, generator),
                'qkv': nn.linear_init(generator, d, 3 * d),
                'attn_out': nn.linear_init(generator, d, d,
                                           scale=resid_scale),
                'ln2': encoder_linear.layernorm_init(d, generator),
                'mlp_in': nn.linear_init(generator, d, 4 * d),
                'mlp_out': nn.linear_init(generator, 4 * d, d,
                                          scale=resid_scale),
            }
        # Small head init keeps initial logψ nearly flat (see nn.linear_init).
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        params['head'] = nn.linear_init(generator, d, 1, scale=head_scale)
        return params

    def _attention(self, block: Params, h: torch.Tensor) -> torch.Tensor:
        """The attention sub-block with its residual: h + attn_out(the
        attention core of qkv(LayerNorm(h)))."""
        qkv = encoder_linear.linear(block['qkv'], h, norm=block['ln1'])
        return encoder_linear.linear(
            block['attn_out'], spin_attention.attention(qkv, self.num_heads),
            residual=h)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        x = configs.to(torch.float32)
        profiling.count_samples('encoder.images',
                                x.numel() // self.num_sites)
        h = x[..., None] * params['spin_embed'] + params['pos_embed']
        for i in range(self.num_layers):
            block = params[f'block_{i}']
            with profiling.span('attention', x.device):
                h = self._attention(block, h)
            with profiling.span('mlp', x.device):
                # The [B, n, 4d] hidden does not outlive this branch.
                m = encoder_linear.linear(block['mlp_in'], h,
                                          norm=block['ln2'], gelu=True)
                h = encoder_linear.linear(block['mlp_out'], m, residual=h)
                del m
        pooled = torch.mean(encoder_linear.layernorm(params['ln_f'], h),
                            dim=-2)
        pre = nn.linear_apply(params['head'], pooled).squeeze(-1)
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'SpinTransformer':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_attention_layers,
            model_dim=config.attention_dim,
            num_heads=config.num_attention_heads,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
