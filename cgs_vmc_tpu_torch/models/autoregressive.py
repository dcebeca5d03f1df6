"""Autoregressive spin ansatz (MADE) with exact sector-projected sampling
(port of cgs_vmc_tpu/models/autoregressive.py).

The wavefunction parameterizes a normalized distribution

    |psi(s)|^2 = prod_i p(s_i | s_<i),      log|psi| = 1/2 sum_i log p_i,

so configurations are drawn i.i.d. by ancestral sampling: no Markov chain,
no equilibration, no autocorrelation.  The conditionals come from one
MADE-masked MLP forward: logit_i depends only on s_<i, which makes
evaluation a single parallel forward pass while sampling takes one step a
site.

The Sz=0 sector is enforced exactly inside the conditionals: with u ups
placed before site i and r sites remaining, s_i=+1 is forced when
n/2 - u == r and blocked when u == n/2, and each conditional still sums to
one, so the distribution is exactly normalized on the sector.  The sign is
+1 everywhere.  The sampler registry's 'exact_autoregressive' entry
(sampler/fast_ar.py) replaces Metropolis sweeps with fresh exact draws.

Ancestral sampling is a function of injected uniforms
(`sample_from_uniforms`): site i becomes +1 where ``uniforms[:, i] <
p(up)``.  `sample` draws those uniforms from a generator.  All chains step
together, in a Python loop over sites.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from cgs_vmc_tpu_torch.models.base import Params, Wavefunction, register
from cgs_vmc_tpu_torch.ops import logamp
from cgs_vmc_tpu_torch.ops.logamp import LogAmp


def _made_masks(n: int, hidden: int, num_hidden_layers: int
                ) -> List[np.ndarray]:
    """MADE masks for n inputs -> [hidden]*L -> n outputs.

    Input degrees d_j = j; hidden degrees cycle over 0..n-2; output i
    connects to hidden units of degree < i (strict), so logit_i sees
    inputs j <= m_k < i only.  Site 0's logit is a pure bias.
    """
    d_in = np.arange(n)
    m_hidden = np.arange(hidden) % max(n - 1, 1)
    masks = [(d_in[:, None] <= m_hidden[None, :]).astype(np.float32)]
    for _ in range(num_hidden_layers - 1):
        masks.append(
            (m_hidden[:, None] <= m_hidden[None, :]).astype(np.float32))
    masks.append((m_hidden[:, None] < d_in[None, :]).astype(np.float32))
    return masks


@register('made')
class AutoregressiveSpinModel(Wavefunction):
    """MADE over ±1 spins; |psi|^2 is an exactly normalized Sz=0 law."""

    def __init__(self, num_sites: int, hidden: int = 64,
                 num_hidden_layers: int = 1, nonlinearity: str = 'relu',
                 name: str = 'made'):
        if num_sites % 2:
            raise ValueError('Sz=0 sector requires even num_sites')
        self.name = name
        self.num_sites = num_sites
        self.hidden = hidden
        self.num_hidden_layers = max(1, num_hidden_layers)
        self.nonlinearity = nonlinearity
        self.masks = _made_masks(num_sites, hidden, self.num_hidden_layers)
        self._device_masks: Dict[torch.device, list] = {}

    def _masks_on(self, device: torch.device) -> List[torch.Tensor]:
        """The masks as constants on `device`, copied there once."""
        if device not in self._device_masks:
            self._device_masks[device] = [
                torch.as_tensor(m, device=device) for m in self.masks]
        return self._device_masks[device]

    def init(self, generator: torch.Generator) -> Params:
        device = generator.device
        params = {}
        for i, mask in enumerate(self.masks):
            fan_in = max(float(mask.sum(0).mean()), 1.0)
            w = torch.randn(mask.shape, generator=generator,
                            dtype=torch.float32, device=device)
            params[f'dense_{i}'] = {
                'w': w / np.sqrt(fan_in),
                'b': torch.zeros(mask.shape[1], dtype=torch.float32,
                                 device=device),
            }
        return params

    def _logits(self, params: Params, configs: torch.Tensor) -> torch.Tensor:
        """[batch, n] logits; logit_i depends only on configs[:, :i]."""
        act = logamp.ACTIVATIONS[self.nonlinearity]
        masks = self._masks_on(configs.device)
        h = configs.to(torch.float32)
        last = len(masks) - 1
        for i, mask in enumerate(masks):
            layer = params[f'dense_{i}']
            h = h @ (layer['w'] * mask) + layer['b']
            if i != last:
                h = act(h)
        return h

    def _conditional_log_p(self, params: Params, configs: torch.Tensor
                           ) -> torch.Tensor:
        """log p(s_i | s_<i) at the realized s_i, [batch, n], with the
        exact Sz=0 sector projection folded into each conditional."""
        return self.conditional_log_p_from_logits(
            self._logits(params, configs), configs)

    @staticmethod
    def conditional_log_p_from_logits(logits: torch.Tensor,
                                      configs: torch.Tensor) -> torch.Tensor:
        """Sector-projected conditional log-probs given precomputed
        logits.  The ``where``s keep every -inf in a branch that is a
        constant, so no gradient ever passes through one."""
        n = configs.shape[-1]
        up = (configs > 0).to(torch.float32)
        # ups placed strictly before site i.
        u_before = torch.cumsum(up, dim=-1) - up
        remaining = torch.arange(n, 0, -1, dtype=torch.float32,
                                 device=configs.device)       # incl. i
        ups_left = 0.5 * n - u_before
        forced_up = ups_left >= remaining          # all rest must be up
        blocked_up = ups_left <= 0.0               # up quota exhausted
        # Unconstrained Bernoulli log-probs (stable log-sigmoid).
        log_p_up = F.logsigmoid(logits)
        log_p_down = F.logsigmoid(-logits)
        zero = torch.zeros_like(log_p_up)
        neg_inf = torch.full_like(log_p_up, -torch.inf)
        log_p_up = torch.where(forced_up, zero,
                               torch.where(blocked_up, neg_inf, log_p_up))
        log_p_down = torch.where(forced_up, neg_inf,
                                 torch.where(blocked_up, zero, log_p_down))
        return torch.where(up > 0, log_p_up, log_p_down)

    def apply(self, params: Params, configs: torch.Tensor) -> LogAmp:
        log_prob = torch.sum(self._conditional_log_p(params, configs),
                             dim=-1)
        log_psi = 0.5 * log_prob
        return LogAmp(torch.ones_like(log_psi), log_psi)

    # ------------------------------------------------------------------

    def sample(self, params: Params, generator: torch.Generator,
               batch: int) -> torch.Tensor:
        """`batch` exact ancestral draws, [batch, n] ±1 configs in the
        Sz=0 sector, distributed exactly as |psi|^2.  One call of
        ``torch.rand((batch, n))`` on the generator feeds them."""
        uniforms = torch.rand((batch, self.num_sites), generator=generator,
                              device=generator.device)
        return self.sample_from_uniforms(params, uniforms)

    @torch.no_grad()
    def sample_from_uniforms(self, params: Params, uniforms: torch.Tensor
                             ) -> torch.Tensor:
        """Ancestral draws from given uniforms [batch, n], one row a draw.

        Single-hidden-layer MADE takes an incremental path: the
        first-layer preactivation is rank-1-updated as each spin lands
        (z += s_i * W1[i]) and only logit_i's output column is formed,
        O(hidden) a site instead of the O(n·hidden) full forward.  The
        conditionals, and so the draws, are the same up to reduction
        order."""
        if (type(self) is AutoregressiveSpinModel
                and self.num_hidden_layers == 1):
            return self._sample_incremental(params, uniforms)
        return self._sample_generic(params, uniforms)

    def _draw_site(self, logit_i: torch.Tensor, ups: torch.Tensor, i: int,
                   uniform_i: torch.Tensor) -> torch.Tensor:
        """Spin i of every draw from its logit, the ups placed so far and
        its uniform, with the sector's forced/blocked rule."""
        n = self.num_sites
        ups_left = 0.5 * n - ups
        p_up = torch.sigmoid(logit_i)
        p_up = torch.where(ups_left >= float(n - i), torch.ones_like(p_up),
                           torch.where(ups_left <= 0.0,
                                       torch.zeros_like(p_up), p_up))
        return torch.where(uniform_i < p_up, 1.0, -1.0)

    def _sample_generic(self, params: Params, uniforms: torch.Tensor
                        ) -> torch.Tensor:
        """Reference ancestral path: one full `_logits` forward a site
        (works for any subclass)."""
        batch, n = uniforms.shape
        s = torch.zeros((batch, n), dtype=torch.float32,
                        device=uniforms.device)
        ups = torch.zeros(batch, dtype=torch.float32, device=uniforms.device)
        for i in range(n):
            logits = self._logits(params, s)
            spin = self._draw_site(logits[:, i], ups, i, uniforms[:, i])
            s[:, i] = spin
            ups = ups + (spin > 0)
        return s

    def _sample_incremental(self, params: Params, uniforms: torch.Tensor
                            ) -> torch.Tensor:
        """O(hidden)-a-site ancestral draws for 1-hidden-layer MADE."""
        batch, n = uniforms.shape
        act = logamp.ACTIVATIONS[self.nonlinearity]
        masks = self._masks_on(uniforms.device)
        l0, l1 = params['dense_0'], params['dense_1']
        w1 = l0['w'] * masks[0]             # [n, H] masked
        w2 = l1['w'] * masks[1]             # [H, n] masked
        z = l0['b'].to(torch.float32).expand(batch, -1).clone()
        ups = torch.zeros(batch, dtype=torch.float32, device=uniforms.device)
        spins = []
        for i in range(n):
            logit_i = act(z) @ w2[:, i] + l1['b'][i]
            spin = self._draw_site(logit_i, ups, i, uniforms[:, i])
            z = z + spin[:, None] * w1[i]
            ups = ups + (spin > 0)
            spins.append(spin)
        return torch.stack(spins, dim=1)

    @classmethod
    def from_config(cls, config, name: str = ''
                    ) -> 'AutoregressiveSpinModel':
        kwargs = dict(
            num_sites=config.num_sites,
            hidden=config.fc_layer_size,
            num_hidden_layers=max(1, config.num_fc_layers),
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
