"""Language-model MoL component embeddings: P components from a token sequence.

Counterpart of `rails_tpu/similarity/lm_embeddings.py`: `mask_mixing_weights`
(:26-39), the masked softmax over sequence positions, and
`LMMoLEmbeddingsFn` (:42-116), which covers the reference's query and item
LM embedding functions. With mixing weights (v2: anchor token 0, v4: anchor
token P) a small MLP on the anchor token gives per-position mixing logits,
softmaxed over the valid positions, and each component is a
position-weighted sum of the token embeddings; otherwise the first P token
embeddings are the components. The parameters carry the flax names
(`mix_fc1`, `mix_ln` with `scale` and `bias`, `mix_fc2`). Plain torch: the
JAX module has no kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rails_tpu_torch.similarity.layers import l2_normalize, linear, xavier_normal


def mask_mixing_weights(
    mixing_weights: torch.Tensor,    # (B, N, P)
    input_ids: torch.Tensor,         # (B, N') with N' <= N; 0 = padding
    input_max_length: int,
) -> torch.Tensor:
    """Softmax over the position axis with padded positions at -1e3."""
    n = mixing_weights.shape[1]
    if input_ids.shape[1] < input_max_length:
        input_ids = F.pad(input_ids, (0, input_max_length - input_ids.shape[1]))
    valid = (input_ids[:, :n] != 0)[:, :, None]
    masked = torch.where(valid, mixing_weights, torch.full((), -1e3, dtype=mixing_weights.dtype,
                                                           device=mixing_weights.device))
    return torch.softmax(masked, dim=1)


class _LayerNorm(nn.Module):
    """flax `nn.LayerNorm`'s parameters: `scale` (ones) and `bias` (zeros)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class LMMoLEmbeddingsFn(nn.Module):
    """(B, N, D) token embeddings -> ((B, P, D) components, {})."""

    def __init__(
        self,
        input_max_length: int,
        input_embedding_dim: int,
        dot_product_groups: int,
        dot_product_l2_norm: bool = True,
        eps: float = 1e-6,
        apply_mixing_weights_v2: bool = False,
        apply_mixing_weights_v4: bool = False,
        mixing_weights_hidden_dim: int = 256,
        filter_invalid_positions: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if apply_mixing_weights_v2 and apply_mixing_weights_v4:
            raise ValueError("apply_mixing_weights_v2 and _v4 exclude each other")
        self.input_max_length = input_max_length
        self.dot_product_groups = dot_product_groups
        self.dot_product_l2_norm = dot_product_l2_norm
        self.eps = eps
        self.anchor = dot_product_groups if apply_mixing_weights_v4 else 0
        self.mixing = apply_mixing_weights_v2 or apply_mixing_weights_v4
        self.filter_invalid_positions = filter_invalid_positions
        if self.mixing:
            g = generator if generator is not None else torch.Generator().manual_seed(0)
            h, out = mixing_weights_hidden_dim, input_max_length * dot_product_groups
            self.mix_fc1 = linear(input_embedding_dim, h, xavier_normal((h, input_embedding_dim), g))
            # torch nn.LayerNorm's default eps, as the reference's.
            self.mix_ln = _LayerNorm(h, 1e-5)
            self.mix_fc2 = linear(h, out, xavier_normal((out, h), g))

    def forward(
        self, input_embeddings: torch.Tensor, input_ids: Optional[torch.Tensor] = None,
        train: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        del train
        b, n, _ = input_embeddings.shape
        if self.mixing:
            if n < self.input_max_length:
                input_embeddings = F.pad(input_embeddings, (0, 0, 0, self.input_max_length - n))
            h = F.silu(self.mix_ln(self.mix_fc1(input_embeddings[:, self.anchor, :])))
            logits = self.mix_fc2(h).reshape(b, self.input_max_length, self.dot_product_groups)
            if self.filter_invalid_positions:
                if input_ids is None:
                    raise ValueError("filter_invalid_positions requires input_ids")
                weights = mask_mixing_weights(logits, input_ids, self.input_max_length)
            else:
                weights = torch.softmax(logits, dim=1)
            comps = torch.einsum("bnd,bnm->bmd", input_embeddings, weights)
        else:
            comps = input_embeddings[:, : self.dot_product_groups, :]
        if self.dot_product_l2_norm:
            comps = l2_normalize(comps, self.eps)
        return comps, {}
