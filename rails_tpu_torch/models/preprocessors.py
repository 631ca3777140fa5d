"""Input preprocessor and output postprocessor.

Counterpart of `rails_tpu/models/preprocessors.py`: `length_mask` (:25), the
learnable positional preprocessor with its train-mode dropout (:30-55) and
`postprocess_output` (:160-171). The rated and combined preprocessors are
not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rails_tpu_torch.similarity.layers import dropout, l2_normalize, xavier_normal


def length_mask(lengths: torch.Tensor, n: int) -> torch.Tensor:
    """(B,) lengths -> (B, N) bool, True for positions < length."""
    return torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]


class LearnablePositionalEmbeddingInputPreprocessor(nn.Module):
    """emb * sqrt(D) + pos_emb[:n], dropout in training, invalid positions
    zeroed."""

    def __init__(
        self, max_sequence_len: int, embedding_dim: int, compute_dtype: torch.dtype,
        generator: torch.Generator, dropout_rate: float = 0.0,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.pos_emb = nn.Parameter(xavier_normal((max_sequence_len, embedding_dim), generator))

    def forward(
        self, past_lengths: torch.Tensor, past_embeddings: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = past_embeddings.shape[1]
        x = past_embeddings * (self.embedding_dim ** 0.5) + self.pos_emb[None, :n, :]
        if train:
            x = dropout(x, self.dropout_rate, generator)
        valid = length_mask(past_lengths, n)
        x = x * valid[..., None].to(x.dtype)
        return x.to(self.compute_dtype), valid


def postprocess_output(
    x: torch.Tensor, mode: str, embedding_dim: int, eps: float = 1e-6
) -> torch.Tensor:
    """Parameter-free output normalisation ('l2_norm' | 'layer_norm')."""
    x = x[..., :embedding_dim]
    if mode == "l2_norm":
        return l2_normalize(x, eps)
    if mode == "layer_norm":
        mu = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + eps)
    raise ValueError(f"Unknown user_embedding_norm {mode!r}")
