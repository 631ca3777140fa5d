"""Input preprocessor and output postprocessor.

Counterpart of `rails_tpu/models/preprocessors.py`: `length_mask` (:25), the
learnable positional preprocessor with its train-mode dropout (:30-55), the
rated one (:66-107: [item, rating] embeddings of width D + rating_dim, the
ratings clipped to the vocabulary), the combined one (:110-157: items and
ratings interleaved to length 2N, lengths doubled) and `postprocess_output`
(:160-171). The rated and combined embeddings concatenate the compute-dtype
item rows with the f32 rating rows in f32, as jnp's type promotion does, and
round to the compute dtype at the end.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from rails_tpu_torch.similarity.layers import (
    dropout,
    l2_normalize,
    truncated_normal,
    xavier_normal,
)


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

    def at_position(self, embedding_t: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
        """One position per row, for incremental decode (`preprocessors.py:
        57-63`): emb * sqrt(D) + pos_emb[position]; (B, D), (B,) -> (B, D)."""
        x = embedding_t * (self.embedding_dim ** 0.5) + self.pos_emb[position.long()]
        return x.to(self.compute_dtype)


class LearnablePositionalEmbeddingRatedInputPreprocessor(nn.Module):
    """[item_emb, rating_emb] * sqrt(D + R) + pos_emb[:n], dropout in
    training, invalid positions zeroed; width D + R."""

    def __init__(
        self, max_sequence_len: int, item_embedding_dim: int, rating_embedding_dim: int,
        num_ratings: int, compute_dtype: torch.dtype, generator: torch.Generator,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        d = item_embedding_dim + rating_embedding_dim
        self.embedding_dim = d
        self.num_ratings = num_ratings
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        std = (1.0 / d) ** 0.5
        self.pos_emb = nn.Parameter(truncated_normal((max_sequence_len, d), std, generator))
        self.rating_emb = nn.Parameter(
            truncated_normal((num_ratings, rating_embedding_dim), std, generator))

    def forward(
        self, past_lengths: torch.Tensor, past_embeddings: torch.Tensor, ratings: torch.Tensor,
        train: bool = False, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = past_embeddings.shape[1]
        rating_emb = self.rating_emb[ratings.long().clamp(0, self.num_ratings - 1)]
        x = torch.cat([past_embeddings.float(), rating_emb], dim=-1)
        x = x * (self.embedding_dim ** 0.5) + self.pos_emb[None, :n, :]
        if train:
            x = dropout(x, self.dropout_rate, generator)
        valid = length_mask(past_lengths, n)
        x = x * valid[..., None].to(x.dtype)
        return x.to(self.compute_dtype), valid


class CombinedItemAndRatingInputPreprocessor(nn.Module):
    """[item_0, rating_0, item_1, rating_1, ...] (length 2N) * sqrt(D) +
    pos_emb[:2N], dropout in training, invalid pairs zeroed; returns the
    doubled lengths too. The interleave needs rating_embedding_dim == D."""

    def __init__(
        self, max_sequence_len: int, embedding_dim: int, rating_embedding_dim: int,
        num_ratings: int, compute_dtype: torch.dtype, generator: torch.Generator,
        dropout_rate: float = 0.0,
    ):
        super().__init__()
        if rating_embedding_dim != embedding_dim:
            raise ValueError("CombinedItemAndRating requires rating_embedding_dim == "
                             "item embedding_dim")
        self.embedding_dim = embedding_dim
        self.num_ratings = num_ratings
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        std = (1.0 / embedding_dim) ** 0.5
        # max_sequence_len already counts the 2x interleave.
        self.pos_emb = nn.Parameter(
            truncated_normal((max_sequence_len, embedding_dim), std, generator))
        self.rating_emb = nn.Parameter(
            truncated_normal((num_ratings, rating_embedding_dim), std, generator))

    def forward(
        self, past_lengths: torch.Tensor, past_embeddings: torch.Tensor, ratings: torch.Tensor,
        train: bool = False, generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, n, d = past_embeddings.shape
        rating_emb = self.rating_emb[ratings.long().clamp(0, self.num_ratings - 1)]
        x = torch.stack([past_embeddings.float(), rating_emb], dim=2).reshape(b, 2 * n, d)
        x = x * (d ** 0.5) + self.pos_emb[None, : 2 * n, :]
        if train:
            x = dropout(x, self.dropout_rate, generator)
        valid = length_mask(past_lengths, n).repeat_interleave(2, dim=1)
        x = x * valid[..., None].to(x.dtype)
        return x.to(self.compute_dtype), valid, past_lengths * 2


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
