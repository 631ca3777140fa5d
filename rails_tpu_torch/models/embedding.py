"""Item embedding table (`rails_tpu/models/embedding.py:30`, LocalEmbeddingModule)."""

from __future__ import annotations

import torch
from torch import nn

from rails_tpu_torch.similarity.layers import truncated_normal


class LocalEmbeddingModule(nn.Module):
    """Plain (num_items + 1, D) table; row 0 is the padding row, zero at init."""

    def __init__(self, num_items: int, item_embedding_dim: int, generator: torch.Generator):
        super().__init__()
        table = truncated_normal((num_items + 1, item_embedding_dim), 0.02, generator)
        table[0] = 0.0
        self.embedding = nn.Parameter(table)

    def forward(self, item_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[item_ids.long()]
