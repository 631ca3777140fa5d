"""Item embedding table (`rails_tpu/models/embedding.py:30-48`, LocalEmbeddingModule)."""

from __future__ import annotations

import torch
from torch import nn

from rails_tpu_torch.ops.scatter_add import gather_rows
from rails_tpu_torch.similarity.layers import truncated_normal


class LocalEmbeddingModule(nn.Module):
    """Plain (num_items + 1, D) table; row 0 is the padding row, zero at init.
    With `scatter_grad_kernel` (`train.pallas_scatter_grad`) the gather's
    backward is the binned scatter-add K6 (`ops.scatter_add.gather_rows`)
    instead of torch's indexing backward; the gradient is the same dense
    f32 table."""

    def __init__(self, num_items: int, item_embedding_dim: int, generator: torch.Generator,
                 scatter_grad_kernel: bool = False):
        super().__init__()
        table = truncated_normal((num_items + 1, item_embedding_dim), 0.02, generator)
        table[0] = 0.0
        self.embedding = nn.Parameter(table)
        self.scatter_grad_kernel = scatter_grad_kernel

    def forward(self, item_ids: torch.Tensor) -> torch.Tensor:
        if self.scatter_grad_kernel:
            return gather_rows(self.embedding, item_ids)
        return self.embedding[item_ids.long()]
