"""Item embedding tables (`rails_tpu/models/embedding.py`): the local table
(:30-48) and the categorical one (:51-75), whose items share rows through an
id -> category remap."""

from __future__ import annotations

import numpy as np
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


class CategoricalEmbeddingModule(nn.Module):
    """(num_categories + 1, D) table read at row remap[(id - 1).clip(0)] + 1;
    id 0 reads the zero padding row 0 (`embedding.py:51-75`). The remap
    (max_item_id,) is a buffer, not a parameter. With `scatter_grad_kernel`
    the gather's backward is K6 into the category table, as for the local
    table."""

    def __init__(self, num_categories: int, item_embedding_dim: int,
                 item_id_to_category_id: np.ndarray, generator: torch.Generator,
                 scatter_grad_kernel: bool = False):
        super().__init__()
        table = truncated_normal((num_categories + 1, item_embedding_dim), 0.02, generator)
        table[0] = 0.0
        self.embedding = nn.Parameter(table)
        self.register_buffer(
            "category_of", torch.as_tensor(np.asarray(item_id_to_category_id), dtype=torch.int32),
            persistent=False)
        self.scatter_grad_kernel = scatter_grad_kernel

    def category_ids(self, item_ids: torch.Tensor) -> torch.Tensor:
        ids = item_ids.long()
        rows = self.category_of[(ids - 1).clamp(min=0)] + 1
        return torch.where(ids == 0, torch.zeros_like(rows), rows)

    def forward(self, item_ids: torch.Tensor) -> torch.Tensor:
        rows = self.category_ids(item_ids)
        if self.scatter_grad_kernel:
            return gather_rows(self.embedding, rows)
        return self.embedding[rows.long()]
