"""Plain dot-product (MIPS) similarity.

Counterpart of `rails_tpu/similarity/dot_product.py:16-44`: the three
broadcast cases, a corpus shared by every query (items (1, X, D)), one item
row per query (items (B, X, D)) and r queries per item row (queries
(B * r, D)), each one einsum in the compute dtype. It has no parameters and
returns no aux losses.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn


class DotProductSimilarity(nn.Module):
    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype

    def forward(
        self,
        query_embeddings: torch.Tensor,                  # (B, D) or (B * r, D)
        item_embeddings: torch.Tensor,                   # (1, X, D) or (B, X, D)
        user_ids: Optional[torch.Tensor] = None,
        train: bool = False,
        weights: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        del user_ids, train, weights, generator
        q = query_embeddings.to(self.compute_dtype)
        i = item_embeddings.to(self.compute_dtype)
        b_i, x, d = i.shape
        if b_i == 1:
            scores = torch.einsum("bd,xd->bx", q, i[0])
        elif q.shape[0] != b_i:
            if q.shape[0] % b_i:
                raise ValueError(f"{q.shape[0]} queries do not split over {b_i} item rows")
            scores = torch.einsum("brd,bxd->brx", q.reshape(b_i, -1, d), i).reshape(-1, x)
        else:
            scores = torch.einsum("bd,bxd->bx", q, i)
        return scores, {}
