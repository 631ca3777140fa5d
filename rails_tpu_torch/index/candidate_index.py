"""Top-k retrieval with seen-id filtering (`rails_tpu/index/candidate_index.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from rails_tpu_torch.index.top_k import TopKResult


def select_top_k_with_invalid_filter(
    result: TopKResult,
    invalid_ids: Optional[torch.Tensor],   # (B, N0); 0 entries never match
    k: int,
) -> TopKResult:
    """Drop seen ids rowwise and keep exactly k per row, backfilling from the
    dropped entries when fewer than k remain (`candidate_index.py:22-51`)."""
    scores, ids = result.scores, result.ids
    if invalid_ids is None:
        return TopKResult(scores=scores[:, :k], ids=ids[:, :k])
    k_prime = ids.shape[1]
    if k_prime < k:
        raise ValueError(f"top-k pool {k_prime} smaller than requested k {k}")
    is_seen = (ids[:, :, None] == invalid_ids[:, None, :]).any(dim=2)   # (B, K')
    id_is_valid = ~is_seen
    id_is_valid = id_is_valid & (torch.cumsum(id_is_valid, dim=1) <= k)
    gap = k - id_is_valid.sum(dim=1, keepdim=True)
    masked = ~id_is_valid
    backfill = masked & (torch.cumsum(masked, dim=1) <= gap)
    keep = id_is_valid | backfill
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :k]
    return TopKResult(
        scores=torch.gather(scores, 1, order), ids=torch.gather(ids, 1, order)
    )


def k_prime_for(
    k: int, num_objects: int, max_num_invalid: int, truncate_k_prime_to: Optional[int] = None
) -> int:
    """k' sizing rule (`candidate_index.py:54-64`)."""
    k_prime = min(k + max_num_invalid, num_objects)
    if truncate_k_prime_to is not None:
        k_prime = min(k_prime, truncate_k_prime_to)
    return max(k_prime, k)
