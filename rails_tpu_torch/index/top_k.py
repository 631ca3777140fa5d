"""Exact MoL top-k over a corpus.

Counterpart of the exact part of `rails_tpu/index/top_k.py`: `NEG_PAD` and
`_mask_pad_rows` (:39-61), `TopKResult`, `MoLTopKState` and
`build_mol_topk_state` (:107-208), `mol_brute_force_top_k` (:633-649) and
`mol_brute_force_top_k_fused` (:698-737).

The selection is `torch.topk`, exact at every corpus width, where the JAX
package uses `lax.top_k` (chunked below 262,144 items). Above that width the
JAX package switches to `hierarchical_top_k` fed by the fused scorer's
per-tile maxima; that pair is not ported yet (ROADMAP.md, Queue 1:
hierarchical_top_k, K2 options). Ties may resolve to other indices than
`lax.top_k`'s lowest-index rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rails_tpu_torch.ops.mol_scoring import (
    FusedCorpusTables,
    extract_gating_qi_weights,
    fused_mol_scores_t,
    prepare_fused_tables,
)
from rails_tpu_torch.similarity.mol import MoLItemTables

# Item id 0 is the padding id; rows carrying it score this before any select.
NEG_PAD = -1.0e30


def _mask_pad_rows(scores: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
    return torch.where(item_ids == 0, NEG_PAD, scores)


class TopKResult(NamedTuple):
    scores: torch.Tensor   # (B, K)
    ids: torch.Tensor      # (B, K)


class MoLTopKState(NamedTuple):
    """Device-resident corpus state of the exact MoL top-k. (The JAX state's
    `avg_component` and `ivf` serve approximate retrieval, not ported.)"""

    item_ids: torch.Tensor            # (X,) int32
    item_tables: MoLItemTables        # components (X, P_X, d_P) + gating (X, L)
    fused_tables: Optional[FusedCorpusTables] = None


def build_mol_topk_state(
    model,
    item_ids: torch.Tensor,
    item_embeddings: torch.Tensor,
    table_dtype: torch.dtype = torch.bfloat16,
    build_fused: bool = False,
) -> MoLTopKState:
    """Precompute the item-side tables of a corpus (X, D), in `table_dtype`;
    `build_fused` adds the kernel-layout tables of the fused scorer."""
    tables = model.build_item_tables(item_embeddings)
    comp = tables.component_embeddings.to(table_dtype)
    gating = tables.gating_partial.to(table_dtype)
    fused = None
    if build_fused:
        fused = prepare_fused_tables(comp, gating)
    return MoLTopKState(
        item_ids=item_ids.to(torch.int32),
        item_tables=MoLItemTables(component_embeddings=comp, gating_partial=gating),
        fused_tables=fused,
    )


def mol_brute_force_top_k(
    model, state: MoLTopKState, query_embeddings: torch.Tensor, k: int,
    user_ids: Optional[torch.Tensor] = None,
) -> TopKResult:
    """Exact MoL over the whole corpus through plain PyTorch scoring
    (`MoLBruteForceTopK`)."""
    scores = model.score_precomputed(query_embeddings, state.item_tables, user_ids)
    scores = _mask_pad_rows(scores, state.item_ids)
    top_scores, top_idx = torch.topk(scores, k, dim=1)
    return TopKResult(scores=top_scores, ids=state.item_ids[top_idx])


def mol_brute_force_top_k_fused(
    model, state: MoLTopKState, query_embeddings: torch.Tensor, k: int,
    user_ids: Optional[torch.Tensor] = None,
) -> TopKResult:
    """Exact MoL over the whole corpus through the fused scorer (K2):
    the (B, X, L) logits and the gating activations never reach memory."""
    ft = state.fused_tables
    if ft is None:
        raise ValueError("build_mol_topk_state(..., build_fused=True) is required")
    q_comp = model.query_components(query_embeddings, user_ids)
    scores = fused_mol_scores_t(
        q_comp.to(ft.item_comp_t.dtype).contiguous(), model.query_gating_partial(query_embeddings),
        ft.item_comp_t, ft.item_partial_t, extract_gating_qi_weights(model.mol),
        float(model.cfg.mol.temperature),
    )
    scores = _mask_pad_rows(scores[:, : ft.num_items], state.item_ids)
    top_scores, top_idx = torch.topk(scores, k, dim=1)
    return TopKResult(scores=top_scores, ids=state.item_ids[top_idx])
