"""Streamed exact-MoL top-k: the exactness reference at corpus sizes where no
standard-layout table or (B, X) score row is held whole.

Counterpart of `rails_tpu/index/oracle.py` (`streamed_exact_top_k`, :24-131).
Every corpus item is scored through the model's plain MoL path
(`score_precomputed`, no kernel) over bf16 tables, chunk by chunk, and the
per-chunk top-k merge on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rails_tpu_torch.index.top_k import BUILD_CHUNK, MoLTopKState
from rails_tpu_torch.similarity.mol import MoLItemTables


@torch.inference_mode()
def streamed_exact_top_k(
    model,
    state: MoLTopKState,
    q: torch.Tensor,                                  # (B, D) query embeddings
    user_ids: Optional[torch.Tensor],                 # (B,) or None
    k: int,
    embed_chunk_fn: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None,
    chunk: int = BUILD_CHUNK,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k (scores, item ids) as host numpy arrays, sorted descending.

    With `embed_chunk_fn(start, ids_chunk) -> (C, D)` the corpus was built
    chunk by chunk (`build_fused_state_chunked_on_device`, kernel layout
    only): each chunk's bf16 standard tables are regenerated from the same
    function. `chunk` must be the build's chunk size whenever that function
    keys its noise on the chunk start, or this scores another corpus.
    Otherwise the state's standard tables are sliced. Within a chunk, scoring
    runs in sub-chunks of about 1 GB of (B, sub, L) logits and (B, sub, H)
    gating activations; rows of padding id 0 are scored like any other, as in
    JAX."""
    ids_full = state.item_ids
    x = state.fused_tables.num_items if state.fused_tables is not None else int(ids_full.shape[0])
    m = model.cfg.mol
    bytes_per_item = int(q.shape[0]) * (m.num_logits + max(m.gating_qi_hidden_dim, 0) + 8) * 4 * 2
    sub_chunk = max(4096, min(chunk, (1 << 30) // max(bytes_per_item, 1)))
    sub_chunk = 1 << (sub_chunk.bit_length() - 1)   # divides a power-of-two chunk
    best_s = best_i = None
    for s0 in range(0, x, chunk):
        e0 = min(s0 + chunk, x)
        if embed_chunk_fn is not None:
            t = model.build_item_tables(embed_chunk_fn(s0, ids_full[s0:e0]))
            comp = t.component_embeddings.to(torch.bfloat16)
            gp = None if t.gating_partial is None else t.gating_partial.to(torch.bfloat16)
        else:
            comp = state.item_tables.component_embeddings[s0:e0]
            gp = state.item_tables.gating_partial
            gp = None if gp is None else gp[s0:e0]
        ids_host = ids_full[s0:e0].cpu().numpy()
        for s1 in range(0, e0 - s0, sub_chunk):
            e1 = min(s1 + sub_chunk, e0 - s0)
            tables = MoLItemTables(comp[s1:e1], None if gp is None else gp[s1:e1])
            sc = model.score_precomputed(q, tables, user_ids).float().cpu().numpy()
            k_loc = min(k, sc.shape[1])
            idx = np.argpartition(-sc, k_loc - 1, axis=1)[:, :k_loc]
            ss = np.take_along_axis(sc, idx, axis=1)
            ii = ids_host[s1:e1][idx]
            if best_s is None:
                best_s, best_i = ss, ii
            else:
                cs = np.concatenate([best_s, ss], axis=1)
                ci = np.concatenate([best_i, ii], axis=1)
                sel = np.argpartition(-cs, k - 1, axis=1)[:, :k]
                best_s = np.take_along_axis(cs, sel, axis=1)
                best_i = np.take_along_axis(ci, sel, axis=1)
    order = np.argsort(-best_s, axis=1, kind="stable")
    return (np.take_along_axis(best_s, order, axis=1)[:, :k],
            np.take_along_axis(best_i, order, axis=1)[:, :k])
