"""Mixture-of-Logits similarity, eval side.

Counterpart of `rails_tpu/similarity/mol.py` for serving: query components
with the uid hash components (:167-224), item components (:226), the gating
partials (:244-258), `build_item_tables` (:260), the `glu_silu` combination
(:271-320) and `score_precomputed` (:404-448). Parameter names follow the
flax tree (`query_proj.glu.w`, `uid_embeddings_0.embedding`,
`gating_qi.hidden`, ...). Train-only dropout and the MI loss wait for the
training port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from rails_tpu.core.config import MoLConfig
from rails_tpu_torch.similarity.layers import (
    GatingPartialMLP,
    ProjMLP,
    l2_normalize,
    normal,
)


class MoLItemTables(NamedTuple):
    """Precomputed item-side state for decoupled (indexing-time) scoring."""

    component_embeddings: torch.Tensor        # (X, P_X, d_P)
    gating_partial: Optional[torch.Tensor]    # (X, L)


class Embed(nn.Module):
    """flax `nn.Embed`: an `embedding` table read in `compute_dtype`."""

    def __init__(self, table: torch.Tensor, compute_dtype: torch.dtype):
        super().__init__()
        self.embedding = nn.Parameter(table)
        self.compute_dtype = compute_dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()].to(self.compute_dtype)


class MoLSimilarity(nn.Module):
    """similarity(q, x) = sum_l pi_l(q, x) * logit_l(q, x), logits / temperature."""

    def __init__(
        self, cfg: MoLConfig, compute_dtype: torch.dtype, generator: torch.Generator
    ):
        super().__init__()
        if cfg.gating_combination_type != "glu_silu":
            raise NotImplementedError(
                f"gating_combination_type={cfg.gating_combination_type!r}: only "
                "glu_silu is ported (ROADMAP.md, Queue 1: preprocessors, embeddings and similarities)"
            )
        if not (cfg.gating_query_fn and cfg.gating_item_fn):
            raise ValueError("glu_silu requires gating_query_fn and gating_item_fn")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        d_p, g = cfg.dot_product_dimension, generator
        self.query_proj = ProjMLP(
            cfg.query_embedding_dim, cfg.query_proj_groups * d_p, cfg.query_hidden_dim,
            cfg.query_nonlinearity, compute_dtype, g,
        )
        self.item_proj = ProjMLP(
            cfg.item_embedding_dim, cfg.item_dot_product_groups * d_p, cfg.item_hidden_dim,
            cfg.item_nonlinearity, compute_dtype, g,
        )
        # Hashed per-user components, looked up at (uid % hash) + 1; N(0, 1)
        # init as torch.nn.Embedding's default (`mol.py:115-132`).
        for i, hash_size in enumerate(cfg.uid_embedding_hash_sizes):
            table = normal((hash_size + 1, d_p), 1.0, g)
            self.add_module(f"uid_embeddings_{i}", Embed(table, compute_dtype))
        self.gating_query = GatingPartialMLP(
            cfg.query_embedding_dim, cfg.num_logits, cfg.gating_query_hidden_dim, False,
            compute_dtype, g,
        )
        self.gating_item = GatingPartialMLP(
            cfg.item_embedding_dim, cfg.num_logits, cfg.gating_item_hidden_dim, False,
            compute_dtype, g,
        )
        self.gating_qi = GatingPartialMLP(
            cfg.num_logits, cfg.num_logits, cfg.gating_qi_hidden_dim, True, compute_dtype, g,
        )

    def query_components(
        self, query_embeddings: torch.Tensor, user_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, D) -> (B, P_Q, d_P), uid components appended."""
        c = self.cfg
        b = query_embeddings.shape[0]
        comps = self.query_proj(query_embeddings).reshape(
            b, c.query_proj_groups, c.dot_product_dimension
        )
        if c.uid_embedding_hash_sizes:
            if user_ids is None:
                raise ValueError("MoLConfig.uid_embedding_hash_sizes is set; user_ids required")
            uid = [
                getattr(self, f"uid_embeddings_{i}")((user_ids % h) + 1)[:, None, :]
                for i, h in enumerate(c.uid_embedding_hash_sizes)
            ]
            comps = torch.cat([comps] + uid, dim=1)
        if c.dot_product_l2_norm:
            comps = l2_normalize(comps, c.eps)
        return comps

    def item_components(self, item_embeddings: torch.Tensor) -> torch.Tensor:
        """(..., D') -> (..., P_X, d_P)."""
        c = self.cfg
        comps = self.item_proj(item_embeddings).reshape(
            item_embeddings.shape[:-1]
            + (c.item_dot_product_groups, c.dot_product_dimension)
        )
        if c.dot_product_l2_norm:
            comps = l2_normalize(comps, c.eps)
        return comps

    def item_gating_partial(self, item_embeddings: torch.Tensor) -> torch.Tensor:
        return self.gating_item(item_embeddings)

    def query_gating_partial(self, query_embeddings: torch.Tensor) -> torch.Tensor:
        return self.gating_query(query_embeddings)

    def build_item_tables(self, item_embeddings: torch.Tensor) -> MoLItemTables:
        """Per-item state for indexing; item_embeddings (X, D')."""
        return MoLItemTables(
            component_embeddings=self.item_components(item_embeddings),
            gating_partial=self.item_gating_partial(item_embeddings),
        )

    def _combine(
        self,
        logits: torch.Tensor,          # (B, X, L), already divided by T
        query_partial: torch.Tensor,   # (B, 1, L)
        item_partial: torch.Tensor,    # (1 or B, X, L)
    ) -> torch.Tensor:
        """glu_silu gating and the softmax combine (`mol.py:271-320`, eval)."""
        qi_partial = self.gating_qi(logits)
        gating_inputs = query_partial * item_partial + qi_partial
        gating_weights = gating_inputs * torch.sigmoid(gating_inputs)
        pi = torch.softmax(gating_weights.float(), dim=-1)
        return torch.sum(pi * logits.float(), dim=-1)

    def score_precomputed(
        self,
        query_embeddings: torch.Tensor,                 # (B, D)
        item_tables: MoLItemTables,
        user_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, X) scores of every query against the whole shared corpus."""
        c = self.cfg
        dt = self.compute_dtype
        q_comp = self.query_components(query_embeddings, user_ids).to(dt)
        i_comp = item_tables.component_embeddings.to(dt)
        logits = torch.einsum("bnd,xmd->bxnm", q_comp, i_comp)
        b, x = logits.shape[:2]
        logits = logits.reshape(b, x, c.num_logits) / c.temperature
        query_partial = self.query_gating_partial(query_embeddings)[:, None, :]
        return self._combine(logits, query_partial, item_tables.gating_partial[None])
