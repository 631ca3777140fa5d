"""Mixture-of-Logits similarity.

Counterpart of `rails_tpu/similarity/mol.py`: query components with the uid
hash components, their L2 aux loss and uid dropout (:167-224), item
components (:226), the gating partials (:244-258), `build_item_tables`
(:260), the `glu_silu` combination with softmax dropout (:271-320), the
training `__call__` (:326-367), `load_balancing_mi_loss` (:42-70),
`score_gathered` (:369-402) and `score_precomputed` (:404-448). Parameter
names follow the flax tree (`query_proj.glu.w`, `uid_embeddings_0.embedding`,
`gating_qi.hidden`, ...).
Every dropout draws from the `torch.Generator` the caller passes, on the
tensors' device; the component products stay `torch.einsum`, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from rails_tpu_torch.core.config import MoLConfig
from rails_tpu_torch.similarity.layers import (
    GatingPartialMLP,
    ProjMLP,
    dropout,
    l2_normalize,
    normal,
)

AuxLosses = Dict[str, torch.Tensor]


def load_balancing_mi_loss(
    gating_prs: torch.Tensor, eps: float, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """-H(mean pi) + mean H(pi) over (B, X, L) gating probabilities; `weights`
    (B,) excludes padded rows (`mol.py:42-70`)."""
    b, x, l = gating_prs.shape
    if weights is None:
        flat = gating_prs.reshape(b * x, l)
        denom = b * x
        util = flat.sum(dim=0) / denom
        per_example_entropy = -torch.sum(flat * torch.log(flat + eps)) / denom
    else:
        w = weights.to(gating_prs.dtype)[:, None, None]
        denom = torch.clamp(torch.sum(weights) * x, min=1e-12)
        util = torch.sum(gating_prs * w, dim=(0, 1)) / denom
        per_example_entropy = -torch.sum(gating_prs * torch.log(gating_prs + eps) * w) / denom
    util_entropy = -torch.sum(util * torch.log(util + eps))
    return -util_entropy + per_example_entropy


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
            cfg.query_nonlinearity, compute_dtype, g, cfg.query_dropout_rate,
        )
        self.item_proj = ProjMLP(
            cfg.item_embedding_dim, cfg.item_dot_product_groups * d_p, cfg.item_hidden_dim,
            cfg.item_nonlinearity, compute_dtype, g, cfg.item_dropout_rate,
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
            compute_dtype, g, cfg.gating_item_dropout_rate,
        )
        self.gating_qi = GatingPartialMLP(
            cfg.num_logits, cfg.num_logits, cfg.gating_qi_hidden_dim, True, compute_dtype, g,
            cfg.gating_qi_dropout_rate,
        )

    def query_components(
        self, query_embeddings: torch.Tensor, user_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, D) -> (B, P_Q, d_P), uid components appended."""
        return self.query_components_aux(query_embeddings, user_ids)[0]

    def query_components_aux(
        self,
        query_embeddings: torch.Tensor,                  # (B, D)
        user_ids: Optional[torch.Tensor] = None,         # (B,)
        train: bool = False,
        weights: Optional[torch.Tensor] = None,          # (B,) aux-loss row weights
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, AuxLosses]:
        """(B, P_Q, d_P) components and, in training, the uid L2 aux loss;
        training also drops the projection input and the uid components."""
        c = self.cfg
        b = query_embeddings.shape[0]
        comps = self.query_proj(query_embeddings, train, generator).reshape(
            b, c.query_proj_groups, c.dot_product_dimension
        )
        aux: AuxLosses = {}
        if c.uid_embedding_hash_sizes:
            if user_ids is None:
                raise ValueError("MoLConfig.uid_embedding_hash_sizes is set; user_ids required")
            uid = []
            for i, h in enumerate(c.uid_embedding_hash_sizes):
                u = getattr(self, f"uid_embeddings_{i}")((user_ids % h) + 1)
                if train:
                    sq = torch.sum(u * u, dim=-1)
                    l2 = sq.mean() if weights is None else (
                        torch.sum(sq * weights) / torch.clamp(torch.sum(weights), min=1e-12))
                    aux["uid_embedding_l2_norm"] = aux.get("uid_embedding_l2_norm", 0.0) + l2
                if train and c.uid_dropout_rate > 0.0:
                    if c.uid_embedding_level_dropout:
                        keep = dropout(torch.ones(u.shape[:-1] + (1,), dtype=u.dtype,
                                                  device=u.device), c.uid_dropout_rate, generator)
                        u = u * keep
                    else:
                        u = dropout(u, c.uid_dropout_rate, generator)
                uid.append(u[:, None, :])
            comps = torch.cat([comps] + uid, dim=1)
        if c.dot_product_l2_norm:
            comps = l2_normalize(comps, c.eps)
        return comps, aux

    def item_components(
        self, item_embeddings: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """(..., D') -> (..., P_X, d_P)."""
        c = self.cfg
        comps = self.item_proj(item_embeddings, train, generator).reshape(
            item_embeddings.shape[:-1]
            + (c.item_dot_product_groups, c.dot_product_dimension)
        )
        if c.dot_product_l2_norm:
            comps = l2_normalize(comps, c.eps)
        return comps

    def item_gating_partial(
        self, item_embeddings: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        return self.gating_item(item_embeddings, train, generator)

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
        train: bool = False,
        weights: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, AuxLosses]:
        """glu_silu gating and the softmax-dropout combine (`mol.py:271-320`);
        in training, the MI aux loss."""
        c = self.cfg
        qi_partial = self.gating_qi(logits, train, generator)
        gating_inputs = query_partial * item_partial + qi_partial
        gating_weights = gating_inputs * torch.sigmoid(gating_inputs)
        pi = torch.softmax(gating_weights.float(), dim=-1)
        if train and c.softmax_dropout_rate > 0.0:
            pi = dropout(pi, c.softmax_dropout_rate, generator)
            pi = pi / torch.clamp(pi.sum(dim=-1, keepdim=True), min=c.eps)
        combined = torch.sum(pi * logits.float(), dim=-1)
        aux: AuxLosses = {}
        if train:
            aux["mi_loss"] = load_balancing_mi_loss(pi, c.eps, weights)
        return combined, aux

    def forward(
        self,
        query_embeddings: torch.Tensor,                  # (B, D)
        item_embeddings: torch.Tensor,                   # (1, X, D') or (B, X, D')
        user_ids: Optional[torch.Tensor] = None,
        train: bool = False,
        weights: Optional[torch.Tensor] = None,          # (B,) aux-loss row weights
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, AuxLosses]:
        """Scores (B, X) and aux losses (`mol.py:326-367`)."""
        c = self.cfg
        dt = self.compute_dtype
        b = query_embeddings.shape[0]
        b_prime, x = item_embeddings.shape[0], item_embeddings.shape[1]
        q_comp, q_aux = self.query_components_aux(
            query_embeddings, user_ids, train, weights, generator)
        i_comp = self.item_components(item_embeddings, train, generator)
        q_comp, i_comp = q_comp.to(dt), i_comp.to(dt)
        if b_prime == 1:
            logits = torch.einsum("bnd,xmd->bxnm", q_comp, i_comp[0])
        else:
            logits = torch.einsum("bnd,bxmd->bxnm", q_comp, i_comp)
        logits = logits.reshape(b, x, c.num_logits) / c.temperature
        query_partial = self.gating_query(query_embeddings, train, generator)[:, None, :]
        item_partial = self.item_gating_partial(item_embeddings, train, generator)
        scores, gate_aux = self._combine(
            logits, query_partial, item_partial, train, weights, generator)
        return scores, {**gate_aux, **q_aux}

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
        return self._combine(logits, query_partial, item_tables.gating_partial[None])[0]

    def score_gathered(
        self,
        query_embeddings: torch.Tensor,                 # (B, D)
        component_embeddings: torch.Tensor,             # (B, K, P_X, d_P)
        gating_partial: torch.Tensor,                   # (B, K, L)
        user_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, K) scores of each query against its own gathered candidate
        tables: the rerank of approximate retrieval."""
        c = self.cfg
        dt = self.compute_dtype
        q_comp = self.query_components(query_embeddings, user_ids).to(dt)
        logits = torch.einsum("bnd,bxmd->bxnm", q_comp, component_embeddings.to(dt))
        b, k = component_embeddings.shape[:2]
        logits = logits.reshape(b, k, c.num_logits) / c.temperature
        query_partial = self.query_gating_partial(query_embeddings)[:, None, :]
        return self._combine(logits, query_partial, gating_partial)[0]
