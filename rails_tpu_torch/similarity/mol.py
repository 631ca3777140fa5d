"""Mixture-of-Logits similarity.

Counterpart of `rails_tpu/similarity/mol.py`: query components with the uid
hash components, their L2 aux loss and uid dropout (:167-224), item
components (:226), the gating partials (:244-258), `build_item_tables`
(:260), the `glu_silu`, `glu_silu_ln` and `none` combinations with softmax
dropout (:271-320; `none` takes whichever gating partials the config
builds, :88-96), the training `__call__` (:326-367), `load_balancing_mi_loss` (:42-70),
`score_gathered` (:369-402) and `score_precomputed` (:404-448). Parameter
names follow the flax tree (`query_proj.glu.w`, `uid_embeddings_0.embedding`,
`gating_qi.hidden`, ...).
Every dropout draws from the `torch.Generator` the caller passes, on the
tensors' device; the component products stay `torch.einsum`, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from rails_tpu_torch.core.config import MoLConfig
from rails_tpu_torch.core.distributed import (
    global_sum,
    global_sum_grad,
    rank_share,
    replicated_rows,
)
from rails_tpu_torch.similarity.layers import (
    GatingPartialMLP,
    ProjMLP,
    dropout,
    l2_normalize,
    layer_norm_in_dtype,
    normal,
)

AuxLosses = Dict[str, torch.Tensor]
COMBINATIONS = ("glu_silu", "glu_silu_ln", "none")


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
        util_entropy = -torch.sum(util * torch.log(util + eps))
        return -util_entropy + per_example_entropy
    # A data-parallel rank's rows: the utilisation is the global batch's
    # (summed, differentiably, over the ranks) and this rank adds its share
    # of its entropy, and its rows' part of the per-example entropy.
    w = weights.to(gating_prs.dtype)[:, None, None]
    denom = torch.clamp(global_sum(torch.sum(weights)) * x, min=1e-12)
    util = global_sum_grad(torch.sum(gating_prs * w, dim=(0, 1))) / denom
    per_example_entropy = -torch.sum(gating_prs * torch.log(gating_prs + eps) * w) / denom
    util_entropy = -torch.sum(util * torch.log(util + eps))
    return -util_entropy * rank_share() + per_example_entropy


def _rows(partial: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, L) -> (B, 1, L); None stays None."""
    return None if partial is None else partial[:, None, :]


class MoLItemTables(NamedTuple):
    """Precomputed item-side state for decoupled (indexing-time) scoring."""

    component_embeddings: torch.Tensor        # (X, P_X, d_P)
    gating_partial: Optional[torch.Tensor]    # (X, L), or None without gating_item_fn


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
        if cfg.gating_combination_type not in COMBINATIONS:
            raise ValueError(f"Unknown gating_combination_type {cfg.gating_combination_type!r}")
        if cfg.gating_combination_type != "none" and not (cfg.gating_query_fn
                                                         and cfg.gating_item_fn):
            raise ValueError(f"gating_combination_type={cfg.gating_combination_type!r} requires "
                             "gating_query_fn and gating_item_fn (use 'none' to drop a partial)")
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
        # No module (and no parameters) for a partial the config turns off.
        self.gating_query = GatingPartialMLP(
            cfg.query_embedding_dim, cfg.num_logits, cfg.gating_query_hidden_dim, False,
            compute_dtype, g,
        ) if cfg.gating_query_fn else None
        self.gating_item = GatingPartialMLP(
            cfg.item_embedding_dim, cfg.num_logits, cfg.gating_item_hidden_dim, False,
            compute_dtype, g, cfg.gating_item_dropout_rate,
        ) if cfg.gating_item_fn else None
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
                        torch.sum(sq * weights)
                        / torch.clamp(global_sum(torch.sum(weights)), min=1e-12))
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
    ) -> Optional[torch.Tensor]:
        """(..., D') -> (..., L), or None without gating_item_fn."""
        if self.gating_item is None:
            return None
        return self.gating_item(item_embeddings, train, generator)

    def query_gating_partial(
        self, query_embeddings: torch.Tensor, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Optional[torch.Tensor]:
        """(B, D) -> (B, L), or None without gating_query_fn."""
        if self.gating_query is None:
            return None
        return self.gating_query(query_embeddings, train, generator)

    def build_item_tables(self, item_embeddings: torch.Tensor) -> MoLItemTables:
        """Per-item state for indexing; item_embeddings (X, D')."""
        return MoLItemTables(
            component_embeddings=self.item_components(item_embeddings),
            gating_partial=self.item_gating_partial(item_embeddings),
        )

    def _combine(
        self,
        logits: torch.Tensor,                    # (B, X, L), already divided by T
        query_partial: Optional[torch.Tensor],   # (B, 1, L)
        item_partial: Optional[torch.Tensor],    # (1 or B, X, L)
        train: bool = False,
        weights: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, AuxLosses]:
        """The gating combination and the softmax-dropout combine
        (`mol.py:271-320`); in training, the MI aux loss. glu_silu_ln's
        parameter-free LayerNorm (eps 1e-5) runs in the partials' dtype, as
        jnp.mean / jnp.var do."""
        c = self.cfg
        qi_partial = self.gating_qi(logits, train, generator)
        if c.gating_combination_type == "none":
            gating_weights = qi_partial
            for partial in (query_partial, item_partial):
                if partial is not None:
                    gating_weights = gating_weights + partial
        else:
            gating_inputs = query_partial * item_partial + qi_partial
            gate = gating_inputs
            if c.gating_combination_type == "glu_silu_ln":
                gate = layer_norm_in_dtype(gating_inputs, 1e-5)
            gating_weights = gating_inputs * torch.sigmoid(gate)
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
        # A shared corpus (1, X, D') is the same on every data-parallel rank.
        def shared():
            return replicated_rows() if b_prime == 1 else contextlib.nullcontext()

        with shared():
            i_comp = self.item_components(item_embeddings, train, generator)
        q_comp, i_comp = q_comp.to(dt), i_comp.to(dt)
        if b_prime == 1:
            logits = torch.einsum("bnd,xmd->bxnm", q_comp, i_comp[0])
        else:
            logits = torch.einsum("bnd,bxmd->bxnm", q_comp, i_comp)
        logits = logits.reshape(b, x, c.num_logits) / c.temperature
        query_partial = _rows(self.query_gating_partial(query_embeddings, train, generator))
        with shared():
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
        query_partial = _rows(self.query_gating_partial(query_embeddings))
        item_partial = item_tables.gating_partial
        return self._combine(logits, query_partial,
                             None if item_partial is None else item_partial[None])[0]

    def score_gathered(
        self,
        query_embeddings: torch.Tensor,                 # (B, D)
        component_embeddings: torch.Tensor,             # (B, K, P_X, d_P)
        gating_partial: Optional[torch.Tensor],         # (B, K, L) or None
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
        query_partial = _rows(self.query_gating_partial(query_embeddings))
        return self._combine(logits, query_partial, gating_partial)[0]
