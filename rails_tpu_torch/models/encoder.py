"""Top-level sequential recommender: embedding -> positional preprocessor ->
HSTU stack -> output norm, owning the MoL similarity.

Counterpart of `rails_tpu/models/encoder.py` (`SequentialRecommender`) for
model_type="HSTU", similarity_type="MoL", the positional preprocessor and the
local embedding table (its gather's backward through K6 with
`train.pallas_scatter_grad`, `encoder.py:58`): `encode_sequence`/`encode` (:167-202, eval and
training), `get_item_embeddings`, `similarity_fn` (:255-267),
`build_item_tables`, `query_components`, `query_gating_partial`,
`score_precomputed` and `score_gathered` (:284-294). Parameter names follow
the flax tree (`item_emb.embedding`, `input_preproc.pos_emb`,
`hstu.block_3.uvqk`, `mol.gating_qi.hidden.weight`, ...), so
`compat.from_jax.state_dict_from_jax_params` loads a JAX model strictly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn

from rails_tpu_torch.core.config import ExperimentConfig
from rails_tpu_torch.core.device import resolve_device
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.models.embedding import LocalEmbeddingModule
from rails_tpu_torch.models.hstu import HSTUStack
from rails_tpu_torch.models.preprocessors import (
    LearnablePositionalEmbeddingInputPreprocessor,
    postprocess_output,
)
from rails_tpu_torch.similarity.mol import MoLItemTables, MoLSimilarity


def _require(ok: bool, what: str, item: str) -> None:
    if not ok:
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, Queue 1: {item})")


class SequentialRecommender(nn.Module):
    """HSTU encoder + MoL similarity.

    `compute_dtype` plays the role of the flax model's `dtype` (bf16 when the
    config sets `main_module_bf16`); parameters stay float32. Weights are
    drawn from `generator` on the CPU (seeded from `cfg.train.random_seed`
    when none is given) and then moved to `device` (the card unless the
    caller passes "cpu"), so one seed gives the same model on every device.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        num_items: int,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _require(cfg.model_type == "HSTU", f"model_type={cfg.model_type!r}", "SASRec")
        _require(cfg.similarity_type == "MoL", f"similarity_type={cfg.similarity_type!r}",
                 "preprocessors, embeddings and similarities")
        _require(cfg.input_preprocessor_type == "positional",
                 f"input_preprocessor_type={cfg.input_preprocessor_type!r}",
                 "preprocessors, embeddings and similarities")
        _require(cfg.embedding_module_type == "local",
                 f"embedding_module_type={cfg.embedding_module_type!r}",
                 "preprocessors, embeddings and similarities")
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.train.random_seed)
        self.cfg = cfg
        self.num_items = num_items
        self.compute_dtype = compute_dtype
        d = cfg.train.item_embedding_dim
        n = cfg.max_seq_len_padded
        self.item_emb = LocalEmbeddingModule(num_items, d, generator,
                                             scatter_grad_kernel=cfg.train.pallas_scatter_grad)
        self.input_preproc = LearnablePositionalEmbeddingInputPreprocessor(
            n, d, compute_dtype, generator, cfg.train.dropout_rate
        )
        hstu_cfg = cfg.hstu if cfg.hstu.embedding_dim == d else cfg.hstu.replace(embedding_dim=d)
        self.hstu = HSTUStack(hstu_cfg, n, compute_dtype, generator)
        self.mol = MoLSimilarity(cfg.mol, compute_dtype, generator)
        self.to(resolve_device(device))

    def get_item_embeddings(self, item_ids: torch.Tensor) -> torch.Tensor:
        return self.item_emb(item_ids)

    def preprocess(
        self, features: SequentialFeatures, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embedding lookup + positional preprocessor: (x (B, N, D) in the
        compute dtype with invalid rows zeroed, valid (B, N) bool)."""
        emb = self.item_emb(features.ids).to(self.compute_dtype)
        x, valid = self.input_preproc(features.lengths, emb, train, generator)
        return x * valid[..., None].to(x.dtype), valid

    def postprocess(self, y: torch.Tensor) -> torch.Tensor:
        t = self.cfg.train
        return postprocess_output(y.float(), t.user_embedding_norm, t.item_embedding_dim)

    def encode_sequence(
        self, features: SequentialFeatures, train: bool = False,
        generator: Optional[torch.Generator] = None, seed0: Optional[int] = None,
    ) -> torch.Tensor:
        """[B, N] -> [B, N, D]. Training draws the input dropout (and the XLA
        block path's dropouts) from `generator` and seeds the fused HSTU
        blocks' hash dropout with `seed0`."""
        x, valid = self.preprocess(features, train, generator)
        return self.postprocess(self.hstu(x, valid, features.timestamps, train, seed0, generator))

    def similarity_fn(
        self,
        query_embeddings: torch.Tensor,                  # (B', D)
        item_embeddings: torch.Tensor,                   # (1, X, D) or (B', X, D)
        user_ids: Optional[torch.Tensor] = None,
        train: bool = False,
        weights: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(B', X) scores + aux losses."""
        return self.mol(query_embeddings, item_embeddings, user_ids, train, weights, generator)

    def encode(self, features: SequentialFeatures) -> torch.Tensor:
        """[B, N] -> [B, D]: the state at the last valid position."""
        seq = self.encode_sequence(features)
        rows = torch.arange(seq.shape[0], device=seq.device)
        return seq[rows, features.lengths.long() - 1]

    def build_item_tables(self, item_embeddings: torch.Tensor) -> MoLItemTables:
        return self.mol.build_item_tables(item_embeddings)

    def score_precomputed(
        self, query_embeddings: torch.Tensor, item_tables: MoLItemTables,
        user_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self.mol.score_precomputed(query_embeddings, item_tables, user_ids)

    def score_gathered(
        self, query_embeddings: torch.Tensor, component_embeddings: torch.Tensor,
        gating_partial: torch.Tensor, user_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self.mol.score_gathered(query_embeddings, component_embeddings, gating_partial,
                                       user_ids)

    def query_components(
        self, query_embeddings: torch.Tensor, user_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return self.mol.query_components(query_embeddings, user_ids)

    def query_gating_partial(self, query_embeddings: torch.Tensor) -> torch.Tensor:
        return self.mol.query_gating_partial(query_embeddings)
