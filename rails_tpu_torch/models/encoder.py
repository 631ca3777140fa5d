"""Top-level sequential recommender: embedding -> input preprocessor ->
encoder stack -> output norm, owning the similarity.

Counterpart of `rails_tpu/models/encoder.py` (`SequentialRecommender`). It
dispatches as JAX does (:46-138) on `embedding_module_type` (the local table,
its gather's backward through K6 with `train.pallas_scatter_grad`, or the
categorical one), `input_preprocessor_type` (positional; rated, of width
D + rating_embedding_dim; combined, of length 2N), `model_type` (the HSTU
stack at the preprocessor's width and length, or SASRec) and
`similarity_type` (MoL or DotProduct): `encode_sequence` (:167-202, eval
and training; HSTU reads the length mask, SASRec `ids != 0`, which includes
the scattered target slot; the combined preprocessor's timestamps are
repeated twice and its output kept at y[:, 1::2]), `encode`,
`get_item_embeddings`, `similarity_fn` (:255-267) and the MoL-only
`build_item_tables`, `query_components`, `query_gating_partial`,
`score_precomputed` and `score_gathered` (:284-294), which a DotProduct
model refuses. Parameter names follow the flax tree (`item_emb.embedding`,
`input_preproc.pos_emb`, `hstu.block_3.uvqk`, `sasrec.block_0.q_proj.weight`,
`mol.gating_qi.hidden.weight`, ...), so
`compat.from_jax.state_dict_from_jax_params` loads a JAX model strictly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from rails_tpu_torch.core.config import ExperimentConfig
from rails_tpu_torch.core.device import resolve_device
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.models.embedding import CategoricalEmbeddingModule, LocalEmbeddingModule
from rails_tpu_torch.models.hstu import HSTUStack
from rails_tpu_torch.models.preprocessors import (
    CombinedItemAndRatingInputPreprocessor,
    LearnablePositionalEmbeddingInputPreprocessor,
    LearnablePositionalEmbeddingRatedInputPreprocessor,
    length_mask,
    postprocess_output,
)
from rails_tpu_torch.models.sasrec import SASRecStack
from rails_tpu_torch.similarity.dot_product import DotProductSimilarity
from rails_tpu_torch.similarity.mol import MoLItemTables, MoLSimilarity


class SequentialRecommender(nn.Module):
    """HSTU or SASRec encoder + MoL or DotProduct similarity.

    `compute_dtype` plays the role of the flax model's `dtype` (bf16 when the
    config sets `main_module_bf16` or MoL `bf16_training`); parameters stay
    float32. Weights are drawn from `generator` on the CPU (seeded from
    `cfg.train.random_seed` when none is given) and then moved to `device`
    (the card unless the caller passes "cpu"), so one seed gives the same
    model on every device. `item_id_to_category_id` (max_item_id,) is
    required by the categorical embedding, as in JAX.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        num_items: int,
        compute_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
        item_id_to_category_id: Optional[np.ndarray] = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.train.random_seed)
        self.cfg = cfg
        self.num_items = num_items
        self.compute_dtype = compute_dtype
        g, dt = generator, compute_dtype
        d = cfg.train.item_embedding_dim
        n = cfg.max_seq_len_padded
        scatter = cfg.train.pallas_scatter_grad
        if cfg.embedding_module_type == "local":
            self.item_emb = LocalEmbeddingModule(num_items, d, g, scatter_grad_kernel=scatter)
        elif cfg.embedding_module_type == "categorical":
            if item_id_to_category_id is None:
                raise ValueError("embedding_module_type='categorical' requires an "
                                 "item_id_to_category_id array")
            if cfg.num_item_categories <= 0:
                raise ValueError("embedding_module_type='categorical' requires "
                                 "num_item_categories > 0")
            self.item_emb = CategoricalEmbeddingModule(
                cfg.num_item_categories, d, item_id_to_category_id, g, scatter_grad_kernel=scatter)
        else:
            raise ValueError(f"Unknown embedding_module_type {cfg.embedding_module_type!r}")
        rate = cfg.train.dropout_rate
        # d_model is the encoder's width, n_enc its sequence length.
        if cfg.input_preprocessor_type == "positional":
            self.input_preproc = LearnablePositionalEmbeddingInputPreprocessor(n, d, dt, g, rate)
            d_model, n_enc = d, n
        elif cfg.input_preprocessor_type == "rated":
            self.input_preproc = LearnablePositionalEmbeddingRatedInputPreprocessor(
                n, d, cfg.rating_embedding_dim, cfg.num_ratings, dt, g, rate)
            d_model, n_enc = d + cfg.rating_embedding_dim, n
        elif cfg.input_preprocessor_type == "combined":
            self.input_preproc = CombinedItemAndRatingInputPreprocessor(
                2 * n, d, d, cfg.num_ratings, dt, g, rate)
            d_model, n_enc = d, 2 * n
        else:
            raise ValueError(f"Unknown input_preprocessor_type {cfg.input_preprocessor_type!r}")
        if cfg.model_type == "HSTU":
            hstu_cfg = (cfg.hstu if cfg.hstu.embedding_dim == d_model
                        else cfg.hstu.replace(embedding_dim=d_model))
            self.hstu = HSTUStack(hstu_cfg, n_enc, dt, g)
        elif cfg.model_type == "SASRec":
            sasrec_cfg = (cfg.sasrec if cfg.sasrec.embedding_dim == d_model
                          else cfg.sasrec.replace(embedding_dim=d_model))
            self.sasrec = SASRecStack(sasrec_cfg, dt, g)
        else:
            raise ValueError(f"Unknown model_type {cfg.model_type!r}")
        if cfg.similarity_type == "MoL":
            self.mol = MoLSimilarity(cfg.mol, dt, g)
        elif cfg.similarity_type == "DotProduct":
            self.dp = DotProductSimilarity(dt)
        else:
            raise ValueError(f"Unknown similarity_type {cfg.similarity_type!r}")
        self.d_model, self.n_enc = d_model, n_enc
        self.to(resolve_device(device))

    @property
    def similarity(self) -> nn.Module:
        return self.mol if self.cfg.similarity_type == "MoL" else self.dp

    def _mol(self, what: str) -> MoLSimilarity:
        if self.cfg.similarity_type != "MoL":
            raise TypeError(f"{what} needs the MoL similarity; {self.cfg.name} scores by "
                            f"{self.cfg.similarity_type} and serves through MIPSBruteForceTopK")
        return self.mol

    def get_item_embeddings(self, item_ids: torch.Tensor) -> torch.Tensor:
        return self.item_emb(item_ids)

    def preprocess(
        self, features: SequentialFeatures, train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
        """Embedding lookup + the configured input preprocessor: (x (B, N_enc,
        D_model) in the compute dtype, the encoder's lengths, its timestamps,
        stride), stride 2 for the combined preprocessor's interleave and 1
        otherwise (`encoder.py:147-163`)."""
        emb = self.item_emb(features.ids).to(self.compute_dtype)
        kind = self.cfg.input_preprocessor_type
        if kind == "positional":
            x, _ = self.input_preproc(features.lengths, emb, train, generator)
            return x, features.lengths, features.timestamps, 1
        if kind == "rated":
            x, _ = self.input_preproc(features.lengths, emb, features.ratings, train, generator)
            return x, features.lengths, features.timestamps, 1
        x, _, enc_lengths = self.input_preproc(features.lengths, emb, features.ratings, train,
                                               generator)
        return x, enc_lengths, features.timestamps.repeat_interleave(2, dim=1), 2

    def postprocess(self, y: torch.Tensor) -> torch.Tensor:
        t = self.cfg.train
        return postprocess_output(y.float(), t.user_embedding_norm, t.item_embedding_dim)

    def encode_sequence(
        self, features: SequentialFeatures, train: bool = False,
        generator: Optional[torch.Generator] = None, seed0: Optional[int] = None,
    ) -> torch.Tensor:
        """[B, N] -> [B, N, D]. Training draws the input dropout (and the XLA
        block path's and SASRec's dropouts) from `generator` and seeds the
        fused HSTU blocks' hash dropout with `seed0`."""
        x, enc_lengths, ts, stride = self.preprocess(features, train, generator)
        if self.cfg.model_type == "HSTU":
            valid = length_mask(enc_lengths, x.shape[1])
            x = x * valid[..., None].to(x.dtype)
            y = self.hstu(x, valid, ts, train, seed0, generator)
        else:
            valid = features.ids != 0
            if stride == 2:
                valid = valid.repeat_interleave(2, dim=1)
            y = self.sasrec(x, valid, ts, train, generator)
        y = self.postprocess(y)
        # The combined preprocessor's post-rating state is the output of
        # each original position.
        return y[:, 1::2] if stride == 2 else y

    def encode_prefill(self, features: SequentialFeatures):
        """The eval encode through the XLA block path, also returning each
        HSTU block's (k, v) cache (`encoder.py:209-229`): ((B, D) states at
        the last valid position, cache). HSTU with the positional
        preprocessor only, as in JAX."""
        self._check_decode()
        emb = self.item_emb(features.ids).to(self.compute_dtype)
        x, _ = self.input_preproc(features.lengths, emb)
        valid = length_mask(features.lengths, x.shape[1])
        x = x * valid[..., None].to(x.dtype)
        y, cache = self.hstu.prefill(x, valid, features.timestamps)
        seq = self.postprocess(y)
        rows = torch.arange(seq.shape[0], device=seq.device)
        return seq[rows, features.lengths.long() - 1], cache

    def decode_step(self, new_ids: torch.Tensor, features: SequentialFeatures, cache):
        """Append one item per row at position `features.lengths` (its
        timestamp already at that slot) and return ((B, D) new states, cache)
        (`encoder.py:231-251`)."""
        self._check_decode()
        position = features.lengths
        x_t = self.input_preproc.at_position(
            self.item_emb(new_ids).to(self.compute_dtype), position)
        y_t, cache = self.hstu.decode_step(x_t, cache, position, features.timestamps)
        return self.postprocess(y_t), cache

    def _check_decode(self) -> None:
        if self.cfg.model_type != "HSTU":
            raise NotImplementedError("incremental decode is HSTU-only")
        if self.cfg.input_preprocessor_type != "positional":
            raise NotImplementedError("incremental decode supports the positional preprocessor "
                                      "only")

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
        return self.similarity(query_embeddings, item_embeddings, user_ids, train, weights,
                               generator)

    def encode(self, features: SequentialFeatures) -> torch.Tensor:
        """[B, N] -> [B, D]: the state at the last valid position."""
        seq = self.encode_sequence(features)
        rows = torch.arange(seq.shape[0], device=seq.device)
        return seq[rows, features.lengths.long() - 1]

    def build_item_tables(self, item_embeddings: torch.Tensor) -> MoLItemTables:
        return self._mol("build_item_tables").build_item_tables(item_embeddings)

    def score_precomputed(
        self, query_embeddings: torch.Tensor, item_tables: MoLItemTables,
        user_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self._mol("score_precomputed").score_precomputed(query_embeddings, item_tables,
                                                                user_ids)

    def score_gathered(
        self, query_embeddings: torch.Tensor, component_embeddings: torch.Tensor,
        gating_partial: Optional[torch.Tensor], user_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self._mol("score_gathered").score_gathered(
            query_embeddings, component_embeddings, gating_partial, user_ids)

    def query_components(
        self, query_embeddings: torch.Tensor, user_ids: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return self._mol("query_components").query_components(query_embeddings, user_ids)

    def query_gating_partial(self, query_embeddings: torch.Tensor) -> Optional[torch.Tensor]:
        return self._mol("query_gating_partial").query_gating_partial(query_embeddings)
