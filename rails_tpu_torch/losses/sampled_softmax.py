"""Sampled-softmax autoregressive loss, dense-masked.

Counterpart of `rails_tpu/losses/sampled_softmax.py`: `sampled_softmax_loss`
(:84-259) with the local and the in-batch samplers, its fused
shared-negatives route
`_fused_negative_logits` (:30-81), and `get_weighted_loss` (:262-271). All
positions stay dense [B, N-1]: queries are the encoder outputs at positions
[0, N-2], supervision the ids at [1, N-1], weighted 1 where the position is
inside the history and the id is not padding. Each position draws its own R
negatives, or with `shared_negatives` one (R,) set serves the whole batch; a
negative equal to the positive id is masked to -5e4. The loss is the weighted
mean of -log_softmax([pos, negs])[0], and the aux losses come from the
positives' similarity call only, as in the JAX package.

The in-batch sampler draws each position's R negatives from the batch's
own deduplicated ids and their already-gathered embeddings (:148-171); it
always samples per position, and `shared_negatives` only logs a warning, as
in JAX.

With shared negatives, `train.fused_mol_loss` and the published MoL shape
(glu_silu, both gating partials, a hidden qi MLP) the negatives are scored by
K5 (`ops.mol_loss_train.fused_mol_loss`), under the same gate as the JAX
package (:190-200); otherwise through the similarity's shared-corpus einsum.
`activation_checkpoint` on that non-fused route, the only one where JAX
reads it (:205-235), scores the negatives in CHECKPOINT_CHUNKS chunks of
positions under `torch.utils.checkpoint`, so the backward recomputes each
chunk's (rows, R, L) logits and gating activations instead of keeping them.
Each chunk's dropouts draw from a generator seeded once per chunk from the
caller's, so the recomputation draws the same masks.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from rails_tpu_torch.core.distributed import (
    RowShard,
    current_row_shard,
    draw_rows,
    global_sum,
    replicated_rows,
    row_shard,
    row_span,
)
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.losses.samplers import (
    InBatchNegativesSampler,
    LocalNegativesSampler,
    in_batch_pool,
    maybe_l2_norm,
)
from rails_tpu_torch.models.preprocessors import length_mask
from rails_tpu_torch.ops.mol_loss_train import fused_mol_loss
from rails_tpu_torch.ops.mol_scoring import extract_gating_qi_weights

AuxLosses = Dict[str, torch.Tensor]
_INT32_MAX = 2 ** 31 - 1
# Chunks of positions of the checkpointed negatives' scoring (JAX's
# `checkpoint_chunks` default, which no caller changes).
CHECKPOINT_CHUNKS = 4


def _fused_ok(model, sampler, train: bool, shared_negatives: bool) -> bool:
    """The JAX package's gate of the fused route (`sampled_softmax.py:190-200`)."""
    cfg, c = model.cfg, model.cfg.mol
    return bool(
        train and shared_negatives and cfg.train.fused_mol_loss
        and cfg.similarity_type == "MoL" and c.gating_combination_type == "glu_silu"
        and c.gating_query_fn and c.gating_item_fn and c.gating_qi_hidden_dim > 0
        and isinstance(sampler, LocalNegativesSampler)
    )


def _fused_negative_logits(
    model, q: torch.Tensor, user_ids_flat: torch.Tensor, w_flat: torch.Tensor,
    sampled_neg_embeddings: torch.Tensor, generator: Optional[torch.Generator],
) -> torch.Tensor:
    """(M, R) shared-negative MoL scores through K5. The component MLPs, the
    gating partials and their dropouts run in torch (M query rows and R item
    rows); the (M, R, L / H) gating pipeline runs in the kernel, forward and
    backward. The K5 hash seed is an int32 from `generator` when either rate
    is > 0, else 0 (`sampled_softmax.py:59-68`)."""
    sim = model.mol
    c = model.cfg.mol
    q_comp, _ = sim.query_components_aux(q, user_ids_flat, True, w_flat, generator)
    qp = sim.query_gating_partial(q)                                        # (M, L)
    with replicated_rows():   # the shared negatives: every rank's whole set
        i_comp = sim.item_components(sampled_neg_embeddings, True, generator)   # (R, P_X, d_P)
        ip = sim.item_gating_partial(sampled_neg_embeddings, True, generator)   # (R, L)
    w = extract_gating_qi_weights(sim)
    seed = 0
    if c.softmax_dropout_rate > 0.0 or c.gating_qi_dropout_rate > 0.0:
        seed = int(torch.randint(0, _INT32_MAX, (1,), generator=generator,
                                 device=generator.device).item())
    dt = i_comp.dtype
    return fused_mol_loss(
        q_comp.to(dt), qp.to(dt), i_comp, ip.to(dt), w.w1, w.b1[None], w.w2, w.b2[None], seed,
        p_q=c.query_dot_product_groups, p_x=c.item_dot_product_groups,
        temperature=c.temperature, qi_rate=c.gating_qi_dropout_rate,
        pi_rate=c.softmax_dropout_rate, eps=c.eps, rows=row_span(q.shape[0]),
    )


def _checkpointed_negative_logits(
    model, q: torch.Tensor, neg_embeddings: torch.Tensor, user_ids_flat: torch.Tensor,
    generator: Optional[torch.Generator], chunks: int,
) -> torch.Tensor:
    """(M, R) negative scores in `chunks` chunks of positions, each under
    `torch.utils.checkpoint` (`sampled_softmax.py:205-235`); (R, D) shared or
    (M, R, D) per-position negatives. The chunks pass no row weights: they
    would shape only the aux losses, which come from the positives' call.
    A data-parallel rank cuts the global batch's positions into the chunks
    and draws every chunk's seed, and scores its rows of each chunk as that
    chunk's row shard."""
    m = q.shape[0]
    off, total = row_span(m)
    group = None if current_row_shard() is None else current_row_shard().group
    size = -(-total // chunks)
    parts = []
    for s in range(0, total, size):
        e = min(s + size, total)
        seed = None if generator is None else int(torch.randint(
            0, _INT32_MAX, (1,), generator=generator, device=generator.device).item())
        lo, hi = max(s, off), min(e, off + m)
        if lo >= hi:
            continue
        neg = (neg_embeddings[None] if neg_embeddings.ndim == 2
               else neg_embeddings[lo - off : hi - off])
        shard = None if total == m else RowShard(lo - s, hi - lo, e - s, group)
        parts.append(checkpoint(_negative_chunk, model, q[lo - off : hi - off], neg,
                                user_ids_flat[lo - off : hi - off], seed, shard,
                                use_reentrant=False))
    return torch.cat(parts, dim=0)


def _negative_chunk(model, q: torch.Tensor, neg: torch.Tensor, user_ids: torch.Tensor,
                    seed: Optional[int], shard: Optional[RowShard]) -> torch.Tensor:
    generator = None if seed is None else torch.Generator(q.device).manual_seed(seed)
    with row_shard(shard):
        return model.similarity_fn(q, neg, user_ids, True, None, generator)[0]


def sampled_softmax_loss(
    model,                                   # SequentialRecommender
    features: SequentialFeatures,            # target already scattered at [len]
    sampler,                                 # LocalNegativesSampler | InBatchNegativesSampler
    num_negatives: int,
    softmax_temperature: float,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    seed0: Optional[int] = None,
    activation_checkpoint: bool = False,
    shared_negatives: bool = False,
) -> Tuple[torch.Tensor, AuxLosses]:
    """(scalar loss, aux losses). `generator` draws the negatives and every
    dropout; `seed0` seeds the HSTU blocks' hash dropout. Under a
    data-parallel row shard (`core.distributed.row_shard`) the loss and the
    aux losses are this rank's terms of the global batch's, whose sum over
    the ranks is the global batch's value."""
    if not isinstance(sampler, (LocalNegativesSampler, InBatchNegativesSampler)):
        raise TypeError(f"Unknown sampler {type(sampler)}")
    ids = features.ids
    b, n = ids.shape
    d = model.cfg.train.item_embedding_dim
    input_embeddings = model.get_item_embeddings(ids)                       # (B, N, D)
    seq_embeddings = model.encode_sequence(features, train, generator, seed0)

    m = b * (n - 1)
    q = seq_embeddings[:, :-1, :].reshape(m, d)
    supervision_ids = ids[:, 1:]
    weights = ((supervision_ids != 0) & length_mask(features.lengths, n - 1)).float()
    w_flat = weights.reshape(m)
    sup_ids_flat = supervision_ids.reshape(m)
    user_ids_flat = torch.repeat_interleave(features.user_ids, n - 1)

    if isinstance(sampler, LocalNegativesSampler):
        # One (R,) set for the batch, or (M, R) per position.
        if shared_negatives:
            sampled_ids = sampler.sample(generator, (num_negatives,))
        else:
            sampled_ids = draw_rows(lambda shape: sampler.sample(generator, shape),
                                    (m, num_negatives))
        sampled_neg_embeddings = maybe_l2_norm(
            model.get_item_embeddings(sampled_ids), sampler.l2_norm, sampler.l2_norm_eps)
    else:
        if shared_negatives:
            logging.getLogger("rails_tpu_torch").warning(
                "train.shared_negatives=True has no effect with the in-batch sampler; "
                "sampling per position")
        # The target-scattered ids and their already-gathered embeddings
        # (a data-parallel rank: the global batch's, `global_batch_ids`).
        flat_ids, flat_emb = in_batch_pool(model, ids, input_embeddings)
        state = sampler.process_batch(flat_ids, flat_ids != 0, flat_emb)
        sampled_ids, sampled_neg_embeddings = draw_rows(
            lambda shape: sampler.sample(state, generator, shape), (m, num_negatives))
        shared_negatives = False
    pos_embeddings = maybe_l2_norm(
        input_embeddings[:, 1:, :].reshape(m, d), sampler.l2_norm, sampler.l2_norm_eps)

    positive_logits, aux_losses = model.similarity_fn(
        q, pos_embeddings[:, None, :], user_ids_flat, train, w_flat, generator)
    positive_logits = positive_logits / softmax_temperature                 # (M, 1)
    if _fused_ok(model, sampler, train, shared_negatives):
        negative_logits = _fused_negative_logits(
            model, q, user_ids_flat, w_flat, sampled_neg_embeddings, generator)
    elif activation_checkpoint and train:
        negative_logits = _checkpointed_negative_logits(
            model, q, sampled_neg_embeddings, user_ids_flat, generator, CHECKPOINT_CHUNKS)
    else:
        # (M, R, D) per position, or (1, R, D): the shared-corpus einsum.
        negative_logits, _ = model.similarity_fn(
            q, sampled_neg_embeddings[None] if shared_negatives else sampled_neg_embeddings,
            user_ids_flat, train, w_flat, generator)
    # (M, 1) against (R,) shared, or (M, R) per position.
    negative_logits = torch.where(
        sup_ids_flat[:, None] == sampled_ids,
        torch.full((), -5e4, dtype=negative_logits.dtype, device=negative_logits.device),
        negative_logits / softmax_temperature,
    )                                                                       # (M, R)
    all_logits = torch.cat([positive_logits, negative_logits], dim=1)
    per_position = -torch.log_softmax(all_logits, dim=1)[:, 0]
    loss = torch.sum(per_position * w_flat) / torch.clamp(global_sum(torch.sum(w_flat)),
                                                          min=1e-12)
    return loss, aux_losses


def get_weighted_loss(
    main_loss: torch.Tensor, aux_losses: AuxLosses, weights: Mapping[str, float]
) -> torch.Tensor:
    """main_loss + sum_k aux_losses[k] * weights[k] (`get_weighted_loss`)."""
    total = main_loss
    for key, weight in weights.items():
        total = total + aux_losses[key] * weight
    return total
