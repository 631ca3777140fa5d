"""Sampled-softmax autoregressive loss, dense-masked.

Counterpart of `rails_tpu/losses/sampled_softmax.py`: the per-position path
of `sampled_softmax_loss` (:84-259) with the local sampler, and
`get_weighted_loss` (:262-271). All positions stay dense [B, N-1]: queries
are the encoder outputs at positions [0, N-2], supervision the ids at
[1, N-1], weighted 1 where the position is inside the history and the id is
not padding. Each position draws its own R negatives; a negative equal to the
positive id is masked to -5e4. The loss is the weighted mean of
-log_softmax([pos, negs])[0], and the aux losses come from the positives'
similarity call only, as in the JAX package.

Not ported (NotImplementedError naming ROADMAP.md): `shared_negatives` and
`fused_mol_loss` (the K5 slice), `activation_checkpoint`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.losses.samplers import LocalNegativesSampler, maybe_l2_norm
from rails_tpu_torch.models.preprocessors import length_mask

AuxLosses = Dict[str, torch.Tensor]


def sampled_softmax_loss(
    model,                                   # SequentialRecommender
    features: SequentialFeatures,            # target already scattered at [len]
    sampler: LocalNegativesSampler,
    num_negatives: int,
    softmax_temperature: float,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    seed0: Optional[int] = None,
    activation_checkpoint: bool = False,
    shared_negatives: bool = False,
) -> Tuple[torch.Tensor, AuxLosses]:
    """(scalar loss, aux losses). `generator` draws the negatives and every
    dropout; `seed0` seeds the HSTU blocks' hash dropout."""
    if shared_negatives:
        raise NotImplementedError(
            "shared_negatives (and the fused MoL loss, K5) are not ported "
            "(ROADMAP.md, Queue 1: the -fast variant)"
        )
    if activation_checkpoint:
        raise NotImplementedError(
            "loss_activation_checkpoint is not ported (ROADMAP.md, Queue 1: losses)"
        )
    if not isinstance(sampler, LocalNegativesSampler):
        raise NotImplementedError(
            f"sampler {type(sampler).__name__} is not ported (ROADMAP.md, Queue 1: losses)"
        )
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

    sampled_ids = sampler.sample(generator, (m, num_negatives))
    sampled_neg_embeddings = maybe_l2_norm(
        model.get_item_embeddings(sampled_ids), sampler.l2_norm, sampler.l2_norm_eps)
    pos_embeddings = maybe_l2_norm(
        input_embeddings[:, 1:, :].reshape(m, d), sampler.l2_norm, sampler.l2_norm_eps)

    positive_logits, aux_losses = model.similarity_fn(
        q, pos_embeddings[:, None, :], user_ids_flat, train, w_flat, generator)
    positive_logits = positive_logits / softmax_temperature                 # (M, 1)
    negative_logits, _ = model.similarity_fn(
        q, sampled_neg_embeddings, user_ids_flat, train, w_flat, generator)
    negative_logits = torch.where(
        sup_ids_flat[:, None] == sampled_ids,
        torch.full((), -5e4, dtype=negative_logits.dtype, device=negative_logits.device),
        negative_logits / softmax_temperature,
    )                                                                       # (M, R)
    all_logits = torch.cat([positive_logits, negative_logits], dim=1)
    per_position = -torch.log_softmax(all_logits, dim=1)[:, 0]
    loss = torch.sum(per_position * w_flat) / torch.clamp(torch.sum(w_flat), min=1e-12)
    return loss, aux_losses


def get_weighted_loss(
    main_loss: torch.Tensor, aux_losses: AuxLosses, weights: Mapping[str, float]
) -> torch.Tensor:
    """main_loss + sum_k aux_losses[k] * weights[k] (`get_weighted_loss`)."""
    total = main_loss
    for key, weight in weights.items():
        total = total + aux_losses[key] * weight
    return total
