"""BCE autoregressive losses, dense-masked.

Counterpart of `rails_tpu/losses/bce.py:25-143`: `bce_loss`, one positive and
one sampled negative per position with a binary cross entropy on each and
accidental hits (negative == positive) taken out of the weights, and
`bce_loss_with_ratings`, the positive's logit against its rating. Positions
stay dense [B, N-1] with the weights of `sampled_softmax_loss`; the aux
losses come from the positives' similarity call. `generator` draws the
negatives and every dropout; `seed0` seeds the HSTU blocks' hash dropout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from rails_tpu_torch.core.distributed import draw_rows, global_sum
from rails_tpu_torch.data.features import SequentialFeatures
from rails_tpu_torch.losses.samplers import (
    InBatchNegativesSampler,
    in_batch_pool,
    maybe_l2_norm,
)
from rails_tpu_torch.models.preprocessors import length_mask

AuxLosses = Dict[str, torch.Tensor]


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(logits, targets, reduction="none")


def _positions(model, features: SequentialFeatures, train: bool,
               generator: Optional[torch.Generator], seed0: Optional[int]):
    """The dense positions both losses score: (input embeddings (B, N, D),
    queries (M, D), supervision ids (M,) and embeddings (M, 1, D), weights
    (M,), user ids (M,))."""
    ids = features.ids
    b, n = ids.shape
    d = model.cfg.train.item_embedding_dim
    m = b * (n - 1)
    input_embeddings = model.get_item_embeddings(ids)
    seq_embeddings = model.encode_sequence(features, train, generator, seed0)
    supervision_ids = ids[:, 1:]
    weights = ((supervision_ids != 0) & length_mask(features.lengths, n - 1)).float()
    return (input_embeddings, seq_embeddings[:, :-1, :].reshape(m, d),
            supervision_ids.reshape(m), input_embeddings[:, 1:, :].reshape(m, 1, d),
            weights.reshape(m), torch.repeat_interleave(features.user_ids, n - 1))


def bce_loss(
    model,
    features: SequentialFeatures,
    sampler,                                  # LocalNegativesSampler | InBatchNegativesSampler
    temperature: float = 1.0,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    seed0: Optional[int] = None,
) -> Tuple[torch.Tensor, AuxLosses]:
    """(scalar loss, aux losses) (`bce.py:35-101`)."""
    inputs, q, sup_ids, sup_emb, w, uids = _positions(model, features, train, generator, seed0)
    m = q.shape[0]
    if isinstance(sampler, InBatchNegativesSampler):
        flat_ids, flat_emb = in_batch_pool(model, features.ids, inputs)
        state = sampler.process_batch(flat_ids, flat_ids != 0, flat_emb)
        sampled_ids, neg_emb = draw_rows(lambda shape: sampler.sample(state, generator, shape),
                                         (m, 1))
    else:
        sampled_ids = draw_rows(lambda shape: sampler.sample(generator, shape), (m, 1))
        neg_emb = maybe_l2_norm(model.get_item_embeddings(sampled_ids), sampler.l2_norm,
                                sampler.l2_norm_eps)
    pos_logits, aux = model.similarity_fn(q, sup_emb, uids, train, w, generator)
    pos_logits = pos_logits[:, 0] / temperature
    neg_logits, _ = model.similarity_fn(q, neg_emb, uids, train, w, generator)
    neg_logits = neg_logits[:, 0] / temperature
    loss_weights = w * (sup_ids != sampled_ids[:, 0]).float()
    per_position = 0.5 * (_bce_with_logits(pos_logits, torch.ones_like(pos_logits))
                          + _bce_with_logits(neg_logits, torch.zeros_like(neg_logits)))
    loss = torch.sum(per_position * loss_weights) / torch.clamp(
        global_sum(torch.sum(loss_weights)), min=1e-12)
    return loss, aux


def bce_loss_with_ratings(
    model,
    features: SequentialFeatures,
    sampler=None,                             # unused; the losses share a signature
    temperature: float = 1.0,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    seed0: Optional[int] = None,
) -> Tuple[torch.Tensor, AuxLosses]:
    """BCE of each positive's logit against its rating as the target
    (`bce.py:104-143`; the ratings are cast to f32, not binarized)."""
    del sampler
    _, q, _, sup_emb, w, uids = _positions(model, features, train, generator, seed0)
    logits, aux = model.similarity_fn(q, sup_emb, uids, train, w, generator)
    logits = logits[:, 0] / temperature
    targets = features.ratings[:, 1:].reshape(-1).float()
    per_position = _bce_with_logits(logits, targets.to(logits.dtype))
    loss = torch.sum(per_position * w) / torch.clamp(global_sum(torch.sum(w)), min=1e-12)
    return loss, aux
