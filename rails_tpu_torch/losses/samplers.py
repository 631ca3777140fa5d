"""Negative samplers.

Counterpart of `rails_tpu/losses/samplers.py`: `maybe_l2_norm` (:24-26) and
`LocalNegativesSampler` (:29-49), which draws uniform offsets into the corpus
id list, here from an explicit `torch.Generator` on the ids' device, and
`InBatchNegativesSampler` (:59-122): `process_batch` dedups the batch's ids
by a sort and a first-occurrence mask into `cum_unique` / `num_unique`, and
`sample` draws by the inverse CDF over that count, its uniforms from the
generator (`sample_from_uniforms` takes them given).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from rails_tpu_torch.core.distributed import current_row_shard
from rails_tpu_torch.similarity.layers import l2_normalize


def maybe_l2_norm(x: torch.Tensor, l2_norm: bool, eps: float) -> torch.Tensor:
    return l2_normalize(x, eps) if l2_norm else x


_INT32_MAX = 2 ** 31 - 1


class LocalNegativesSampler(NamedTuple):
    """Uniform sampling over the full corpus id list."""

    all_item_ids: torch.Tensor    # (num_items,) int32, actual item ids
    l2_norm: bool = False
    l2_norm_eps: float = 1e-6

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
        offsets = torch.randint(0, self.all_item_ids.shape[0], shape, generator=generator,
                                device=self.all_item_ids.device)
        return self.all_item_ids[offsets]



class InBatchState(NamedTuple):
    """A processed batch: ids sorted ascending with the invalid ones last,
    their embeddings in that order, and the inclusive count of unique ids."""

    sorted_ids: torch.Tensor         # (M,) int32
    sorted_embeddings: torch.Tensor  # (M, D)
    cum_unique: torch.Tensor         # (M,) int32
    num_unique: torch.Tensor         # () int32


class InBatchNegativesSampler(NamedTuple):
    """Negatives drawn uniformly from the batch's own (deduplicated) ids."""

    l2_norm: bool = False
    l2_norm_eps: float = 1e-6

    def process_batch(self, ids: torch.Tensor, presences: torch.Tensor,
                      embeddings: torch.Tensor) -> InBatchState:
        """ids (M,), presences (M,) bool, embeddings (M, D)."""
        key = torch.where(presences, ids.to(torch.int32),
                          torch.full((), _INT32_MAX, dtype=torch.int32, device=ids.device))
        order = torch.argsort(key, stable=True)
        sorted_ids = ids.to(torch.int32)[order]
        sorted_valid = presences[order]
        sorted_emb = maybe_l2_norm(embeddings[order], self.l2_norm, self.l2_norm_eps)
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                           sorted_ids[1:] != sorted_ids[:-1]]) & sorted_valid
        cum = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32)
        return InBatchState(sorted_ids, sorted_emb, cum, cum[-1])

    def sample(self, state: InBatchState, generator: torch.Generator,
               shape: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, embeddings) of `shape` drawn uniformly over the unique pool."""
        u = torch.rand(shape, generator=generator, device=state.cum_unique.device)
        return self.sample_from_uniforms(state, u)

    @staticmethod
    def sample_from_uniforms(state: InBatchState, u: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The inverse-CDF draw of `sample` from given uniforms in [0, 1):
        unique rank floor(u * num_unique) + 1, found in `cum_unique`."""
        rank = torch.floor(u * state.num_unique).to(torch.int32) + 1
        pos = torch.searchsorted(state.cum_unique, rank.reshape(-1), side="left")
        pos = pos.clamp(0, state.sorted_ids.shape[0] - 1).reshape(u.shape)
        return state.sorted_ids[pos], state.sorted_embeddings[pos]


def global_batch_ids(ids: torch.Tensor) -> torch.Tensor:
    """(B, N) ids of this rank, or under a row shard the global batch's
    (B_total, N) ids, all-gathered in rank order."""
    s = current_row_shard()
    if s is None or s.total == s.rows:
        return ids
    parts = [torch.empty_like(ids) for _ in range(dist.get_world_size(s.group))]
    dist.all_gather(parts, ids.contiguous(), group=s.group)
    return torch.cat(parts, dim=0)


def in_batch_pool(model, ids: torch.Tensor, input_embeddings: torch.Tensor):
    """The in-batch sampler's flat ids and embeddings: this batch's, or a
    data-parallel rank's view of the global batch's, whose embeddings it
    looks up itself (their gradients reach its own table and sum over the
    ranks with the rest)."""
    b, n, d = input_embeddings.shape
    all_ids = global_batch_ids(ids)
    if all_ids is ids:
        return ids.reshape(-1), input_embeddings.reshape(b * n, d)
    return all_ids.reshape(-1), model.get_item_embeddings(all_ids).reshape(-1, d)

