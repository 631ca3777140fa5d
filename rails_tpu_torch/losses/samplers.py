"""Negative samplers.

Counterpart of `rails_tpu/losses/samplers.py`: `maybe_l2_norm` (:24-26) and
`LocalNegativesSampler` (:29-49), which draws uniform offsets into the corpus
id list, here from an explicit `torch.Generator` on the ids' device. The
in-batch sampler is not ported: `train.loop` refuses its configuration.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from rails_tpu_torch.similarity.layers import l2_normalize


def maybe_l2_norm(x: torch.Tensor, l2_norm: bool, eps: float) -> torch.Tensor:
    return l2_normalize(x, eps) if l2_norm else x


class LocalNegativesSampler(NamedTuple):
    """Uniform sampling over the full corpus id list."""

    all_item_ids: torch.Tensor    # (num_items,) int32, actual item ids
    l2_norm: bool = False
    l2_norm_eps: float = 1e-6

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...]) -> torch.Tensor:
        offsets = torch.randint(0, self.all_item_ids.shape[0], shape, generator=generator,
                                device=self.all_item_ids.device)
        return self.all_item_ids[offsets]

