"""Sequential batch features as torch int32 tensors.

Counterpart of `rails_tpu/data/features.py:18-96`: the same fields, the same
generative-output padding and the same timestamp rebase, with torch tensors
on the card (or the CPU where a caller asks) in place of jnp arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from rails_tpu_torch.core.device import resolve_device

Device = Optional[Union[str, torch.device]]


class SequentialFeatures(NamedTuple):
    lengths: torch.Tensor       # (B,) int32, > 0
    ids: torch.Tensor           # (B, N) int32, 0 = padding
    timestamps: torch.Tensor    # (B, N) int32
    ratings: torch.Tensor       # (B, N) int32
    user_ids: torch.Tensor      # (B,) int32


class Batch(NamedTuple):
    features: SequentialFeatures
    target_ids: torch.Tensor       # (B,) int32
    target_ratings: torch.Tensor   # (B,) int32


def truncate_features(features: SequentialFeatures, n: int) -> SequentialFeatures:
    """Serve-time truncation of the padded sequence axis to n columns
    (`features.py:32-47`). Valid when every row has length + 1 <= n: the +1
    keeps the next-item timestamp slot that the HSTU time bias reads."""
    return features._replace(
        ids=features.ids[:, :n],
        timestamps=features.timestamps[:, :n],
        ratings=features.ratings[:, :n],
    )


def serving_pad_length(max_length: int, multiple: int = 64) -> int:
    """Smallest multiple of `multiple` covering max_length + 1."""
    need = max_length + 1
    return ((need + multiple - 1) // multiple) * multiple


def _int32(a: np.ndarray, device: Device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def batch_from_rows(
    historical_lengths: np.ndarray,     # (B,)
    historical_ids: np.ndarray,         # (B, max_seq_len)
    historical_ratings: np.ndarray,
    historical_timestamps: np.ndarray,
    target_ids: np.ndarray,             # (B,)
    target_ratings: np.ndarray,
    target_timestamps: np.ndarray,
    user_ids: np.ndarray,
    max_output_length: int,
    device: Device = None,
) -> Batch:
    """Pads `max_output_length` slots and scatters the target timestamp at
    position `length` (`features.py:56-96`). The tensors lie on `device`:
    the card unless the caller passes "cpu"."""
    device = resolve_device(device)
    b, _ = historical_ids.shape
    pad = np.zeros((b, max_output_length), dtype=historical_ids.dtype)
    ids = np.concatenate([historical_ids, pad], axis=1)
    ratings = np.concatenate([historical_ratings, pad], axis=1)
    ts = np.concatenate(
        [historical_timestamps.astype(np.int64), pad.astype(np.int64)], axis=1
    )
    ts[np.arange(b), historical_lengths] = target_timestamps
    # Rebase to the batch minimum before narrowing to int32 (`features.py:77-84`):
    # only within-sequence deltas reach the model. Padding slots stay 0.
    valid = ts > 0
    if valid.any():
        base = ts[valid].min() - 1
        ts = np.where(valid, ts - base, 0)
    feats = SequentialFeatures(
        lengths=_int32(historical_lengths, device),
        ids=_int32(ids, device),
        timestamps=_int32(ts, device),
        ratings=_int32(ratings, device),
        user_ids=_int32(user_ids, device),
    )
    return Batch(
        features=feats,
        target_ids=_int32(target_ids, device),
        target_ratings=_int32(target_ratings, device),
    )
