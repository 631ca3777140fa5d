"""Host-side datasets: ragged user sequences -> fixed-shape torch batches.

The numpy parts of `rails_tpu/data/datasets.py`, copied because that module
imports the jax-backed batch type: `RaggedSequences` (:29), the leave-one-out
`SequenceDataset` with its `batches` (:141-195), and the synthetic
ML-20M-shaped generator (:281-360). Positional subsampling and per-host
sharding (training only) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from rails_tpu_torch.data.features import Batch, Device, batch_from_rows


@dataclass
class RaggedSequences:
    """Flat ragged storage of chronological per-user event sequences."""

    user_ids: np.ndarray     # (U,) int32
    offsets: np.ndarray      # (U+1,) int64
    item_ids: np.ndarray     # (total,) int32
    ratings: np.ndarray      # (total,) int32
    timestamps: np.ndarray   # (total,) int64

    @property
    def num_users(self) -> int:
        return len(self.user_ids)

    def sequence(self, u: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s, e = self.offsets[u], self.offsets[u + 1]
        return self.item_ids[s:e], self.ratings[s:e], self.timestamps[s:e]


class SequenceDataset:
    """Leave-one-out view over RaggedSequences (`datasets.py:47-195`)."""

    def __init__(
        self, sequences: RaggedSequences, max_sequence_length: int, ignore_last_n: int
    ) -> None:
        self._seqs = sequences
        self._max_seq_len = max_sequence_length
        self._ignore_last_n = ignore_last_n
        # Users must keep >= 2 events (1 history + 1 target) after trimming.
        lens = np.diff(sequences.offsets) - ignore_last_n
        self._valid_users = np.nonzero(lens >= 2)[0]

    def __len__(self) -> int:
        return len(self._valid_users)

    def lengths_of(self, indices: np.ndarray) -> np.ndarray:
        """History lengths (post-trim, pre-padding) of example indices."""
        u = self._valid_users[np.asarray(indices)]
        raw = np.diff(self._seqs.offsets)[u] - self._ignore_last_n - 1
        return np.minimum(raw, self._max_seq_len).astype(np.int32)

    def rows(self, indices: np.ndarray):
        """Fixed-shape host arrays for a batch of example indices."""
        n = self._max_seq_len
        b = len(indices)
        hist_ids = np.zeros((b, n), dtype=np.int32)
        hist_ratings = np.zeros((b, n), dtype=np.int32)
        hist_ts = np.zeros((b, n), dtype=np.int64)
        lengths = np.zeros((b,), dtype=np.int32)
        tgt_ids = np.zeros((b,), dtype=np.int32)
        tgt_ratings = np.zeros((b,), dtype=np.int32)
        tgt_ts = np.zeros((b,), dtype=np.int64)
        user_ids = np.zeros((b,), dtype=np.int32)
        for row, idx in enumerate(indices):
            u = self._valid_users[idx]
            ids, ratings, ts = self._seqs.sequence(u)
            if self._ignore_last_n > 0:
                ids = ids[: -self._ignore_last_n]
                ratings = ratings[: -self._ignore_last_n]
                ts = ts[: -self._ignore_last_n]
            # The target is the final event; the history is everything before
            # it, truncated to the most recent max_seq_len events.
            tgt_ids[row] = ids[-1]
            tgt_ratings[row] = ratings[-1]
            tgt_ts[row] = ts[-1]
            h = ids[:-1][-n:]
            lengths[row] = len(h)
            hist_ids[row, : len(h)] = h
            hist_ratings[row, : len(h)] = ratings[:-1][-n:]
            hist_ts[row, : len(h)] = ts[:-1][-n:]
            user_ids[row] = self._seqs.user_ids[u]
        return (
            lengths, hist_ids, hist_ratings, hist_ts,
            tgt_ids, tgt_ratings, tgt_ts, user_ids,
        )

    def batches(
        self,
        batch_size: int,
        max_output_length: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        sort_by_length: bool = False,
        device: Device = None,
    ) -> Iterator[Batch]:
        """One epoch of batches on `device` (the card unless the caller
        passes "cpu").

        `sort_by_length` orders examples by history length (stable), so that
        serving batches can be truncated to their own max length
        (`truncate_features`); it excludes `shuffle`. Without `drop_last` the
        tail batch wraps around to a full batch (rows repeat)."""
        order = np.arange(len(self))
        if sort_by_length:
            if shuffle:
                raise ValueError("sort_by_length requires shuffle=False")
            order = order[np.argsort(self.lengths_of(order), kind="stable")]
        elif shuffle:
            np.random.default_rng(seed).shuffle(order)
        n_batches = len(order) // batch_size
        rem = len(order) % batch_size
        for i in range(n_batches):
            idx = order[i * batch_size : (i + 1) * batch_size]
            yield self._make_batch(idx, max_output_length, device)
        if rem and not drop_last:
            idx = np.resize(
                np.concatenate([order[n_batches * batch_size :], order]), batch_size
            )
            yield self._make_batch(idx, max_output_length, device)

    def _make_batch(self, idx: np.ndarray, max_output_length: int, device: Device) -> Batch:
        return batch_from_rows(
            *self.rows(idx), max_output_length=max_output_length, device=device
        )


def ml20m_like_lengths(rng: np.random.Generator, num_users: int, cap: int) -> np.ndarray:
    """Sequence lengths shaped like ML-20M's ratings per user
    (`datasets.py:281-299`): a lognormal with median 68 and mean 144.4,
    clamped to [20, cap]."""
    mu = np.log(68.0)
    sigma = float(np.sqrt(2.0 * (np.log(144.4) - np.log(68.0))))
    x = rng.lognormal(mu, sigma, size=num_users)
    return np.clip(x, 20, cap).astype(np.int64)


def generate_synthetic_sequences(
    num_users: int,
    num_items: int,
    max_len: int,
    seed: int = 0,
    num_clusters: int = 16,
    min_len: int = 4,
    length_distribution: str = "uniform",
) -> RaggedSequences:
    """Clustered-preference Markov sequences (`datasets.py:302-359`); the same
    seed draws the same sequences as the JAX package."""
    rng = np.random.default_rng(seed)
    item_cluster = rng.integers(0, num_clusters, size=num_items)
    cluster_items = [np.nonzero(item_cluster == c)[0] + 1 for c in range(num_clusters)]
    if length_distribution == "ml20m":
        lengths = ml20m_like_lengths(rng, num_users, max_len)
    elif length_distribution == "uniform":
        lengths = rng.integers(min_len, max_len + 1, size=num_users)
    else:
        raise ValueError(f"Unknown length_distribution {length_distribution!r}")
    offsets = np.zeros(num_users + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    item_ids = np.zeros(total, dtype=np.int32)
    ratings = rng.integers(1, 6, size=total).astype(np.int32)
    timestamps = np.zeros(total, dtype=np.int64)
    base_time = 1_000_000_000
    for u in range(num_users):
        pool = cluster_items[u % num_clusters]
        if len(pool) == 0:
            pool = np.arange(1, num_items + 1)
        n = lengths[u]
        jumps = rng.random(n) < 0.1
        picks = pool[rng.integers(0, len(pool), size=n)]
        noise = rng.integers(1, num_items + 1, size=n).astype(np.int32)
        s = offsets[u]
        item_ids[s : s + n] = np.where(jumps, noise, picks).astype(np.int32)
        timestamps[s : s + n] = base_time + u + np.cumsum(rng.integers(60, 600_000, size=n))
    return RaggedSequences(
        user_ids=np.arange(num_users, dtype=np.int32),
        offsets=offsets,
        item_ids=item_ids,
        ratings=ratings,
        timestamps=timestamps,
    )
