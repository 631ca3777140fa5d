"""Host-side datasets: ragged user sequences -> fixed-shape torch batches.

Counterpart of `rails_tpu/data/datasets.py` (the numpy code, copied: that
module imports the jax-backed batch type): `RaggedSequences` (:29), the
leave-one-out `SequenceDataset` (:47-195) with positional subsampling
(`_subsample_events`, :249-278) and native batch assembly
(`data/native.py`) beside its numpy rows, `prefetch_batches` (:198-232),
`RecoDataset` (:235-246), the synthetic generator (:281-360), the
`sasrec_format.csv` loader with the native parser and the Python one where
that declines (:363-424), and `get_reco_dataset` (:427-492). The epoch shards over the ranks of a
data-parallel run as in JAX (`num_shards`, `shard_index`: every
`num_shards`-th example of the epoch's order, :141-195).
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from rails_tpu_torch.core.config import DataConfig
from rails_tpu_torch.data import native
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
        self, sequences: RaggedSequences, max_sequence_length: int, ignore_last_n: int,
        sample_ratio: float = 1.0,
    ) -> None:
        """`sample_ratio` < 1 keeps that share of each user's events, drawn
        once (seed 0); the last `ignore_last_n` events, which the trim
        removes, are never dropped (the reference trims, then samples)."""
        self._seqs = sequences
        self._max_seq_len = max_sequence_length
        self._ignore_last_n = ignore_last_n
        if sample_ratio < 1.0:
            self._seqs = _subsample_events(sequences, sample_ratio, seed=0,
                                           protect_last_n=ignore_last_n)
        # Users must keep >= 2 events (1 history + 1 target) after trimming.
        lens = np.diff(self._seqs.offsets) - ignore_last_n
        self._valid_users = np.nonzero(lens >= 2)[0]

    def __len__(self) -> int:
        return len(self._valid_users)

    def lengths_of(self, indices: np.ndarray) -> np.ndarray:
        """History lengths (post-trim, pre-padding) of example indices."""
        u = self._valid_users[np.asarray(indices)]
        raw = np.diff(self._seqs.offsets)[u] - self._ignore_last_n - 1
        return np.minimum(raw, self._max_seq_len).astype(np.int32)

    def rows(self, indices: np.ndarray):
        """Fixed-shape host arrays for a batch of example indices, through
        the native assembler where it is built, else `_rows_numpy`."""
        out = native.assemble_batch_native(
            self._seqs, self._valid_users[np.asarray(indices)], self._max_seq_len,
            self._ignore_last_n)
        return self._rows_numpy(indices) if out is None else out

    def _rows_numpy(self, indices: np.ndarray):
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
        num_shards: int = 1,
        shard_index: int = 0,
        sort_by_length: bool = False,
        device: Device = None,
    ) -> Iterator[Batch]:
        """One epoch of batches on `device` (the card unless the caller
        passes "cpu").

        `num_shards` / `shard_index` give a rank of a data-parallel run its
        share of the epoch, as torch's `DistributedSampler` does: every
        `num_shards`-th example of the epoch's order from `shard_index`.

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
        order = order[shard_index::num_shards]
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


def prefetch_batches(batch_iter: Iterator[Batch], depth: int = 2) -> Iterator[Batch]:
    """Batches from `batch_iter` assembled by a background thread, `depth`
    ahead, in order (`datasets.py:198-232`). A failure in the thread is
    raised in the consumer, never presented as the end of the epoch."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for b in batch_iter:
                q.put(b)
            q.put(end)
        except BaseException as e:    # noqa: BLE001 -- re-raised in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        b = q.get()
        if b is end:
            return
        if isinstance(b, BaseException):
            raise b
        yield b


@dataclass
class RecoDataset:
    """`RecoDataset` (`datasets.py:235-246`): train (leave-one-out) and eval
    views of one corpus, its item ids and, for MovieLens where the processed
    movies.csv exists, hashed item side features (built, not consumed)."""

    max_sequence_length: int
    num_unique_items: int
    max_item_id: int
    all_item_ids: np.ndarray     # (num_unique_items,) int32, ids > 0
    train_dataset: SequenceDataset
    eval_dataset: SequenceDataset
    item_features: object = None


def _subsample_events(
    seqs: RaggedSequences, ratio: float, seed: int, protect_last_n: int = 0
) -> RaggedSequences:
    """Keep ~ratio of each user's events, drawn once by numpy's
    `default_rng(seed)` as the JAX package draws them (`datasets.py:249-278`);
    each user's last `protect_last_n` events always stay."""
    rng = np.random.default_rng(seed)
    keep = rng.random(len(seqs.item_ids)) < ratio
    for j in range(1, protect_last_n + 1):
        tails = seqs.offsets[1:] - j
        keep[tails[tails >= seqs.offsets[:-1]]] = True     # users with >= j events
    csum = np.concatenate([[0], np.cumsum(keep.astype(np.int64))])
    lens = csum[seqs.offsets[1:]] - csum[seqs.offsets[:-1]]
    offsets = np.zeros(len(seqs.user_ids) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return RaggedSequences(
        user_ids=seqs.user_ids,
        offsets=offsets,
        item_ids=seqs.item_ids[keep],
        ratings=seqs.ratings[keep],
        timestamps=seqs.timestamps[keep],
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


def load_sasrec_format_csv(path: str, shift_id_by: int = 0) -> RaggedSequences:
    """The RaggedSequences of a sasrec_format.csv (user_id and the stringified
    per-user lists sequence_item_ids, sequence_ratings, sequence_timestamps;
    `datasets.py:363-413`): the native parser, or the Python one where it
    declines. Float ratings floor-cast to int. A git-LFS pointer stub raises
    FileNotFoundError."""
    if _is_lfs_stub(path):
        raise FileNotFoundError(
            f"{path} is a git-LFS pointer stub, not real data; run "
            "`python -m rails_tpu_torch.cli.preprocess` on the raw files, or use the "
            "synthetic dataset.")
    seqs = native.parse_sasrec_csv_native(path)
    if seqs is not None:
        if shift_id_by:
            seqs.item_ids += shift_id_by
        return seqs
    return _parse_sasrec_csv_python(path, shift_id_by)


def _parse_sasrec_csv_python(path: str, shift_id_by: int = 0) -> RaggedSequences:
    def ints(field: str, dtype) -> np.ndarray:
        return np.fromstring(field.strip("[]()"), dtype=dtype, sep=",")

    user_ids: List[int] = []
    flat_ids, flat_ratings, flat_ts = [], [], []
    with open(path, newline="") as f:
        for rec in csv.DictReader(f):
            user_ids.append(int(rec["user_id"]))
            flat_ids.append(ints(rec["sequence_item_ids"], np.int64) + shift_id_by)
            flat_ratings.append(ints(rec["sequence_ratings"], np.float64).astype(np.int64))
            flat_ts.append(ints(rec["sequence_timestamps"], np.int64))
    offsets = np.zeros(len(user_ids) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in flat_ids], out=offsets[1:])
    return RaggedSequences(
        user_ids=np.asarray(user_ids, dtype=np.int32),
        offsets=offsets,
        item_ids=np.concatenate(flat_ids).astype(np.int32),
        ratings=np.concatenate(flat_ratings).astype(np.int32),
        timestamps=np.concatenate(flat_ts).astype(np.int64),
    )


def _is_lfs_stub(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(64).startswith(b"version https://git-lfs")
    except OSError:
        return True


_DATASET_FILES = {
    # name -> (csv relpath, shift_id_by, expected_max_item_id or None)
    "ml-1m": ("tmp/ml-1m/sasrec_format.csv", 0, 3952),
    "ml-20m": ("tmp/ml-20m/sasrec_format.csv", 0, 131262),
    "amzn-books": ("tmp/amzn_books/sasrec_format.csv", 1, None),
}


def get_reco_dataset(cfg: DataConfig, data_root: str = ".") -> RecoDataset:
    """Train (ignore_last_n=1, positional subsampling) and eval
    (ignore_last_n=0) datasets of `cfg.dataset_name` (`datasets.py:
    427-492`): synthetic users, or `data_root`/tmp/<name>/sasrec_format.csv.
    Amazon Books ids shift by +1 so that 0 stays the padding id; max_item_id
    is at least the dataset's published maximum."""
    if cfg.dataset_name == "synthetic":
        seqs = generate_synthetic_sequences(
            num_users=cfg.synthetic_num_users,
            num_items=cfg.synthetic_num_items,
            max_len=cfg.synthetic_max_len or cfg.max_sequence_length + 2,
            seed=cfg.synthetic_seed,
            length_distribution=cfg.synthetic_length_distribution,
        )
        max_item_id = cfg.synthetic_num_items
    elif cfg.dataset_name in _DATASET_FILES:
        rel, shift, expected_max = _DATASET_FILES[cfg.dataset_name]
        seqs = load_sasrec_format_csv(os.path.join(data_root, rel), shift_id_by=shift)
        max_item_id = int(seqs.item_ids.max())
        if expected_max is not None:
            max_item_id = max(max_item_id, expected_max)
    else:
        raise ValueError(f"Unknown dataset {cfg.dataset_name!r}")

    item_features = None
    if cfg.dataset_name in ("ml-1m", "ml-20m"):
        movies_csv = os.path.join(data_root, f"tmp/processed/{cfg.dataset_name}/movies.csv")
        if os.path.exists(movies_csv) and not _is_lfs_stub(movies_csv):
            from rails_tpu_torch.data.item_features import load_movielens_item_features

            item_features = load_movielens_item_features(movies_csv, max_item_id)

    all_item_ids = np.unique(seqs.item_ids)
    all_item_ids = all_item_ids[all_item_ids > 0].astype(np.int32)
    return RecoDataset(
        max_sequence_length=cfg.max_sequence_length,
        num_unique_items=len(all_item_ids),
        max_item_id=max_item_id,
        all_item_ids=all_item_ids,
        train_dataset=SequenceDataset(seqs, cfg.max_sequence_length, ignore_last_n=1,
                                      sample_ratio=cfg.positional_sampling_ratio),
        eval_dataset=SequenceDataset(seqs, cfg.max_sequence_length, ignore_last_n=0),
        item_features=item_features,
    )
