"""Public-dataset preprocessing: MovieLens-1M/20M and Amazon Books.

Counterpart of `rails_tpu/data/preprocessor.py`, without pandas: raw ratings
-> per-user chronological sequences -> `sasrec_format.csv` (stringified
per-user id, rating and timestamp lists, users in a seeded random order).
Amazon gets the single-pass 5-core filter and 0-based categorical id codes
(the loader shifts them by +1). The data-integrity checks on the unique
items raise ValueError where JAX's asserts raise AssertionError. The CSV is
byte for byte the JAX package's: the rows are ordered by the same numpy
calls pandas makes (`_group_to_sasrec_csv`). Network access is needed only
by `download()`; preprocessing runs on files already present.
"""

from __future__ import annotations

import csv
import os
import tarfile
from dataclasses import dataclass
from typing import Dict, Optional
from zipfile import ZipFile

import numpy as np

from rails_tpu_torch.data.tables import read_table

COLUMNS = ("user_id", "item_id", "rating", "unix_timestamp")


def _sort_indexer(values: np.ndarray) -> np.ndarray:
    """pandas' `nargsort` for a one-column `sort_values` (its default kind,
    quicksort, is not stable: ties keep the order numpy's quicksort gives
    them, and pandas' CSV has exactly that order); NaNs last."""
    mask = values != values if values.dtype.kind in "fO" else np.zeros(len(values), bool)
    idx = np.arange(len(values))
    return np.concatenate([idx[~mask][values[~mask].argsort(kind="quicksort")],
                           np.nonzero(mask)[0]])


def _group_to_sasrec_csv(
    ratings: Dict[str, np.ndarray], out_csv: str, shuffle_seed: int = 0,
    min_sequence_length: int = 0,
) -> int:
    """Sort the events by timestamp, group them by user (users in sorted
    order, events in the sorted order), drop users with fewer than
    `min_sequence_length` events, shuffle the users as
    `DataFrame.sample(frac=1, random_state=shuffle_seed)` does (RandomState's
    permutation) and write the CSV (`preprocessor.py:27-55`). Returns the
    number of users written."""
    order = _sort_indexer(ratings["unix_timestamp"])
    users = ratings["user_id"][order]
    by_user = order[np.argsort(users, kind="stable")]
    keys, starts = np.unique(ratings["user_id"][by_user], return_index=True)
    ends = np.append(starts[1:], len(by_user))
    rows = []
    for key, s, e in zip(keys.tolist(), starts, ends):
        ev = by_user[s:e]
        if e - s >= min_sequence_length:
            rows.append((key, *(str(ratings[c][ev].tolist()) for c in COLUMNS[1:])))
    perm = np.random.RandomState(shuffle_seed).permutation(len(rows))
    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["user_id", "sequence_item_ids", "sequence_ratings", "sequence_timestamps"])
        w.writerows(rows[i] for i in perm)
    return len(rows)


def _codes(values: np.ndarray) -> np.ndarray:
    """`pd.Categorical(values).codes`: each value's rank among the sorted
    distinct values."""
    return np.unique(values, return_inverse=True)[1].reshape(-1).astype(np.int64)


@dataclass
class MovielensDataProcessor:
    """`MovielensDataProcessor` (`preprocessor.py:58-133`)."""

    prefix: str                        # "ml-1m" | "ml-20m"
    download_url: str
    saved_name: str
    expected_num_unique_items: Optional[int] = None
    expected_max_item_id: Optional[int] = None
    root: str = "."

    def output_format_csv(self) -> str:
        return os.path.join(self.root, f"tmp/{self.prefix}/sasrec_format.csv")

    def download(self) -> None:
        from urllib.request import urlretrieve

        path = os.path.join(self.root, self.saved_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path):
            urlretrieve(self.download_url, path)
        tmp = os.path.join(self.root, "tmp")
        if path.endswith(".zip"):
            ZipFile(path, "r").extractall(path=tmp)
        else:
            with tarfile.open(path, "r:*") as tar:
                tar.extractall(tmp)

    def preprocess_rating(self) -> int:
        d = os.path.join(self.root, f"tmp/{self.prefix}")
        if self.prefix == "ml-1m":
            path = os.path.join(d, "ratings.dat")
            if not os.path.exists(path):
                self.download()
            ratings = read_table(path, names=list(COLUMNS), sep="::")
        else:
            path = os.path.join(d, "ratings.csv")
            if not os.path.exists(path):
                self.download()
            raw = read_table(path)
            rename = {"userId": "user_id", "movieId": "item_id", "timestamp": "unix_timestamp"}
            ratings = {rename.get(k, k): v for k, v in raw.items()}
        num_unique = len(np.unique(ratings["item_id"]))
        max_id = int(ratings["item_id"].max())
        if self.expected_num_unique_items not in (None, num_unique):
            raise ValueError(f"{self.prefix}: {num_unique} unique items, expected "
                             f"{self.expected_num_unique_items}")
        if self.expected_max_item_id not in (None, max_id):
            raise ValueError(f"{self.prefix}: max item id {max_id}, expected "
                             f"{self.expected_max_item_id}")
        _group_to_sasrec_csv(ratings, self.output_format_csv())
        return num_unique


@dataclass
class AmazonDataProcessor:
    """`AmazonDataProcessor` (`preprocessor.py:136-188`): the single-pass
    5-core filter on the original counts (items with >= 5 events, users with
    >= 5), 0-based categorical id codes, then users with >= 5 events after
    grouping."""

    prefix: str = "amzn_books"
    download_url: str = (
        "https://jmcauley.ucsd.edu/data/amazon_v2/categoryFilesSmall/Books.csv"
    )
    expected_num_unique_items: Optional[int] = 695762
    root: str = "."

    def output_format_csv(self) -> str:
        return os.path.join(self.root, f"tmp/{self.prefix}/sasrec_format.csv")

    def download(self) -> None:
        from urllib.request import urlretrieve

        path = os.path.join(self.root, f"tmp/{self.prefix}/ratings.csv")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path):
            urlretrieve(self.download_url, path)

    def preprocess_rating(self) -> int:
        path = os.path.join(self.root, f"tmp/{self.prefix}/ratings.csv")
        if not os.path.exists(path):
            self.download()
        # Read user-first, as the reference parses the raw file.
        ratings = read_table(path, names=list(COLUMNS))

        def counts(col):
            _, inv, cnt = np.unique(ratings[col], return_inverse=True, return_counts=True)
            return cnt[inv.reshape(-1)]

        keep = (counts("item_id") >= 5) & (counts("user_id") >= 5)
        ratings = {k: v[keep] for k, v in ratings.items()}
        ratings["item_id"] = _codes(ratings["item_id"])
        ratings["user_id"] = _codes(ratings["user_id"])
        num_unique = len(np.unique(ratings["item_id"]))
        if self.expected_num_unique_items not in (None, num_unique):
            raise ValueError(f"amzn-books: {num_unique} unique items, expected "
                             f"{self.expected_num_unique_items}")
        _group_to_sasrec_csv(ratings, self.output_format_csv(), min_sequence_length=5)
        return num_unique


def get_common_preprocessors(root: str = ".") -> Dict[str, object]:
    """`get_common_preprocessors` (`preprocessor.py:191-218`)."""
    return {
        "ml-1m": MovielensDataProcessor(
            prefix="ml-1m",
            download_url="https://files.grouplens.org/datasets/movielens/ml-1m.zip",
            saved_name="tmp/movielens1m.zip",
            expected_num_unique_items=3706,
            expected_max_item_id=3952,
            root=root,
        ),
        "ml-20m": MovielensDataProcessor(
            prefix="ml-20m",
            download_url="https://files.grouplens.org/datasets/movielens/ml-20m.zip",
            saved_name="tmp/movielens20m.zip",
            expected_num_unique_items=26744,
            expected_max_item_id=131262,
            root=root,
        ),
        "amzn-books": AmazonDataProcessor(root=root),
        "ml-20mx16x32": _ML1BStub(),
    }


class _ML1BStub:
    """ml-1b ("ml-20mx16x32"): the reference reads pre-downloaded MLPerf npz
    shards with placeholder ratings and timestamps; a stub here as in JAX."""

    output_format_csv = staticmethod(lambda: "tmp/ml-20mx16x32/sasrec_format.csv")

    def preprocess_rating(self) -> int:
        raise NotImplementedError(
            "ml-1b (ml-20mx16x32) preprocessing needs the MLPerf npz shards; the "
            "reference implements only a placeholder reader")
