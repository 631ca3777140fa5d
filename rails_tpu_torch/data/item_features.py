"""Jagged categorical item side features (MovieLens genres, title words, year).

Counterpart of `rails_tpu/data/item_features.py`: `ItemFeatures`, its
loader from the processed movies.csv and `build_item_features`, without
pandas (`tables.read_table` types the columns as pandas does). Values are
hashed by zlib's crc32, as in the JAX package. The registry builds them for
MovieLens; no model reads them, as in the reference.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import List

import numpy as np

from rails_tpu_torch.data.tables import read_table


@dataclass
class ItemFeatures:
    """Per-item jagged features: item i's values of feature f are
    values[f][offsets[f][i]:offsets[f][i + 1]], items 0..max_item_id."""

    max_item_id: int
    num_features: int
    offsets: List[np.ndarray]
    values: List[np.ndarray]

    def lengths(self, f: int) -> np.ndarray:
        return np.diff(self.offsets[f])

    def to_padded_dense(self, f: int, max_len: int) -> np.ndarray:
        """(max_item_id + 1, max_len) int32, zero padded."""
        out = np.zeros((self.max_item_id + 1, max_len), dtype=np.int32)
        offs, vals = self.offsets[f], self.values[f]
        for i in range(self.max_item_id + 1):
            row = vals[offs[i]: offs[i + 1]][:max_len]
            out[i, : len(row)] = row
        return out


def _jagged(per_item: List[np.ndarray], max_item_id: int):
    lens = np.array([len(v) for v in per_item], dtype=np.int64)
    offs = np.zeros(max_item_id + 2, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return offs, np.concatenate(per_item) if per_item else np.asarray([], np.int64)


def load_movielens_item_features(
    movies_csv: str,
    max_item_id: int,
    max_ind_range=(63, 16383, 511),
    max_jagged_dimension: int = 16,
) -> ItemFeatures:
    """Hashed genres, title words (cleaned_title where the file has it) and
    year of each movie up to `max_item_id` (`item_features.py:45-97`)."""

    def h(s, mod: int) -> int:
        return zlib.crc32(str(s).encode()) % mod

    cols = read_table(movies_csv)
    title = cols.get("cleaned_title", cols.get("title"))
    per_feature = [[np.asarray([], dtype=np.int64)] * (max_item_id + 1) for _ in range(3)]
    for r in range(len(cols["movie_id"])):
        movie_id = int(cols["movie_id"][r])
        if movie_id > max_item_id:
            continue
        genres = str(cols["genres"][r]).split("|")
        titles = str("" if title is None else title[r]).split(" ")
        per_feature[0][movie_id] = np.asarray(
            [h(x, max_ind_range[0]) for x in genres[:max_jagged_dimension]], dtype=np.int64)
        per_feature[1][movie_id] = np.asarray(
            [h(x, max_ind_range[1]) for x in titles[:max_jagged_dimension]], dtype=np.int64)
        per_feature[2][movie_id] = np.asarray([h(cols["year"][r], max_ind_range[2])],
                                              dtype=np.int64)
    offsets, values = zip(*(_jagged(per_feature[f], max_item_id) for f in range(3)))
    return ItemFeatures(max_item_id=max_item_id, num_features=3, offsets=list(offsets),
                        values=list(values))


def build_item_features(
    item_ids: np.ndarray, feature_lists: List[List[np.ndarray]], max_item_id: int
) -> ItemFeatures:
    """Assemble from per-item value lists, one inner list per feature."""
    offsets, values = [], []
    for f in range(len(feature_lists)):
        per_item = [np.asarray([], dtype=np.int64)] * (max_item_id + 1)
        for i, iid in enumerate(item_ids):
            per_item[int(iid)] = np.asarray(feature_lists[f][i], dtype=np.int64)
        offs, vals = _jagged(per_item, max_item_id)
        offsets.append(offs)
        values.append(vals)
    return ItemFeatures(max_item_id=max_item_id, num_features=len(feature_lists),
                        offsets=offsets, values=values)
