"""Delimited text tables read into numpy columns, with pandas' type rules.

The JAX package reads the raw rating files and movies.csv with
`pandas.read_csv` (`rails_tpu/data/preprocessor.py`, `item_features.py`);
the port reads them with the `csv` module and types each column as pandas'
default parser does, so that the same files give the same values: a column
whose every field is an integer is int64; else one whose fields are numbers
or missing is float64 (missing as NaN); else an object column of strings,
missing fields NaN. Missing means an empty field or one of pandas' default
NA strings.
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

# pandas.read_csv's default na_values (`pandas._libs.parsers.STR_NA_VALUES`).
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _parse_int(s: str) -> Optional[int]:
    t = s.strip()
    if t[:1] in "+-":
        t = t[1:]
    return int(s) if t.isdigit() and t.isascii() else None


def _parse_float(s: str) -> Optional[float]:
    if "_" in s:
        return None
    try:
        return float(s)
    except ValueError:
        return None


def typed_column(fields: Sequence[str]) -> np.ndarray:
    """One column of raw fields as pandas types it (module docstring)."""
    missing = [f in NA_STRINGS for f in fields]
    if not any(missing):
        ints = [_parse_int(f) for f in fields]
        if all(v is not None for v in ints):
            return np.asarray(ints, dtype=np.int64)
    floats = [math.nan if m else _parse_float(f) for f, m in zip(fields, missing)]
    if all(v is not None for v in floats):
        return np.asarray(floats, dtype=np.float64)
    return np.asarray([math.nan if m else f for f, m in zip(fields, missing)], dtype=object)


def read_table(path: str, names: Optional[List[str]] = None, sep: str = ","
               ) -> Dict[str, np.ndarray]:
    """Columns of a delimited file: `names` for a file without a header
    line, else the header's. A one-character `sep` reads through `csv`
    (quoted fields, blank lines skipped); a longer one (MovieLens' "::")
    splits each line on it, as pandas' python engine does."""
    with open(path, newline="") as f:
        if len(sep) == 1:
            rows = [r for r in csv.reader(f, delimiter=sep) if r]
        else:
            rows = [line.rstrip("\r\n").split(sep) for line in f if line.strip()]
    if names is None:
        names, rows = rows[0], rows[1:]
    return {name: typed_column([r[i] if i < len(r) else "" for r in rows])
            for i, name in enumerate(names)}
