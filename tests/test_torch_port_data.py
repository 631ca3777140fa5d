"""The port's data pipeline (`rails_tpu_torch.data`, `cli.preprocess`) vs
rails_tpu's, on fixture files written under tmp_path.

The sasrec_format.csv loaders (native, and the Python parser where the
native one declines or is not built) against JAX's `load_sasrec_format_csv`,
array for array, float ratings, CRLF, malformed rows and the Amazon id shift
included; `get_reco_dataset` and subsampled `SequenceDataset` batches bit
for bit; native batch assembly against the numpy rows; the ML-1M `.dat`,
ML-20M csv and Amazon preprocessors' CSVs byte for byte (the port reads
without pandas); the item features; `prefetch_batches`; and the native
loader's build under build/, which writes nothing under native/. Native
cases skip on a machine without a C++ compiler.
"""

import ctypes
import hashlib
import logging
import os
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from rails_tpu.core.config import get_experiment_config as jax_experiment_config
from rails_tpu.data import datasets as jax_datasets
from rails_tpu.data import item_features as jax_item_features
from rails_tpu.data import preprocessor as jax_preprocessor
from rails_tpu_torch.core.config import get_experiment_config
from rails_tpu_torch.data import datasets, item_features, native, preprocessor, tables
from rails_tpu_torch.cli import preprocess as port_preprocess_cli

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("user_ids", "offsets", "item_ids", "ratings", "timestamps")


@pytest.fixture
def native_lib():
    if native.find_cxx() is None:
        pytest.skip("no C++ compiler to build native/sequence_loader.cpp")
    assert native.available()


def _write_sasrec(path, rows, index=True, newline="\n"):
    head = "index,user_id," if index else "user_id,"
    lines = [head + "sequence_item_ids,sequence_ratings,sequence_timestamps"]
    for i, (uid, ids, ratings, ts) in enumerate(rows):
        lines.append((f"{i}," if index else "") + f'{uid},"{list(ids)}","{list(ratings)}",'
                     f'"{list(ts)}"')
    Path(path).write_bytes((newline.join(lines) + newline).encode())
    return str(path)


def _random_rows(seed=0, users=20):
    rng = np.random.default_rng(seed)
    rows = []
    for uid in range(users):
        n = int(rng.integers(2, 30))
        rows.append((uid * 3 + 1, rng.integers(1, 1000, n).tolist(),
                     rng.integers(1, 6, n).tolist(), np.sort(rng.integers(1, 10**9, n)).tolist()))
    return rows


def _assert_seqs_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


CSV_CASES = {
    "plain": dict(rows=_random_rows()),
    "float_ratings": dict(rows=[(3, [1, 2, 3], [4.0, 3.5, 0.5], [10, 20, 30]),
                                (5, [7, 8], [5.0, 2.0], [40, 50])]),
    "crlf": dict(rows=[(1, [1, 2, 3], [5, 4, 3], [10, 20, 30]), (2, [4, 5], [2, 1], [15, 25])],
                 index=False, newline="\r\n"),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("parser", ["native", "python"])
def test_loaders_match_jax(case, parser, tmp_path, request, monkeypatch):
    """The port's loader (native, or forced to the Python parser) gives
    JAX's arrays."""
    if parser == "native":
        request.getfixturevalue("native_lib")
    path = _write_sasrec(tmp_path / "sasrec_format.csv", **CSV_CASES[case])
    want = jax_datasets.load_sasrec_format_csv(path)
    if parser == "python":
        monkeypatch.setattr(native, "load_library", lambda: None)
    before = native.parse_sasrec_csv_native.calls
    got = datasets.load_sasrec_format_csv(path)
    _assert_seqs_equal(got, want)
    ran = native.parse_sasrec_csv_native.calls - before
    assert ran == (parser == "native")


def test_malformed_rows_are_skipped_and_counted(tmp_path, native_lib, caplog):
    path = tmp_path / "sasrec_format.csv"
    path.write_text(
        "index,user_id,sequence_item_ids,sequence_ratings,sequence_timestamps\n"
        '0,1,"[1, 2]","[5, 4]","[10, 20]"\n'
        '1,2,"[3, 4,"[1, 1]","[30, 40]"\n'
        '2,3,"[5, 6]","[2, 3]","[50, 60]"\n')
    want = jax_datasets.load_sasrec_format_csv(str(path))
    with caplog.at_level(logging.WARNING, logger="rails_tpu_torch"):
        got = datasets.load_sasrec_format_csv(str(path))
    _assert_seqs_equal(got, want)
    np.testing.assert_array_equal(got.user_ids, [1, 3])
    assert any("skipped 1 malformed" in r.message for r in caplog.records)


def test_lfs_stub_raises(tmp_path):
    path = tmp_path / "sasrec_format.csv"
    path.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:0\n")
    with pytest.raises(FileNotFoundError, match="git-LFS"):
        datasets.load_sasrec_format_csv(str(path))


def _batches_equal(port_ds, jax_ds, **kw):
    n = 0
    for got, want in zip(port_ds.batches(device="cpu", **kw), jax_ds.batches(**kw)):
        for a, b in zip(list(got.features) + [got.target_ids, got.target_ratings],
                        list(want.features) + [want.target_ids, want.target_ratings]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        n += 1
    assert n == -(-len(jax_ds) // kw["batch_size"])


@pytest.mark.parametrize("dataset", ["ml-1m", "amzn-books", "synthetic"])
def test_get_reco_dataset_matches_jax(dataset, tmp_path):
    """`get_reco_dataset` on a written csv (Books' ids shifted by +1, ML-1M's
    max id at least 3952) or synthetic users, the train split subsampled at
    0.5: every field and every batch of both splits bit-equal to JAX's."""
    rel = {"ml-1m": "tmp/ml-1m", "amzn-books": "tmp/amzn_books"}.get(dataset)
    if rel:
        os.makedirs(tmp_path / rel)
        _write_sasrec(tmp_path / rel / "sasrec_format.csv", _random_rows(users=40), index=False)

    def cfg(get):
        c = get("synthetic-small").data
        return c.replace(dataset_name=dataset, positional_sampling_ratio=0.5,
                         synthetic_num_users=40, synthetic_num_items=300)

    want = jax_datasets.get_reco_dataset(cfg(jax_experiment_config), str(tmp_path))
    got = datasets.get_reco_dataset(cfg(get_experiment_config), str(tmp_path))
    for f in ("max_sequence_length", "num_unique_items", "max_item_id"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.all_item_ids, want.all_item_ids)
    if dataset == "amzn-books":
        assert got.all_item_ids.min() >= 2            # raw ids >= 1, shifted
    if dataset == "ml-1m":
        assert got.max_item_id == 3952
    assert len(got.train_dataset) == len(want.train_dataset)
    for split in ("train_dataset", "eval_dataset"):
        for shuffle in (False, True):
            _batches_equal(getattr(got, split), getattr(want, split), batch_size=16,
                           max_output_length=3, shuffle=shuffle, seed=7)


def test_subsample_events_matches_jax():
    seqs = datasets.generate_synthetic_sequences(50, 200, 40, seed=3)
    jseqs = jax_datasets.generate_synthetic_sequences(50, 200, 40, seed=3)
    for ratio, protect in ((0.5, 1), (0.3, 0), (0.8, 2)):
        _assert_seqs_equal(datasets._subsample_events(seqs, ratio, seed=0, protect_last_n=protect),
                           jax_datasets._subsample_events(jseqs, ratio, seed=0,
                                                          protect_last_n=protect))


@pytest.mark.parametrize("ignore_last_n", [0, 1])
def test_native_assembly_equals_numpy_rows(ignore_last_n, native_lib):
    seqs = datasets.generate_synthetic_sequences(64, 500, 60, seed=1, length_distribution="ml20m")
    ds = datasets.SequenceDataset(seqs, 32, ignore_last_n=ignore_last_n)
    idx = np.random.default_rng(0).permutation(len(ds))[:40]
    got = ds.rows(idx)
    want = ds._rows_numpy(idx)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _ml1m_rows(seed=0, users=371, per_user=10):
    """(user, item, rating, ts) with ML-1M's 3,706 distinct items, max id
    3,952, in shuffled file order and with timestamp ties inside users."""
    rng = np.random.default_rng(seed)
    items = np.sort(np.concatenate([rng.choice(np.arange(1, 3952), 3705, replace=False),
                                    [3952]]))
    slots = np.resize(items, users * per_user)
    u = np.repeat(np.arange(1, users + 1), per_user)
    ts = 978300000 + np.arange(len(slots)) // 3          # ties of three events
    order = rng.permutation(len(slots))
    return u[order], slots[order], rng.integers(1, 6, len(slots))[order], ts[order]


def _write_raw(root, dataset):
    if dataset == "ml-1m":
        d = root / "tmp/ml-1m"
        d.mkdir(parents=True)
        with open(d / "ratings.dat", "w") as f:
            for r in zip(*_ml1m_rows()):
                f.write("::".join(str(v) for v in r) + "\n")
    elif dataset == "ml-20m":
        rng = np.random.default_rng(1)
        n = 300
        df = pd.DataFrame({"userId": rng.integers(1, 21, n), "movieId": rng.integers(1, 90, n),
                           "rating": rng.integers(1, 11, n) / 2.0,
                           "timestamp": 1e9 + rng.integers(0, 60, n)})
        (root / "tmp/ml-20m").mkdir(parents=True)
        df.to_csv(root / "tmp/ml-20m/ratings.csv", index=False)
    else:
        rows, ts = [], 0
        rng = np.random.default_rng(2)
        for u in range(12):
            for i in rng.choice(10, 7, replace=False):
                ts += int(rng.integers(0, 2))              # timestamp ties
                rows.append((f"U{u:02d}", f"{i:010d}" if i % 3 else f"B{i}", 5.0 - i % 3, ts))
        rows += [("L0", "0000000001", 2.0, ts + 1), ("U00", "I_rare", 4.0, ts + 2)]
        (root / "tmp/amzn_books").mkdir(parents=True)
        pd.DataFrame(rows).to_csv(root / "tmp/amzn_books/ratings.csv", index=False, header=False)


def _processor(pkg, dataset, root):
    if dataset == "ml-1m":
        return pkg.get_common_preprocessors(str(root))["ml-1m"]
    if dataset == "ml-20m":
        raw = pd.read_csv(root / "tmp/ml-20m/ratings.csv")
        return pkg.MovielensDataProcessor(
            prefix="ml-20m", download_url="unused", saved_name="unused",
            expected_num_unique_items=int(raw["movieId"].nunique()),
            expected_max_item_id=int(raw["movieId"].max()), root=str(root))
    return pkg.AmazonDataProcessor(root=str(root), expected_num_unique_items=None)


@pytest.mark.parametrize("dataset", ["ml-1m", "ml-20m", "amzn-books"])
def test_preprocessors_write_jax_csv(dataset, tmp_path):
    """The same raw file through both preprocessors: the same unique-item
    count and the same sasrec_format.csv, byte for byte."""
    out = {}
    for name, pkg in (("jax", jax_preprocessor), ("port", preprocessor)):
        root = tmp_path / name
        _write_raw(root, dataset)
        proc = _processor(pkg, dataset, root)
        out[name] = (proc.preprocess_rating(), Path(proc.output_format_csv()).read_bytes())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][1].count(b"\n") > 10


def test_preprocessor_integrity_check_raises(tmp_path):
    (tmp_path / "tmp/ml-1m").mkdir(parents=True)
    with open(tmp_path / "tmp/ml-1m/ratings.dat", "w") as f:
        for r in list(zip(*_ml1m_rows()))[:100]:
            f.write("::".join(str(v) for v in r) + "\n")
    with pytest.raises(ValueError, match="unique items"):
        preprocessor.get_common_preprocessors(str(tmp_path))["ml-1m"].preprocess_rating()


def test_cli_preprocess_then_load_matches_jax(tmp_path):
    """`cli.preprocess --datasets ml-1m` from a zip (the download path
    without the download), then `get_reco_dataset`: JAX's csv and arrays."""
    for name in ("jax", "port"):
        root = tmp_path / name
        _write_raw(root, "ml-1m")
        dat = root / "tmp/ml-1m/ratings.dat"
        with zipfile.ZipFile(root / "tmp/movielens1m.zip", "w") as z:
            z.write(dat, arcname="ml-1m/ratings.dat")
        dat.unlink()
    from rails_tpu.cli import preprocess as jax_cli

    jax_cli.main(["--datasets", "ml-1m", "--root", str(tmp_path / "jax")])
    port_preprocess_cli.main(["--datasets", "ml-1m", "--root", str(tmp_path / "port")])
    rel = "tmp/ml-1m/sasrec_format.csv"
    assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    cfg = get_experiment_config("ml-1m-hstu-mol").data
    ds = datasets.get_reco_dataset(cfg, str(tmp_path / "port"))
    jds = jax_datasets.get_reco_dataset(jax_experiment_config("ml-1m-hstu-mol").data,
                                        str(tmp_path / "jax"))
    assert ds.num_unique_items == jds.num_unique_items == 3706
    _batches_equal(ds.eval_dataset, jds.eval_dataset, batch_size=128, max_output_length=1,
                   shuffle=False)


def test_item_features_match_jax(tmp_path):
    """movies.csv with a missing year (a float column), a missing genre and
    ids past max_item_id: every offset and hashed value equal to JAX's."""
    path = tmp_path / "movies.csv"
    pd.DataFrame({
        "movie_id": [1, 2, 5, 9, 40],
        "title": ["Toy Story (1995)", "Jumanji (1995)", "Heat, The (1995)", "X", "Late (2001)"],
        "genres": ["Animation|Children's|Comedy", "Adventure", None, "Drama|Thriller", "Drama"],
        "year": [1995, 1995, 1995, None, 2001],
        "cleaned_title": ["Toy Story", "Jumanji", "Heat, The", "X", "Late"],
    }).to_csv(path, index=False)
    for drop in (None, "cleaned_title"):
        if drop:
            pd.read_csv(path).drop(columns=[drop]).to_csv(path, index=False)
        want = jax_item_features.load_movielens_item_features(str(path), 10)
        got = item_features.load_movielens_item_features(str(path), 10)
        assert got.num_features == want.num_features == 3
        for f in range(3):
            np.testing.assert_array_equal(got.offsets[f], want.offsets[f])
            np.testing.assert_array_equal(got.values[f], want.values[f])
            np.testing.assert_array_equal(got.to_padded_dense(f, 4), want.to_padded_dense(f, 4))
    lists = [[np.array([1, 2]), np.array([3])], [np.array([7]), np.array([], np.int64)]]
    want = jax_item_features.build_item_features(np.array([2, 4]), lists, 5)
    got = item_features.build_item_features(np.array([2, 4]), lists, 5)
    for f in range(2):
        np.testing.assert_array_equal(got.offsets[f], want.offsets[f])
        np.testing.assert_array_equal(got.values[f], want.values[f])


def test_table_column_types_follow_pandas(tmp_path):
    path = tmp_path / "t.csv"
    pd.DataFrame({"i": [1, 2, 3], "f": [1.5, None, 2.0], "s": ["a", "1", None],
                  "n": ["007", "12", "3"]}).to_csv(path, index=False)
    want = pd.read_csv(path)
    got = tables.read_table(str(path))
    for c in want.columns:
        numeric = want[c].dtype.kind in "if"
        assert got[c].dtype == (want[c].dtype if numeric else object), c
        assert [str(v) for v in got[c]] == [str(v) for v in want[c]], c


def test_prefetch_keeps_order_and_reraises():
    assert list(datasets.prefetch_batches(iter(range(50)), depth=3)) == list(range(50))

    def failing():
        yield 1
        yield 2
        raise RuntimeError("worker broke")

    got = []
    with pytest.raises(RuntimeError, match="worker broke"):
        for b in datasets.prefetch_batches(failing()):
            got.append(b)
    assert got == [1, 2]


def test_native_library_builds_under_build(tmp_path, monkeypatch):
    """The port compiles native/sequence_loader.cpp into build/, at first
    use; no file under native/ changes."""
    if native.find_cxx() is None:
        pytest.skip("no C++ compiler to build native/sequence_loader.cpp")
    tracked = {p: hashlib.sha256(p.read_bytes()).hexdigest()
               for p in (REPO / "native").iterdir() if p.suffix in (".cpp", "") and p.is_file()}
    assert native.library_path(native.find_cxx()).is_relative_to(REPO / "build")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    lib = native.build()
    assert lib.is_relative_to(tmp_path) and lib.exists()
    assert native.build() == lib                       # built once per hash
    native.declare(ctypes.CDLL(str(lib)))
    assert {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in tracked} == tracked


def test_native_build_failure_falls_back(tmp_path, monkeypatch):
    """A compiler that fails leaves no library and the loaders on numpy."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "find_cxx", lambda: "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list(tmp_path.rglob("*.so"))
    native.load_library.cache_clear()
    try:
        assert not native.available()
        seqs = datasets.generate_synthetic_sequences(8, 50, 12, seed=0)
        ds = datasets.SequenceDataset(seqs, 8, ignore_last_n=1)
        rows = ds.rows(np.arange(4))
        for a, b in zip(rows, ds._rows_numpy(np.arange(4))):
            np.testing.assert_array_equal(a, b)
    finally:
        native.load_library.cache_clear()
