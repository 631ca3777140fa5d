"""ctypes bindings to the native sequence loader, `native/sequence_loader.cpp`.

Counterpart of `rails_tpu/data/native.py:27-198`: the CSV parser
(`parse_sasrec_csv_native`) and the batch assembler (`assemble_batch_native`)
over the same C interface and `_ParsedSequences` layout. The library is built
here, not by `make -C native`: the host C++ compiler compiles the source at
first use into `build/rails_tpu_torch/<hash of the source, flags and host>/`
at the root of the checkout (git-ignored; nothing is written under `native/`), as
`ops/_build.py` builds the kernels. Without a compiler, or when it fails,
`available()` is False and the datasets take their numpy paths: both are host
code, and they give equal arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sequence_loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "rails_tpu_torch"
LIB_NAME = "libsequence_loader.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

log = logging.getLogger("rails_tpu_torch")


class _ParsedSequences(ctypes.Structure):
    _fields_ = [
        ("num_users", ctypes.c_int64),
        ("total_events", ctypes.c_int64),
        ("user_ids", ctypes.POINTER(ctypes.c_int32)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("item_ids", ctypes.POINTER(ctypes.c_int32)),
        ("ratings", ctypes.POINTER(ctypes.c_int32)),
        ("timestamps", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char_p),
        ("skipped_rows", ctypes.c_int64),
    ]


def find_cxx() -> Optional[str]:
    return shutil.which("c++") or shutil.which("g++")


def library_path(cxx: str) -> Path:
    """The library's path under BUILD_ROOT, keyed on the source, the flags,
    the compiler and the host's C library (a checkout copied to another
    machine builds its own)."""
    host = (platform.machine(), *platform.libc_ver())
    h = hashlib.sha256(" ".join((os.path.basename(cxx), *host) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the loader unless this hash is built; returns the library
    path. Raises RuntimeError without a compiler or when it fails."""
    cxx = find_cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ or g++) to build the native loader")
    lib = library_path(cxx)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename: concurrent processes never load a
    # half-written library.
    fd, tmp = tempfile.mkstemp(dir=lib.parent, suffix=".so")
    os.close(fd)
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                             text=True, check=False)
        if out.returncode != 0:
            raise RuntimeError(f"{cxx} failed (exit {out.returncode}):\n{out.stderr[-4000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argtypes and restype of every entry point."""
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.parse_sasrec_csv.argtypes = [ctypes.c_char_p]
    lib.parse_sasrec_csv.restype = ctypes.POINTER(_ParsedSequences)
    lib.free_parsed_sequences.argtypes = [ctypes.POINTER(_ParsedSequences)]
    lib.free_parsed_sequences.restype = None
    lib.assemble_batch.argtypes = [p] * 6 + [i64] * 3 + [p] * 8
    lib.assemble_batch.restype = None
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> Optional[ctypes.CDLL]:
    """The loader library, built at first use; None (logged once) when it
    cannot be built or loaded."""
    try:
        return declare(ctypes.CDLL(str(build())))
    except (RuntimeError, OSError) as e:
        log.warning("native loader unavailable, using the numpy paths: %s", e)
        return None


def available() -> bool:
    return load_library() is not None


def parse_sasrec_csv_native(path: str):
    """The RaggedSequences of a sasrec_format.csv through the native parser,
    or None where it declines (an error, or every row malformed) so that the
    Python parser runs. Malformed rows are skipped and their count logged.
    Counts its successful parses on `.calls`."""
    from rails_tpu_torch.data.datasets import RaggedSequences

    lib = load_library()
    if lib is None:
        return None
    res = lib.parse_sasrec_csv(os.fsencode(path))
    try:
        r = res.contents
        if r.error:
            log.warning("native csv parse failed, using the python parser: %s (%s)",
                        r.error.decode(), path)
            return None
        nu, te = r.num_users, r.total_events
        if r.skipped_rows:
            if nu == 0:
                log.warning("native csv parse skipped ALL %d rows of %s; using the python parser",
                            r.skipped_rows, path)
                return None
            log.warning("native csv parse skipped %d malformed row(s) of %s", r.skipped_rows,
                        path)
        out = RaggedSequences(
            user_ids=np.ctypeslib.as_array(r.user_ids, (nu,)).copy(),
            offsets=np.ctypeslib.as_array(r.offsets, (nu + 1,)).copy(),
            item_ids=np.ctypeslib.as_array(r.item_ids, (te,)).copy(),
            ratings=np.ctypeslib.as_array(r.ratings, (te,)).copy(),
            timestamps=np.ctypeslib.as_array(r.timestamps, (te,)).copy(),
        )
    finally:
        lib.free_parsed_sequences(res)
    parse_sasrec_csv_native.calls += 1
    return out


parse_sasrec_csv_native.calls = 0


def assemble_batch_native(
    seqs,                       # RaggedSequences
    user_indices: np.ndarray,   # (B,) indices into seqs
    max_seq_len: int,
    ignore_last_n: int,
):
    """`SequenceDataset.rows`' tuple through the native assembler, or None
    without the library. The caller guarantees each user keeps >= 2 events
    after the trim (the valid-user filter)."""
    lib = load_library()
    if lib is None:
        return None
    b, n = len(user_indices), max_seq_len
    out = (
        np.zeros((b,), np.int32),          # lengths
        np.zeros((b, n), np.int32),        # history ids
        np.zeros((b, n), np.int32),        # history ratings
        np.zeros((b, n), np.int64),        # history timestamps
        np.zeros((b,), np.int32),          # target ids
        np.zeros((b,), np.int32),          # target ratings
        np.zeros((b,), np.int64),          # target timestamps
        np.zeros((b,), np.int32),          # user ids
    )
    store = (
        np.ascontiguousarray(seqs.user_ids, np.int32),
        np.ascontiguousarray(seqs.offsets, np.int64),
        np.ascontiguousarray(seqs.item_ids, np.int32),
        np.ascontiguousarray(seqs.ratings, np.int32),
        np.ascontiguousarray(seqs.timestamps, np.int64),
        np.ascontiguousarray(user_indices, np.int64),
    )
    lib.assemble_batch(*(a.ctypes.data for a in store), b, n, ignore_last_n,
                       *(a.ctypes.data for a in out))
    return out
