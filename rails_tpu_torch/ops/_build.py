"""Build the port's CUDA sources with nvcc and load them through ctypes.

All `csrc/*.cu` files compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). The library lands in
`build/rails_tpu_torch/<hash of the sources and flags>/` at the root of the
checkout and is built at first use; a later process with the same sources
loads it without compiling. There is no fallback: without nvcc, or when the
compiler fails, `load_library` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "rails_tpu_torch"
LIB_NAME = "librails_tpu_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    return None


def build() -> Path:
    """Compile the sources unless this hash is already built; returns the
    library path. The log of the last compile (`-Xptxas -v`: registers, shared
    memory and spills per kernel) sits beside it as `build.log`."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME): the rails_tpu_torch CUDA "
            "kernels cannot be built, and CUDA tensors have no other path"
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    # Compile to a private name and rename: concurrent builders never load a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
            capture_output=True, text=True, check=False,
        )
        (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library, declared for ctypes. Every pointer and the
    stream pass as `c_void_p`; every entry point returns a cudaError_t."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rails_hstu_block_fwd.argtypes = (
        [i] + [p] * 11 + [i] * 6 + [f, f, i, p]
    )
    lib.rails_hstu_block_fwd.restype = i
    lib.rails_hstu_attn_smem_bytes.argtypes = [i, i, i]
    lib.rails_hstu_attn_smem_bytes.restype = ctypes.c_size_t
    lib.rails_mol_scores.argtypes = [i, i, i] + [p] * 9 + [i] * 4 + [f, p]
    lib.rails_mol_scores.restype = i
    lib.rails_mol_scores_smem_bytes.argtypes = [i] * 5
    lib.rails_mol_scores_smem_bytes.restype = ctypes.c_size_t
    lib.rails_cuda_error_string.argtypes = [i]
    lib.rails_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err != 0:
        msg = lib.rails_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
