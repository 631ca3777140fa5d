"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `csrc/*.cu` file compiles to an object in its own nvcc process, all
started together; the objects link into one shared library with a plain C
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    cu = sorted(CSRC.glob("*.cu"))
    # Compile to private names and rename: concurrent processes never load a
    # half-written library.
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(tmp_dir / (src.stem + ".o"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for src in cu
        ]
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{src.name} (exit {proc.returncode}):\n{out[-4000:]}")
        (out_dir / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp_lib = tmp_dir / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *(str(tmp_dir / (src.stem + ".o")) for src in cu)],
            capture_output=True, text=True, check=False,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed (link, exit {link.returncode}):\n{link.stderr[-4000:]}")
        os.replace(tmp_lib, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library, declared for ctypes. Every pointer and the
    stream pass as `c_void_p`; every entry point returns a cudaError_t."""
    lib = ctypes.CDLL(str(build()))
    p, i, f, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    lib.rails_hstu_block_fwd.argtypes = [i] + [p] * 12 + [i] * 6 + [f] * 3 + [i] * 5 + [p]
    lib.rails_hstu_block_fwd.restype = i
    lib.rails_hstu_tc_project.argtypes = [p] * 4 + [i] * 5 + [f, f, i, p]
    lib.rails_hstu_tc_project.restype = i
    lib.rails_hstu_tc_attention.argtypes = [p] * 8 + [i] * 5 + [f, f] + [i] * 4 + [p]
    lib.rails_hstu_tc_attention.restype = i
    lib.rails_hstu_tc_out.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.rails_hstu_tc_out.restype = i
    lib.rails_hstu_tc_attn_smem_bytes.argtypes = [i] * 5
    lib.rails_hstu_tc_attn_smem_bytes.restype = ctypes.c_size_t
    lib.rails_encode_probe_tc.argtypes = [i] + [p] * 12 + [i] * 6 + [f, f, i, p]
    lib.rails_encode_probe_tc.restype = i
    lib.rails_hstu_attn_smem_bytes.argtypes = [i, i, i]
    lib.rails_hstu_attn_smem_bytes.restype = ctypes.c_size_t
    lib.rails_encode_probe.argtypes = [i, i] + [p] * 11 + [i] * 6 + [f, f, i, p]
    lib.rails_encode_probe.restype = i
    lib.rails_mol_probe.argtypes = [i, i] + [p] * 9 + [i] * 4 + [f, p]
    lib.rails_mol_probe.restype = i
    lib.rails_mol_probe_smem_bytes.argtypes = [i] * 3
    lib.rails_mol_probe_smem_bytes.restype = ctypes.c_size_t
    lib.rails_hstu_softmax_smem_bytes.argtypes = [i] * 4
    lib.rails_hstu_softmax_smem_bytes.restype = ctypes.c_size_t
    lib.rails_mol_scores.argtypes = [i] * 4 + [p] * 13 + [i] * 4 + [f, p]
    lib.rails_mol_scores.restype = i
    lib.rails_mol_scores_smem_bytes.argtypes = [i] * 6
    lib.rails_mol_scores_smem_bytes.restype = ctypes.c_size_t
    lib.rails_mol_scores_tiles.argtypes = [i] * 4 + [p] * 12 + [i] * 5 + [f, p]
    lib.rails_mol_scores_tiles.restype = i
    for bound_fn in (lib.rails_mol_ub, lib.rails_mol_group_block_max):
        bound_fn.argtypes = [i] * 4 + [p] * 4 + [i] * 3 + [f, p]
        bound_fn.restype = i
    lib.rails_mol_bounds_smem_bytes.argtypes = [i] * 4
    lib.rails_mol_bounds_smem_bytes.restype = ctypes.c_size_t
    drop1 = [i, i, u32, f]   # use, seed, threshold, scale
    lib.rails_hstu_train_fwd.argtypes = ([i] + [p] * 11 + [i] * 6 + [f] * 3 + [i] * 5 + drop1
                                         + [i, u32, f, p])
    lib.rails_hstu_train_fwd.restype = i
    lib.rails_hstu_train_bwd.argtypes = [i] + [p] * 10 + [i] * 5 + [f, f] + [i] * 4 + drop1 + [p]
    lib.rails_hstu_train_bwd.restype = i
    lib.rails_hstu_softmax_train_bwd.argtypes = ([i] + [p] * 11 + [i] * 5 + [f, f] + [i] * 3
                                                 + drop1 + [p])
    lib.rails_hstu_softmax_train_bwd.restype = i
    lib.rails_hstu_softmax_train_bwd_smem_bytes.argtypes = [i] * 4
    lib.rails_hstu_softmax_train_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.rails_hstu_tc_train_attention.argtypes = ([p] * 8 + [i] * 5 + [f, f] + [i] * 5 + [i, u32, f]
                                                  + [i, u32, f, p])
    lib.rails_hstu_tc_train_attention.restype = i
    lib.rails_hstu_tc_train_bwd.argtypes = [i] + [p] * 11 + [i] * 5 + [f, f] + [i] * 5 + [u32, f, p]
    lib.rails_hstu_tc_train_bwd.restype = i
    lib.rails_hstu_tc_train_bwd_smem_bytes.argtypes = [i] * 5
    lib.rails_hstu_tc_train_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.rails_hstu_tf32_project.argtypes = [p] * 3 + [i] * 6 + [f, p]
    lib.rails_hstu_tf32_project.restype = i
    lib.rails_hstu_tf32_attention.argtypes = [p] * 6 + [i] * 5 + [f] + [i] * 4 + [u32, f, p]
    lib.rails_hstu_tf32_attention.restype = i
    lib.rails_hstu_tf32_out.argtypes = [p] * 6 + [i] * 6 + [f] + [i] * 3 + [u32, f, p]
    lib.rails_hstu_tf32_out.restype = i
    lib.rails_hstu_tf32_bwd.argtypes = [i] + [p] * 11 + [i] * 5 + [f, f] + [i] * 5 + [u32, f, p]
    lib.rails_hstu_tf32_bwd.restype = i
    lib.rails_hstu_tf32_smem_bytes.argtypes = [i] * 4
    lib.rails_hstu_tf32_smem_bytes.restype = ctypes.c_size_t
    lib.rails_hstu_serve_tf32_project.argtypes = [p] * 3 + [i] * 6 + [f, p]
    lib.rails_hstu_serve_tf32_project.restype = i
    lib.rails_hstu_serve_tf32_attention.argtypes = [p] * 7 + [i] * 5 + [f, f] + [i] * 3 + [p]
    lib.rails_hstu_serve_tf32_attention.restype = i
    lib.rails_hstu_serve_tf32_out.argtypes = [p] * 6 + [i] * 6 + [f, i, p]
    lib.rails_hstu_serve_tf32_out.restype = i
    lib.rails_hstu_serve_tf32_smem_bytes.argtypes = [i] * 5
    lib.rails_hstu_serve_tf32_smem_bytes.restype = ctypes.c_size_t
    lib.rails_hstu_train_bwd_smem_bytes.argtypes = [i, i, i]
    lib.rails_hstu_train_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.rails_hash_keep_mask.argtypes = [p, i, i, i, i, u32, f, p]
    lib.rails_hash_keep_mask.restype = i
    lib.rails_adamw_update_leaves.argtypes = [i, p] + [f] * 9 + [p]
    lib.rails_adamw_update_leaves.restype = i
    drop = [i, u32, u32, f, i, u32, u32, f]   # use, seed, threshold, scale: qi, then pi
    lib.rails_mol_loss_fwd.argtypes = [i, i, i] + [p] * 9 + [i] * 6 + [f, f] + drop + [p]
    lib.rails_mol_loss_fwd.restype = i
    lib.rails_mol_loss_bwd.argtypes = [i, i, i] + [p] * 15 + [i] * 7 + [f, f] + drop + [p]
    lib.rails_mol_loss_bwd.restype = i
    lib.rails_mol_loss_smem_bytes.argtypes = [i] * 5
    lib.rails_mol_loss_smem_bytes.restype = ctypes.c_size_t
    lib.rails_mol_loss_tc_fwd.argtypes = [i, i] + [p] * 9 + [i] * 6 + [f, f] + drop + [p]
    lib.rails_mol_loss_tc_fwd.restype = i
    lib.rails_mol_loss_tc_bwd.argtypes = [i, i] + [p] * 13 + [i] * 7 + [f, f] + drop + [p]
    lib.rails_mol_loss_tc_bwd.restype = i
    lib.rails_mol_loss_tc_smem_bytes.argtypes = [i] * 5
    lib.rails_mol_loss_tc_smem_bytes.restype = ctypes.c_size_t
    ll = ctypes.c_longlong
    lib.rails_scatter_add_rows.argtypes = ([i] * 3 + [p] * 3 + [ll] + [i] * 4 + [ll] * 3
                                           + [p, ll] + [p] * 12 + [p])
    lib.rails_scatter_add_rows.restype = i
    lib.rails_cuda_error_string.argtypes = [i]
    lib.rails_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err != 0:
        msg = lib.rails_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
