"""Where the time of K4's CUDA-core attention backward goes inside its two
kernels, phase by phase, on one CUDA card.

Run from the root of a checkout: `python3 profile_k4_bwd_phases.py
[INSTANCE ...]`, where an instance is a key of `chip_smoke.K4_VAR_INSTANCES`
or `chip_smoke.K4_BWD_INSTANCES` (default: "activation none" and "h=4,
dqk=dv=64"). It copies `rails_tpu_torch/csrc/hstu_block_train.cu` into
`build/k4_bwd_phases/` with a mark at the end of each phase of
`hstu_attn_bwd_rows_kernel` and `hstu_attn_bwd_cols_kernel` (lane 0 of every
warp adds the clock64() cycles since its last mark to the phase's count),
builds the copy alone with nvcc, and runs `attn_backward` through it once at
ml-20m-hstu-mol's train block (B = 128, n = 211, f32; `chip_smoke.check_k4`'s
inputs). It prints, per instance, the mean ms of one `attn_backward` call on
the uninstrumented library between CUDA events, and each pass's cycles per
phase as a share of that pass's cycles summed over its warps. A phase that
ends in a barrier counts the wait for the slowest warp. A mark whose anchor
the kernel source no longer has stops the script: move the anchor with the
code.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke

DEFAULT_INSTANCES = ("activation none", "h=4, dqk=dv=64")
PHASES = ("bias", "barrier before staging", "convert + barrier", "issue copies", "products",
          "epilogue", "partial sums' loads", "second product", "dbias", "tail")
# (anchor, mark, where, count): the mark `PHASE(k);` goes before or after each
# of the `count` places the anchor text has in the kernel source.
MARKS = (
    ("#pragma unroll\n    for (int r = 0; r < 4; ++r) {\n#pragma unroll\n"
     "      for (int cc = 0; cc < 4; ++cc) dbacc[r][cc] = 0.f;", 0, "before", 1),
    ("pair_bias<false>(p, sm, b, i0, j0, pr, pc0, bias);\n", 0, "after", 1),
    ("    __syncthreads();\n    bwd_cp_wait();\n", None, "split", 1),
    ("__syncthreads();   // a thread's next copies may land on quads another one converted\n",
     2, "after", 1),
    ("    if (c <= last_chunk) issue(c, hd, k);\n", 3, "after", 1),
    ("tile_dot(da, sm.as, av, sm.vs + pc0 * sm.ldv, sm.ldv, min(kDC, p.dv - d0));\n    }\n",
     4, "after", 1),
    ("      // d_q_i += sum over the chunk", 5, "before", 1),
    ("      const int off = g_v ?", 5, "before", 1),
    ("        if (q == 0) {\n", 6, "before", 2),
    ("          __syncthreads();   // d_s is in the tile\n", 1, "after", 1),
    ("          __syncthreads();   // d_s and a are in the tiles\n", 1, "after", 1),
    ("p.d_y[(row0 + i) * F + qoff + e0 + qe0 + e] = acc[r][e];\n          }\n        }\n",
     7, "after", 1),
    ("dyj[e] = g_v && last ? acc[cc][e] * p.inv_n : acc[cc][e];\n          }\n        }\n",
     7, "after", 1),
    ("  // The columns past the diagonal chunk.\n", 8, "before", 1),
)
HEADER = """
namespace rails {
__device__ unsigned long long g_phase[2][%(k)d];
}
__shared__ unsigned long long phase_s[8][%(k)d];
__shared__ unsigned long long phase_last[8];
#define PHASE_START do { if ((threadIdx.x & 31) == 0) { for (int k_ = 0; k_ < %(k)d; ++k_) \\
    phase_s[threadIdx.x >> 5][k_] = 0; phase_last[threadIdx.x >> 5] = clock64(); } } while (0)
#define PHASE(k) do { if ((threadIdx.x & 31) == 0) { const unsigned long long t_ = clock64(); \\
    phase_s[threadIdx.x >> 5][k] += t_ - phase_last[threadIdx.x >> 5]; \\
    phase_last[threadIdx.x >> 5] = t_; } } while (0)
#define PHASE_END(pass) do { if ((threadIdx.x & 31) == 0) for (int k_ = 0; k_ < %(k)d; ++k_) \\
    atomicAdd(&rails::g_phase[pass][k_], phase_s[threadIdx.x >> 5][k_]); } while (0)
""" % {"k": len(PHASES)}
FOOTER = """
extern "C" int rails_bwd_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, rails::g_phase, sizeof(rails::g_phase));
  unsigned long long z[2 * %(k)d] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(rails::g_phase, z, sizeof(z));
  return e;
}
""" % {"k": len(PHASES)}


def instrumented_source(src: str) -> str:
    """The kernel source with the phase marks, the counters and their reader."""
    for anchor, mark, where, count in MARKS:
        if src.count(anchor) != count:
            raise SystemExit(f"anchor found {src.count(anchor)} times, expected {count}: "
                             f"{anchor!r}")
        if where == "split":   # the barrier before the staging, then the rest
            src = src.replace(anchor, anchor.replace("bwd_cp_wait", "PHASE(1);\n    bwd_cp_wait"))
        elif where == "before":
            src = src.replace(anchor, f"PHASE({mark});\n" + anchor)
        else:
            src = src.replace(anchor, anchor + f"PHASE({mark});\n")
    top = "namespace rails {\nnamespace {\n"
    assert src.count(top) == 1
    src = src.replace(top, HEADER + top)
    for kernel, pass_ in (("bwd_rows<T, ADROP>(p, bwd_smem(p, smem4)", 0),
                          ("bwd_cols<T, ADROP>(p, bwd_smem(p, smem4)", 1)):
        start = src.index("  " + kernel)
        end = src.index("\n", start) + 1
        src = (src[:start] + "  PHASE_START;\n" + src[start:end]
               + f"  PHASE(9);\n  PHASE_END({pass_});\n" + src[end:])
    return src + FOOTER


def main() -> None:
    instances = sys.argv[1:] or DEFAULT_INSTANCES
    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build
    from rails_tpu_torch.ops import hstu_block_train as hbt
    from rails_tpu_torch.ops.hash_dropout import hash_keep_mask
    from rails_tpu_torch.ops.hstu_block import ln

    require_cuda()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    lib = _build.load_library()
    out_dir = Path(__file__).resolve().parent / "build" / "k4_bwd_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "hstu_block_train_phases.cu"
    cu.write_text(instrumented_source((_build.CSRC / "hstu_block_train.cu").read_text()))
    so = out_dir / "libphases.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{_build.CSRC}",
                    str(cu), "-o", str(so)], check=True, capture_output=True, timeout=900)
    phased = ctypes.CDLL(str(so))
    for name in ("rails_hstu_train_bwd", "rails_hstu_train_bwd_smem_bytes"):
        getattr(phased, name).argtypes = getattr(lib, name).argtypes
        getattr(phased, name).restype = getattr(lib, name).restype
    phased.rails_bwd_phases.argtypes = [ctypes.c_void_p]
    counts = (ctypes.c_ulonglong * (2 * len(PHASES)))()
    b, n = chip_smoke.TRAIN_BATCH, chip_smoke.MAX_SEQ_LEN
    for instance in instances:
        meta, has_bias = chip_smoke.k4_meta(instance)
        (x, colmask, uvqk, o_kernel, _, rel_pos, ext, tsw), _ = chip_smoke.k1_inputs(
            b, n, torch.float32, device, seed=3)
        if not has_bias:
            rel_pos = ext = tsw = None
        seed = 987_654_321
        y = ln(x, meta.eps) @ uvqk
        if meta.activation == "silu":
            y = y * torch.sigmoid(y)
        w = torch.cos(torch.arange(x.numel(), device=device, dtype=torch.float32)
                      * 0.01).reshape(x.shape)
        d_o = (w @ o_kernel.T) * hash_keep_mask(b, n, meta.o_width, seed, meta.rate, device)
        _, attn = hbt.fused_train_block_forward(
            x, colmask, uvqk, o_kernel, torch.zeros(chip_smoke.D, device=device), rel_pos, ext,
            tsw, seed, meta)
        args = (y, d_o, attn, colmask, rel_pos, ext, tsw, meta, seed)
        ms = chip_smoke.cuda_ms(lambda: hbt.attn_backward(*args))
        load = _build.load_library
        _build.load_library = lambda: phased
        try:
            errs = [phased.rails_bwd_phases(counts)]   # zero the counts
            hbt.attn_backward(*args)
            torch.cuda.synchronize()
            errs.append(phased.rails_bwd_phases(counts))
        finally:
            _build.load_library = load
        if any(errs):
            raise RuntimeError(f"rails_bwd_phases: CUDA errors {errs}")
        print(f"[phases] {instance} f32 B={b} n={n} h={meta.num_heads} dqk={meta.dqk}: "
              f"attn_backward {ms:.4f} ms per call (CUDA events, uninstrumented) on {smi}")
        for pass_, kernel in enumerate(("hstu_attn_bwd_rows_kernel", "hstu_attn_bwd_cols_kernel")):
            v = list(counts[pass_ * len(PHASES):(pass_ + 1) * len(PHASES)])
            total = sum(v) or 1
            shares = ", ".join(f"{PHASES[k]} {v[k] / total:.3f}" for k in range(len(PHASES))
                               if v[k])
            print(f"[phases]   {kernel}: {shares} ({total / 1e6:.1f} M warp-cycles)")


if __name__ == "__main__":
    main()
