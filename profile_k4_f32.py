"""K4's f32 train block on one CUDA card: its route's error over seeds, its
kernels' times, registers and occupancy, the hashes of the outputs that must
not move, and mma.sync's own rate.

Run from the root of a checkout: `python3 profile_k4_f32.py [--time-only]
[--skip-seeds] [--skip-hash] [--mma-rate] [--stage-errors] [--variant
NAME]`. It builds the kernels, then at
ml-20m-hstu-mol's train block (B = 128, n = 211, o_input dropout 0.2;
`chip_smoke.check_k4`'s inputs) prints
  - `[K4-f32-seeds]` for seeds 1-8: the forward's max over elements of
    |kernel - plain| / (atol + rtol |plain|) (its share of K4_TOL) and each
    gradient's max |kernel - plain| / max |plain| over GRAD_REL_TOL (its
    share), the kernels against autograd of the plain forward;
  - `[K4-f32-time]` the forward and the attention backward, ms per call
    between CUDA events (mean of 10), and the device ms per call of each
    kernel they launch over 5 calls under torch.profiler;
  - `[K4-f32-regs]` each kernel of the f32 route in the `-Xptxas -v` build
    log: registers, spilled bytes, its shared memory at these shapes and the
    blocks per SM those allow (computed from 65,536 registers and 227 KB);
  - `[K4-hash]` sha256 prefixes of outputs that must stay bit-identical: the
    f32 K4 instances off the route (softmax, linear_activation="none", h=4
    with dqk = dv = 64: forward and attention backward), bf16 K4 (forward and
    attention backward), K1 in f32 and bf16 (`fused_hstu_block`), and P1 in
    every mode, f32 and bf16, on operands drawn from fixed seeds;
  - `[mma]` with --mma-rate: mma.sync's issue rate, TF32 m16n8k8 and bf16
    m16n8k16, from a kernel of independent mma chains built beside the
    library (build/mma_rate/), TFLOP/s and mma per SM clock;
  - `[K4-f32-stage-err]` with --stage-errors: each stage of
    `chip_smoke.k4_tf32_stage_cases` against its plain version, max |err| /
    max |plain| per output beside K4_TF32_STAGE_TOL, without stopping at a
    stage outside it.
`--time-only` prints only the time lines (and the stage errors if asked).
`--variant NAME` copies the package, this script and chip_smoke.py to
build/k4_variant/NAME/, rewrites its sources there as VARIANTS says, and
runs this script in the copy with the other arguments (the copy builds its
own library): `two-ctas` lays the attention, dq and dkv blocks
out as 32 rows x 64 columns of 4 warps, two blocks an SM (98-112 KB of
shared memory each at n = 211); `1xtf32` drops the lo terms of every product
(hi.hi alone), the fault K4_TF32_STAGE_TOL must catch. The script takes only calls an
earlier tree also has (the f32 block, `attn_backward`, `fused_hstu_block`,
`encode_probe_block`), so the same file, copied into a `git archive` of the
parent commit, prints that tree's numbers: run both in one call (parent,
change, change, parent) and compare the lines; the parent's seeds line is
the CUDA-core kernels' share.
"""

from __future__ import annotations

import argparse
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

SEEDS = range(1, 9)
PROFILED = 5
VAR_OFF_ROUTE = ("softmax", "activation none", "h=4, dqk=dv=64")
KERNELS = ("tc_tf32_proj_kernel", "tc_tf32_attn_kernel", "tc_tf32_out_kernel",
           "tc_tf32_dq_kernel", "tc_tf32_dkv_kernel", "attn_row_bwd_kernel")
REGS_PER_SM, SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED, MAX_WARPS_PER_SM = 65_536, 232_448, 1024, 64
HEADER = Path("rails_tpu_torch") / "csrc" / "hstu_train_tf32.cuh"
MMA_HEADER = Path("rails_tpu_torch") / "csrc" / "tf32_mma.cuh"   # the 3xTF32 products
# --variant's rewrites: (file, text, replacement), each text found exactly once.
VARIANTS = {
    "two-ctas": [(HEADER, "constexpr int kTRows = 64;", "constexpr int kTRows = 32;"),
                 (HEADER, "constexpr int kColWarps = 4;", "constexpr int kColWarps = 2;"),
                 (HEADER, "constexpr int kAttnBlocksPerSm = 1;",
                  "constexpr int kAttnBlocksPerSm = 2;")],
    "1xtf32": [(MMA_HEADER, "tc::mma_tf32(c[j], a.lo, b[j].hi);", "{}"),
               (MMA_HEADER, "tc::mma_tf32(c[j], a.hi, b[j].lo);", "{}")],
}
MMA_RATE_SRC = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
// Independent mma chains: ACC accumulators a warp, 4096 rounds.
template <int ACC, bool TF32>
__global__ void rate_kernel(float* out, int iters) {
  float c[ACC][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      if (TF32) {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool TF32>
void run(const char* name, int sms, float* out) {
  const int iters = 4096, warps = 16, blocks = 2 * sms;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate_kernel<8, TF32><<<blocks, 32 * warps>>>(out, 16);
  cudaEventRecord(e0);
  rate_kernel<8, TF32><<<blocks, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const double mmas = double(blocks) * warps * iters * 8, flop = mmas * (TF32 ? 2048.0 : 4096.0);
  printf("[mma] %s: %.3f ms, %.1f TFLOP/s, %.3f mma per SM per clock at %d MHz\n", name, ms,
         flop / ms / 1e9, mmas / sms / (ms * 1e-3) / (khz * 1e3), khz / 1000);
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  cudaMalloc(&out, 1 << 24);
  run<true>("mma.sync m16n8k8 tf32", sms, out);
  run<false>("mma.sync m16n8k16 bf16", sms, out);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def digest(*tensors) -> str:
    import torch

    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def block_operands(device, dtype, instance=None, seed: int = 3, b: int = cs.TRAIN_BATCH):
    """`check_k4`'s operands: (x, colmask, uvqk, o_kernel, o_bias, rel_pos,
    ext, tsw) of the instance (None: the default block), its meta, and the
    attention backward's (y, d_o) and weight w."""
    import torch

    from rails_tpu_torch.ops.hash_dropout import hash_keep_mask
    from rails_tpu_torch.ops.hstu_block import ln

    n = cs.MAX_SEQ_LEN
    meta, has_bias = cs.k4_meta(instance)
    geom = (cs.D, meta.num_heads, meta.dqk, meta.dv, n)
    (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), _ = cs.k1_inputs(
        b, n, dtype, device, seed=seed, geom=geom)
    x = x * colmask[..., None].to(dtype)
    if meta.concat_ua:
        g = torch.Generator().manual_seed(seed)
        o_kernel = (torch.randn(meta.o_width, cs.D, generator=g) / (cs.H * cs.DV) ** 0.5).to(
            dtype).to(device)
    if not has_bias:
        rel_pos = ext = tsw = None
    w = torch.cos(torch.arange(x.numel(), device=device, dtype=torch.float32)
                  * 0.01).reshape(x.shape)
    z = ln(x.float(), meta.eps).to(dtype).float() @ uvqk.float()
    y = (z * torch.sigmoid(z) if meta.activation == "silu" else z).to(dtype)
    d_o = ((w.to(dtype).float() @ o_kernel.float().T)
           * hash_keep_mask(b, n, meta.o_width, 987_654_321, meta.rate, device)).to(dtype)
    return (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), meta, has_bias, y, d_o, w


def seeds_line(device, smi: str) -> None:
    """The f32 block's error over seeds 1-8 as shares of its tolerances."""
    import torch

    from rails_tpu_torch.ops import hstu_block_train as hbt

    rtol, atol = cs.K4_TOL
    fwd, grads = [], []
    for seed in SEEDS:
        args, meta, _, _, _, w = block_operands(device, torch.float32, seed=seed)
        x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw = args
        names = ("x", "rel_pos", "tsw", "uvqk", "o_kernel", "o_bias")
        ops = dict(x=x, rel_pos=rel_pos, tsw=tsw, uvqk=uvqk, o_kernel=o_kernel, o_bias=o_bias)
        res = []
        for fn in (hbt.fused_train_block, hbt.fused_train_block_autograd_reference):
            leaves = {k: ops[k].clone().requires_grad_(True) for k in names}
            out = fn(leaves["x"], leaves["rel_pos"], leaves["tsw"], leaves["uvqk"],
                     leaves["o_kernel"], leaves["o_bias"], colmask, ext, 987_654_321, meta)
            (out * w).sum().backward()
            res.append((out.detach(), {k: leaves[k].grad for k in names}))
        (out_k, g_k), (out_p, g_p) = res
        fwd.append(((out_k - out_p).abs() / (atol + rtol * out_p.abs())).max().item())
        grads.append(max(cs.rel_err(g_k[k], g_p[k]) for k in names) / cs.GRAD_REL_TOL)
        del res
        torch.cuda.empty_cache()
    print(f"[K4-f32-seeds] B={cs.TRAIN_BATCH} n={cs.MAX_SEQ_LEN} seeds 1-8, kernels vs autograd "
          f"of the plain forward: forward share of K4_TOL {rtol, atol} per seed "
          f"{[float(f'{v:.3e}') for v in fwd]} (max {max(fwd):.3e}); largest gradient's share of "
          f"GRAD_REL_TOL {cs.GRAD_REL_TOL} per seed {[float(f'{v:.3e}') for v in grads]} "
          f"(max {max(grads):.3e}); on {smi}")


def time_lines(device, smi: str) -> None:
    """Forward and attention backward ms, and device ms per kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rails_tpu_torch.ops import hstu_block_train as hbt

    args, meta, _, y, d_o, _ = block_operands(device, torch.float32)
    seed = 987_654_321
    _, attn = hbt.fused_train_block_forward(*args, seed, meta)
    bargs = (y, d_o, attn, args[1], *args[5:], meta, seed)
    calls = {"forward": lambda: hbt.fused_train_block_forward(*args, seed, meta),
             "attention backward": lambda: hbt.attn_backward(*bargs)}
    for what, fn in calls.items():
        ms = cs.cuda_ms(fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
        per: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::", ""))
                name = name.removeprefix("void ")[:80]
                per[name] = per.get(name, 0.0) + (e.time_range.end - e.time_range.start)
        parts = ", ".join(f"{k} {v / 1e3 / PROFILED:.4f}" for k, v in
                          sorted(per.items(), key=lambda kv: -kv[1]))
        print(f"[K4-f32-time] {what} f32 B={cs.TRAIN_BATCH} n={cs.MAX_SEQ_LEN}: {ms:.4f} ms per "
              f"call (CUDA events); device ms per call: {parts}; on {smi}")


def regs_line(lib_path) -> None:
    """Registers, spills, shared memory and blocks per SM of the route's kernels."""
    import math

    from rails_tpu_torch.ops import _build

    lib = _build.load_library()
    n, meta = cs.MAX_SEQ_LEN, cs.k4_meta(None)[0]
    smem = {"tc_tf32_attn_kernel": lib.rails_hstu_tf32_smem_bytes(0, n, meta.dqk, meta.dv),
            "tc_tf32_dq_kernel": lib.rails_hstu_tf32_smem_bytes(1, n, meta.dqk, meta.dv),
            "tc_tf32_dkv_kernel": lib.rails_hstu_tf32_smem_bytes(2, n, meta.dqk, meta.dv),
            "tc_tf32_proj_kernel": lib.rails_hstu_tf32_smem_bytes(3, n, meta.dqk, meta.dv)}
    header = (Path(__file__).resolve().parent / HEADER).read_text()
    rows, col_warps = (int(re.search(rf"constexpr int {k} = (\d+);", header).group(1))
                       for k in ("kTRows", "kColWarps"))
    attn_threads = 32 * rows // 16 * col_warps
    threads = {k: attn_threads for k in ("tc_tf32_attn_kernel", "tc_tf32_dq_kernel",
                                         "tc_tf32_dkv_kernel")}
    log = (Path(lib_path).parent / "build.log").read_text()
    section = log.split("== hstu_train_tf32.cu")[1].split("\n== ")[0]
    out = []
    for item in cs.ptxas_summary(section).split(", "):
        label, regs, spill = re.match(r"(.*) (\d+) \((\S+)\)$", item).groups()
        kernel = next((k for k in KERNELS if k in label), None)
        if kernel is None:
            continue
        sm = smem.get(kernel, 0)
        warps = threads.get(kernel, 256) // 32
        by_regs = REGS_PER_SM // (warps * math.ceil(int(regs) * 32 / 256) * 256)
        by_smem = SMEM_PER_SM // (sm + SMEM_PER_BLOCK_RESERVED) if sm else 32
        out.append(f"{kernel}{label[label.index('<'):] if '<' in label else ''} {regs} registers, "
                   f"{spill} B spilled, {sm} B shared -> "
                   f"{min(by_regs, by_smem, MAX_WARPS_PER_SM // warps)} blocks per SM")
    print(f"[K4-f32-regs] (computed) {'; '.join(out)}")


def hash_lines(device, smi: str) -> None:
    """Hashes of the outputs that must not move."""
    import numpy as np
    import torch

    from rails_tpu_torch.cli import encode_probe as p1cli
    from rails_tpu_torch.ops import encode_probe as ep
    from rails_tpu_torch.ops import hstu_block_train as hbt
    from rails_tpu_torch.ops.hstu_block import fused_hstu_block

    seed = 987_654_321
    cases = [(inst, torch.float32) for inst in VAR_OFF_ROUTE] + [(None, torch.bfloat16)]
    for inst, dtype in cases:
        args, meta, _, y, d_o, _ = block_operands(device, dtype, inst, b=32)
        out, attn = hbt.fused_train_block_forward(*args, seed, meta)
        d_y, dbias, attn_b = hbt.attn_backward(y, d_o, None if dtype == torch.bfloat16 else attn,
                                               args[1], *args[5:], meta, seed)
        print(f"[K4-hash] {inst or 'default'} {str(dtype)[6:]} B=32 n={cs.MAX_SEQ_LEN}: forward "
              f"{digest(out, attn)}, attention backward {digest(d_y, dbias, attn_b)}")
    for dtype in (torch.float32, torch.bfloat16):
        args, kw = cs.k1_inputs(64, cs.MAX_SEQ_LEN, dtype, device)
        print(f"[K4-hash] K1 fused_hstu_block {str(dtype)[6:]} B=64 n={cs.MAX_SEQ_LEN}: "
              f"{digest(fused_hstu_block(*args, **kw))}")
        d = p1cli.probe_data(16, cs.P1_LENGTH, 1, np.random.default_rng(2), device)
        pargs = (d["x0"].to(dtype), d["colmask"], d["uvqk"][0].to(dtype), d["ow"][0].to(dtype),
                 d["ob"][0], d["rel_pos"], d["ext"], d["tsw"])
        kw = dict(num_heads=cs.H, dqk=cs.DQK, dv=cs.DV, inv_n=1.0 / cs.P1_LENGTH)
        print(f"[K4-hash] P1 {str(dtype)[6:]} B=16 n={cs.P1_LENGTH}: " + ", ".join(
            f"{mode} {digest(ep.encode_probe_block(mode, *pargs, **kw))}" for mode in ep.MODES))
    print(f"[K4-hash] on {smi}")


def stage_errors(device, smi: str) -> None:
    """Each f32 stage's error against its plain version, every stage."""
    parts = []
    for name, kernel, plain, cols, *_ in cs.k4_tf32_stage_cases(device):
        shares, _, same = cs.k4_tf32_stage_shares(kernel, plain, cols)
        parts.append(f"{name} {[float(f'{v:.2e}') for v in shares]}"
                     f"{'' if max(shares) <= cs.K4_TF32_STAGE_TOL else ' OUTSIDE'}"
                     f"{'' if same else ' (two calls differ)'}")
    print(f"[K4-f32-stage-err] B={cs.TRAIN_BATCH} n={cs.MAX_SEQ_LEN} max|err|/max|plain| per "
          f"output against K4_TF32_STAGE_TOL {cs.K4_TF32_STAGE_TOL}: {'; '.join(parts)}; on {smi}")


def run_variant(name: str, args: list) -> None:
    """This script in a copy of the tree with HEADER rewritten as
    VARIANTS[name] says."""
    root = Path(__file__).resolve().parent
    tree = root / "build" / "k4_variant" / name   # its build/ kept: a later run reuses it
    shutil.rmtree(tree / "rails_tpu_torch", ignore_errors=True)
    tree.mkdir(parents=True, exist_ok=True)
    shutil.copytree(root / "rails_tpu_torch", tree / "rails_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for script in ("chip_smoke.py", "profile_k4_f32.py"):
        shutil.copy2(root / script, tree / script)
    for path, old, new in VARIANTS[name]:
        text = (tree / path).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} found {text.count(old)} times")
        (tree / path).write_text(text.replace(old, new))
    print(f"[K4-variant] {name}: {'; '.join(f'{o!r} -> {n!r}' for _, o, n in VARIANTS[name])}",
          flush=True)
    subprocess.run([sys.executable, "profile_k4_f32.py", *args], cwd=tree, check=True,
                   timeout=1800)


def mma_rate() -> None:
    """Build and run the mma.sync rate kernel."""
    from rails_tpu_torch.ops import _build

    out = Path(__file__).resolve().parent / "build" / "mma_rate"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mma_rate.cu").write_text(MMA_RATE_SRC)
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(out / "mma_rate"), str(out / "mma_rate.cu")], check=True, timeout=300)
    print(subprocess.run([str(out / "mma_rate")], capture_output=True, text=True, check=True,
                         timeout=300).stdout.strip())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--skip-seeds", action="store_true")
    ap.add_argument("--skip-hash", action="store_true")
    ap.add_argument("--mma-rate", action="store_true")
    ap.add_argument("--stage-errors", action="store_true")
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    flags = ap.parse_args()
    if flags.variant:
        run_variant(flags.variant, [a for a in sys.argv[1:]
                                    if a not in ("--variant", flags.variant)])
        return
    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build

    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    lib_path = _build.build()
    _build.load_library()
    time_lines(device, smi)
    if flags.stage_errors:
        stage_errors(device, smi)
    if flags.time_only:
        return
    if hasattr(_build.load_library(), "rails_hstu_tf32_smem_bytes"):
        regs_line(lib_path)
    if not flags.skip_seeds:
        seeds_line(device, smi)
    if not flags.skip_hash:
        hash_lines(device, smi)
    if flags.mma_rate:
        mma_rate()


if __name__ == "__main__":
    main()
