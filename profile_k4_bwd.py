"""Where the time of K4's attention backward goes, per kernel, on one CUDA card.

Run from the root of a checkout: `python3 profile_k4_bwd.py [INSTANCE ...]`,
where an instance is a key of `chip_smoke.K4_VAR_INSTANCES` or
`chip_smoke.K4_BWD_INSTANCES` (h*dqk = h*dv = 256) or "default" (the
default: "default", "no bias", "softmax"). For each instance, in f32 and
bf16, it builds the attention backward's inputs at ml-20m-hstu-mol's train
block (B = 128, n = 211, o_input dropout 0.2; `chip_smoke.check_k4`'s
inputs), then prints
  - the mean ms of one `attn_backward` call between CUDA events;
  - the device ms per call of each kernel it launches, over PROFILED calls
    under `torch.profiler`, and for the pointwise backward's two CUDA-core
    kernels (its rows and columns passes) their summed time and share of the
    FMA rate: the 5 products the function needs (`chip_smoke.k4_bwd_flops`,
    f32) at 67 TFLOP/s over that time;
  - for each kernel of the backward in the `-Xptxas -v` build log, its
    registers and spills, its shared memory at these shapes, and the blocks
    per SM those two allow (computed from the H100's 65,536 registers and
    227 KB of shared memory per SM, not measured).
"""

from __future__ import annotations

import math
import re
import subprocess
import sys

import chip_smoke

PROFILED = 5
DEFAULT_INSTANCES = ("default", "no bias", "softmax")
REGS_PER_SM, SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED, MAX_WARPS_PER_SM = 65_536, 232_448, 1024, 64
BWD_KERNELS = ("attn_row_bwd_kernel", "hstu_attn_bwd_rows_kernel", "hstu_attn_bwd_cols_kernel",
               "softmax_bwd_rows_kernel", "softmax_bwd_cols_kernel", "hstu_attn_kernel", "hstu_softmax_attn_kernel",
               "tc_bwd_rows_kernel", "tc_bwd_dq_kernel", "tc_bwd_dkv_kernel")
THREADS = 256   # a block of each CUDA-core backward kernel


def blocks_per_sm(regs: int, smem: int, threads: int) -> int:
    """Resident blocks per SM that registers, shared memory and warps allow."""
    warps = threads // 32
    by_regs = REGS_PER_SM // (warps * math.ceil(regs * 32 / 256) * 256)
    by_smem = SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED) if smem else 32
    return min(by_regs, by_smem, MAX_WARPS_PER_SM // warps)


def main() -> None:
    instances = sys.argv[1:] or DEFAULT_INSTANCES
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    log = (_build.build().parent / "build.log").read_text()
    regs = {}
    for item in chip_smoke.ptxas_summary(log).split(", "):
        label = item.rsplit(" ", 2)[0]
        if label.split("<")[0] in BWD_KERNELS:
            regs[label] = item
    print(f"[regs] {', '.join(regs.values())}")
    b, n = chip_smoke.TRAIN_BATCH, chip_smoke.MAX_SEQ_LEN
    for instance in instances:
        meta, has_bias = chip_smoke.k4_meta(None if instance == "default" else instance)
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            (x, colmask, uvqk, o_kernel, _, rel_pos, ext, tsw), _ = chip_smoke.k1_inputs(
                b, n, dtype, device, seed=3)
            if meta.concat_ua:
                g = torch.Generator().manual_seed(3)
                o_kernel = torch.randn(meta.o_width, chip_smoke.D, generator=g).to(dtype).to(device)
            if not has_bias:
                rel_pos = ext = tsw = None
            seed = 987_654_321
            n0 = ln(x.float(), meta.eps)
            z = n0.to(dtype).float() @ uvqk.float()
            y = (z * torch.sigmoid(z) if meta.activation == "silu" else z).to(dtype)
            w = torch.cos(torch.arange(x.numel(), device=device, dtype=torch.float32)
                          * 0.01).reshape(x.shape)
            d_o = ((w.to(dtype).float() @ o_kernel.float().T)
                   * hash_keep_mask(b, n, meta.o_width, seed, meta.rate, device)).to(dtype)
            attn = None
            if not bf16:
                _, attn = hbt.fused_train_block_forward(
                    x, colmask, uvqk, o_kernel, torch.zeros(chip_smoke.D, device=device),
                    rel_pos, ext, tsw, seed, meta)
            args = (y, d_o, attn, colmask, rel_pos, ext, tsw, meta, seed)
            ms = chip_smoke.cuda_ms(lambda: hbt.attn_backward(*args))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED):
                    hbt.attn_backward(*args)
                torch.cuda.synchronize()
            per_name: dict = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    short = re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::", ""))
                    short = short.removeprefix("void ")[:100]
                    per_name[short] = (per_name.get(short, 0.0)
                                       + (e.time_range.end - e.time_range.start))
            dt = "bf16" if bf16 else "f32"
            print(f"[profile] {instance} {dt} B={b} n={n} h={meta.num_heads} dqk={meta.dqk} "
                  f"({hbt.variant_name(meta, has_bias)}): attn_backward {ms:.4f} ms per call "
                  f"(CUDA events) on {smi}")
            fma_ms = (chip_smoke.k4_bwd_flops(b, n, meta, False)
                      / chip_smoke.PEAK_FLOPS["float32"] * 1e3)
            for name, us in sorted(per_name.items(), key=lambda kv: -kv[1]):
                print(f"[profile]   {us / 1e3 / PROFILED:8.4f} ms  {name}")
            pointwise_ms = sum(us for name, us in per_name.items()
                               if "hstu_attn_bwd" in name) / 1e3 / PROFILED
            if pointwise_ms and not meta.softmax:
                print(f"[profile]   {pointwise_ms:8.4f} ms  hstu_attn_bwd (both passes)  "
                      f"({fma_ms / pointwise_ms:.3f} of the FMA rate's {fma_ms:.4f} ms)")
            if meta.softmax:
                smem = lib.rails_hstu_softmax_train_bwd_smem_bytes(n, meta.num_heads, meta.dqk,
                                                                   meta.dv)
            else:
                smem = lib.rails_hstu_train_bwd_smem_bytes(n, meta.dqk, meta.dv)
            for label, item in regs.items():
                kernel = label.split("<")[0]
                if kernel not in BWD_KERNELS[1:5]:
                    continue
                if kernel.startswith("hstu_attn_bwd") == meta.softmax or not label.startswith(
                        f"{kernel}<{dt}"):
                    continue
                count = int(item.rsplit(" ", 2)[1])
                print(f"[occupancy]   {item}: at most {smem} B shared memory a block -> "
                      f"{blocks_per_sm(count, smem, THREADS)} blocks per SM "
                      f"(computed)")


if __name__ == "__main__":
    main()
