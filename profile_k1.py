"""K1 (the serving HSTU block), K4's forward off its routes and the probe P1
per stage, on one CUDA card.

Run from the root of a checkout: `python3 profile_k1.py [--skip-k1]
[--skip-var] [--var INSTANCE ...] [--skip-p1] [--dtype
bf16|f32|both] [--p1-dtype bf16|f32|both] [--hashes]`. It builds the
kernels, then prints for K1 at ML-20M widths (B=512, n in {64, 211}, f32 and
bf16) the `[K1]` line of `chip_smoke.py` (error, kernel, plain and bound ms,
and one call's device us per stage under torch.profiler); the `[K1-var]`
line of every variant instance (or those `--var` names) in f32 and bf16 at
n=211; for K4's forward at B=128 with activation none and with h=4,
dqk=dv=64, which run K1's CUDA-core kernels in both dtypes, a `[K4-fwd]`
line (kernel and plain ms, the bound at the card's peak for the operand type
with the CUDA cores' FMA rate beside it); and for P1 at B=512, n=192 each
mode's kernel and plain ms and its stages. Every instance on K1's CUDA-core
kernels (`ln_stats_kernel`, `ln_gemm_kernel`, `hstu_attn_kernel` /
`hstu_attn_chunked_kernel`) adds each stage's share of the FMA rate.
`--hashes` adds `chip_smoke.py`'s `[K1-hash]` lines that an older tree can
print too (`untouched_hashes`). The script runs in an older tree as well
(copy it and `chip_smoke.py` in), so that two trees compare in one call.
Every time is the card's, with its name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np

import chip_smoke

DTYPES = {"bf16": ("bfloat16",), "f32": ("float32",), "both": ("bfloat16", "float32")}


def cuda_core_flops(b: int, n: int, d: int, h: int, dqk: int, dv: int, out_rows: int) -> tuple:
    """The FLOPs of K1's three CUDA-core stages: the projection, the
    pointwise attention over the causal pairs, and an output GEMM of
    `out_rows` rows."""
    f = 2 * h * dv + 2 * h * dqk
    pairs = n * (n + 1) // 2
    return 2 * b * n * d * f, 2 * b * h * pairs * (dqk + dv), 2 * b * n * out_rows * d


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--skip-k1", action="store_true", help="no [K1] lines")
    parser.add_argument("--skip-var", action="store_true", help="no [K1-var] lines")
    parser.add_argument("--var", action="append", default=None,
                        help="a K1 variant instance to profile (repeatable; default all)")
    parser.add_argument("--skip-p1", action="store_true", help="no [P1] lines")
    parser.add_argument("--dtype", choices=tuple(DTYPES), default="both",
                        help="the [K1] lines' operand types")
    parser.add_argument("--p1-dtype", choices=tuple(DTYPES), default="bf16",
                        help="the [P1] lines' operand types (f32: K1's CUDA-core kernels)")
    parser.add_argument("--hashes", action="store_true", help="print the [K1-hash] lines")
    args = parser.parse_args()

    import torch

    from rails_tpu_torch.core.device import require_cuda
    from rails_tpu_torch.ops import _build

    require_cuda()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    _build.load_library()
    d, h, dqk, dv = chip_smoke.D, chip_smoke.H, chip_smoke.DQK, chip_smoke.DV
    b, n = chip_smoke.BATCH, chip_smoke.MAX_SEQ_LEN

    if not args.skip_k1:
        for dtype_name in DTYPES[args.dtype]:
            for length in (64, n):
                chip_smoke.check_k1(b, length, getattr(torch, dtype_name), device)
                torch.cuda.empty_cache()

    if not args.skip_var:
        from rails_tpu_torch.ops.hstu_block import fused_hstu_block

        for inst in args.var or chip_smoke.K1_VAR_INSTANCES:
            mode, activation, normalization, concat_ua = chip_smoke.K1_VAR_INSTANCES[inst]
            for dtype in (torch.bfloat16, torch.float32):
                chip_smoke.check_k1_variant(b, n, dtype, device, inst)
                route = chip_smoke.k1_route(dtype, d, n, h, dqk, dv, activation,
                                            normalization == "softmax_rel_bias")
                if route == "CUDA cores" and normalization != "softmax_rel_bias":
                    kargs, kw = chip_smoke.k1_variant_inputs(b, n, dtype, device, inst)
                    flops = cuda_core_flops(b, n, d, h, dqk, dv, (3 if concat_ua else 1) * h * dv)
                    print(f"[K1-var] {inst} {str(dtype)[6:]} stages (bound at the FMA rate "
                          f"{sum(flops) / chip_smoke.PEAK_FLOPS['float32'] * 1e3:.4f} ms): "
                          f"{chip_smoke.stage_split(lambda: fused_hstu_block(**kargs, **kw), flops)}")
                    del kargs
            torch.cuda.empty_cache()

    from rails_tpu_torch.ops import hstu_block_train as hbt

    tb = chip_smoke.TRAIN_BATCH
    for inst in ("activation none", "h=4, dqk=dv=64"):
        meta, _ = chip_smoke.k4_meta(inst)
        geom = (d, meta.num_heads, meta.dqk, meta.dv, n)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw), _ = chip_smoke.k1_inputs(
                tb, n, dtype, device, seed=3, geom=geom)
            x = x * colmask[..., None].to(dtype)
            fargs = (x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, 987_654_321, meta)
            call = lambda: hbt.fused_train_block_forward(*fargs)  # noqa: E731
            ms = chip_smoke.cuda_ms(call)
            plain_ms = chip_smoke.cuda_ms(
                lambda: hbt.fused_train_block_forward_reference(*fargs), iters=3, warmup=1)
            flops = cuda_core_flops(tb, n, d, meta.num_heads, meta.dqk, meta.dv,
                                    meta.o_width)
            peak = chip_smoke.PEAK_FLOPS[str(dtype)[6:]]
            fma_ms = sum(flops) / chip_smoke.PEAK_FLOPS["float32"] * 1e3
            print(f"[K4-fwd] {inst} {dt} B={tb} n={n}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {sum(flops) / peak * 1e3:.4f} ms (operations at "
                  f"{peak / 1e12:.0f} TFLOP/s; the CUDA cores' FMA rate {fma_ms:.4f}); "
                  f"stages {chip_smoke.stage_split(call, flops)}")
            del x, fargs
        torch.cuda.empty_cache()

    if not args.skip_p1:
        from rails_tpu_torch.cli import encode_probe as cli
        from rails_tpu_torch.ops import encode_probe as ep

        pn = chip_smoke.P1_LENGTH
        data = cli.probe_data(b, pn, 1, np.random.default_rng(2), device)
        kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / pn)
        proj, attn, out = cuda_core_flops(b, pn, d, h, dqk, dv, 3 * h * dv)
        for dtype_name in DTYPES[args.p1_dtype]:
            dtype = getattr(torch, dtype_name)
            pargs = (data["x0"].to(dtype), data["colmask"], data["uvqk"][0].to(dtype),
                     data["ow"][0].to(dtype), data["ob"][0], data["rel_pos"], data["ext"],
                     data["tsw"])
            dt = "f32" if dtype == torch.float32 else "bf16"
            for mode in ep.MODES:
                call = lambda: ep.encode_probe_block(mode, *pargs, **kw)  # noqa: E731
                ms = chip_smoke.cuda_ms(call)
                plain_ms = chip_smoke.cuda_ms(
                    lambda: ep.encode_probe_block_reference(mode, *pargs, **kw), iters=3,
                    warmup=1)
                flops = (() if dtype != torch.float32 else
                         {"ident": (proj,), "noattn": (proj, out)}.get(mode, (proj, attn, out)))
                fma = (f", bound {sum(flops) / chip_smoke.PEAK_FLOPS['float32'] * 1e3:.4f} ms "
                       f"(operations at the FMA rate)" if flops else "")
                print(f"[P1] {mode} B={b} n={pn} {dt}: kernel {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms{fma}; stages {chip_smoke.stage_split(call, flops)}")
            del pargs
        del data
        torch.cuda.empty_cache()

    if args.hashes:
        chip_smoke.untouched_hashes(device)
    print(f"[done] {smi}")


if __name__ == "__main__":
    main()
